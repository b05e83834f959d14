"""Experience Replay, with the ASER strategies behind its flags (counterpart
of ocl_tpu/agents/er.py; reference agents/exp_replay.py).

The step is the reference's two-pass schedule (ocl_tpu/agents/er.py:96-137):
forward/backward on the incoming batch, retrieve, forward/backward on the
memory rows, one SGD step on the summed gradients, then the buffer update
with the new weights. In ASER mode the SGD step takes the gradient of one
combined [memory; batch] pass instead, and the batch and memory passes only
fold their BN statistics, so they run without gradients. The fused schedule
(ocl_tpu/agents/er.py:55-94) is not ported yet.
"""

from __future__ import annotations

import torch

from ocl_tpu_torch.agents.base import ContinualLearner
from ocl_tpu_torch.buffer import build_retrieve, build_update
from ocl_tpu_torch.models import forward_train


class ExperienceReplay(ContinualLearner):
    def __init__(self, params):
        super().__init__(params)
        self.aser_mode = params.update == "ASER" or params.retrieve == "ASER"
        fused = bool(getattr(params, "fused_replay", False)) and \
            not self.aser_mode and params.retrieve in ("random", "match")
        if fused:
            raise NotImplementedError(
                "the fused ER schedule (--fused_replay True, the ocl_tpu default "
                "with random retrieval) is not ported yet; pass --fused_replay "
                "False for the reference's two-pass schedule")
        self.retrieve = build_retrieve(self)
        self.update = build_update(self)

    def draw(self, generator, batch):
        """The random draws of one step: one retrieval per --mem_iters, one update."""
        return {"retrieve": [self.retrieve.draw(generator, batch)
                             for _ in range(int(self.params.mem_iters))],
                "update": self.update.draw(generator, batch)}

    def step(self, state, ctx, xb, yb, draws=None):
        model, opt, buf = state.model, state.optimizer, state.buffer
        if draws is None:
            draws = self.draw(state.generator, xb.shape[0])
        for ret_draws in draws["retrieve"]:
            opt.zero_grad()
            with torch.set_grad_enabled(not self.aser_mode):
                logits_b = forward_train(model, xb)
                loss_b = self.criterion(logits_b, yb, ctx)
            if not self.aser_mode:
                loss_b.backward()
            acc_b = (logits_b.argmax(1) == yb).float().mean()

            mem_x, mem_y, mem_mask = self.retrieve.run(model, buf, xb, yb, ret_draws)
            # every ported retrieval returns a valid row iff the buffer holds
            # one, so this host test is ocl_tpu's jnp.any(mem_mask)
            if buf.current_index > 0:
                if self.aser_mode:
                    with torch.no_grad():
                        forward_train(model, mem_x, mem_mask)  # folds BN stats only
                else:
                    self.criterion(forward_train(model, mem_x, mem_mask),
                                   mem_y, ctx, mem_mask).backward()

            if self.aser_mode:
                comb_x = torch.cat([mem_x, xb])
                comb_y = torch.cat([mem_y, yb])
                comb_mask = torch.cat([mem_mask, torch.ones_like(yb, dtype=torch.bool)])
                loss = self.criterion(forward_train(model, comb_x, comb_mask),
                                      comb_y, ctx, comb_mask)
                loss.backward()
            opt.step()

        self.update.run(model, buf, xb, yb, draws["update"])
        return loss_b.detach(), acc_b
