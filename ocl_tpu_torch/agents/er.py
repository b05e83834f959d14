"""Experience Replay, with the MIR, match, GSS and ASER strategies behind its
flags (counterpart of ocl_tpu/agents/er.py; reference agents/exp_replay.py).

Two schedules, as in ocl_tpu:

* fused (--fused_replay, the default, with random or match retrieval and no
  ASER; ocl_tpu/agents/er.py:55-94): retrieve first, then one train-mode
  forward over [batch; memory] whose BN statistics fold once over the valid
  rows of both, one backward of loss_b + loss_m, one optimizer step;
* two-pass (the reference's; er.py:96-137): forward/backward on the incoming
  batch, retrieve (MIR reads the batch gradients here), forward/backward on
  the memory rows, one step on the summed gradients. In ASER mode the step
  takes the gradient of one combined [memory; batch] pass instead, and the
  batch and memory passes only fold their BN statistics, so they run
  without gradients.

Either way the buffer update follows with the new weights. kd_trick and
kd_trick_star blend the batch loss (and, two-pass, the memory loss) with
distillation from the previous task's model.
"""

from __future__ import annotations

import torch

from ocl_tpu_torch.agents.base import ContinualLearner
from ocl_tpu_torch.buffer import build_retrieve, build_update
from ocl_tpu_torch.models import forward_train


def batch_grads(model):
    """Parameter name -> its .grad (the batch gradients MIR reads)."""
    return {n: p.grad for n, p in model.named_parameters()}


class ExperienceReplay(ContinualLearner):
    def __init__(self, params):
        super().__init__(params)
        self.aser_mode = params.update == "ASER" or params.retrieve == "ASER"
        self.fused = bool(getattr(params, "fused_replay", False)) and \
            not self.aser_mode and params.retrieve in ("random", "match")
        self.retrieve = build_retrieve(self)
        self.update = build_update(self)

    def draw(self, generator, batch):
        """The random draws of one step: one retrieval per --mem_iters, then
        one update, the order in which both schedules consume them."""
        return {"retrieve": [self.retrieve.draw(generator, batch)
                             for _ in range(int(self.params.mem_iters))],
                "update": self.update.draw(generator, batch)}

    def step(self, state, ctx, xb, yb, draws=None):
        if draws is None:
            draws = self.draw(state.generator, xb.shape[0])
        run = self.fused_iter if self.fused else self.two_pass_iter
        for ret_draws in draws["retrieve"]:
            loss_b, acc_b = run(state, ctx, xb, yb, ret_draws)
        self.update.run(state.model, state.buffer, xb, yb, draws["update"])
        return loss_b.detach(), acc_b

    def fused_iter(self, state, ctx, xb, yb, ret_draws):
        model, opt = state.model, state.optimizer
        batch = xb.shape[0]
        with torch.no_grad():
            mem_x, mem_y, mem_mask = self.retrieve.run(model, state.buffer, xb, yb, ret_draws)
        opt.zero_grad()
        comb_mask = torch.cat([torch.ones_like(yb, dtype=torch.bool), mem_mask])
        logits = forward_train(model, torch.cat([xb, mem_x]), comb_mask)
        loss_b = self.criterion(logits[:batch], yb, ctx)
        loss_b = self.maybe_kd_blend(loss_b, logits[:batch], xb, ctx, state.agent)
        # the masked mean is 0 when no memory row is valid (ocl_tpu's
        # jnp.where(jnp.any(mem_mask), loss_m, 0.0))
        loss_m = self.criterion(logits[batch:], mem_y, ctx, mem_mask)
        (loss_b + loss_m).backward()
        opt.step()
        return loss_b, (logits[:batch].argmax(1) == yb).float().mean()

    def two_pass_iter(self, state, ctx, xb, yb, ret_draws):
        model, opt, buf = state.model, state.optimizer, state.buffer
        opt.zero_grad()
        with torch.set_grad_enabled(not self.aser_mode):
            logits_b = forward_train(model, xb)
            loss_b = self.criterion(logits_b, yb, ctx)
            loss_b = self.maybe_kd_blend(loss_b, logits_b, xb, ctx, state.agent)
        if not self.aser_mode:
            loss_b.backward()
        acc_b = (logits_b.argmax(1) == yb).float().mean()

        mem_x, mem_y, mem_mask = self.retrieve.run(
            model, buf, xb, yb, ret_draws, grads=None if self.aser_mode else batch_grads(model))
        # ocl_tpu runs the memory pass when jnp.any(mem_mask). An empty buffer
        # has no valid row, which this host test sees; a retrieval that
        # returns no valid row from a filled buffer (match before its warmup
        # or with a short class) makes a pass that folds no BN statistics and
        # adds zero gradients (models/layers.py), so it changes nothing either
        if buf.current_index > 0:
            with torch.set_grad_enabled(not self.aser_mode):
                logits_m = forward_train(model, mem_x, mem_mask)
                if not self.aser_mode:
                    loss_m = self.criterion(logits_m, mem_y, ctx, mem_mask)
                    loss_m = self.maybe_kd_blend(loss_m, logits_m, mem_x, ctx, state.agent,
                                                 mem_mask)
                    loss_m.backward()

        if self.aser_mode:
            comb_mask = torch.cat([mem_mask, torch.ones_like(yb, dtype=torch.bool)])
            comb_x, comb_y = torch.cat([mem_x, xb]), torch.cat([mem_y, yb])
            logits = forward_train(model, comb_x, comb_mask)
            loss = self.criterion(logits, comb_y, ctx, comb_mask)
            self.maybe_kd_blend(loss, logits, comb_x, ctx, state.agent, comb_mask).backward()
        opt.step()
        return loss_b, acc_b
