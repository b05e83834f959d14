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
  without gradients; with MIR retrieval the batch pass still takes its
  gradients for MIR's virtual step (ocl_tpu/agents/er.py:97-107), which are
  dropped before the combined pass.

Either way the buffer update follows with the new weights. kd_trick and
kd_trick_star blend the batch loss (and, two-pass, the memory loss) with
distillation from the previous task's model.

The losses of a point (`fused_loss`, `batch_loss`, `memory_loss`,
`combined_loss`) serve both the sequential step and `stacked_step`, which
runs them, the retrieval and the update for every point under vmap
(agents/base.py::point_map), every strategy included: MIR's virtual step
reads each point's batch gradients, and GSS gates its replacements on the
device (buffer/gss.py).

In a data-parallel step (parallel/dp.py) each rank takes its rows of the
batch and of the retrieved memory; the losses are its shares of the global
batch's, and the gradients are summed over the ranks before the step. MIR
reads the batch gradients summed over the ranks (`global_batch_grads`).
"""

from __future__ import annotations

import torch

from ocl_tpu_torch.agents.base import ContinualLearner, point_map
from ocl_tpu_torch.buffer import build_retrieve, build_update
from ocl_tpu_torch.models import forward_train
from ocl_tpu_torch.parallel import dp


def batch_grads(model):
    """Parameter name -> its .grad (the batch gradients MIR reads)."""
    return {n: p.grad for n, p in model.named_parameters()}


def global_batch_grads(model):
    """batch_grads summed over the ranks of a data-parallel step; the .grad
    stay this rank's, for the one reduction before the optimizer step
    (batch_grads outside one)."""
    names, grads = zip(*batch_grads(model).items())
    return dict(zip(names, dp.rank_sum_all(list(grads))))


def stacked_grads(ss):
    """batch_grads of every point: name -> the stacked leaf's .grad."""
    return {n: p.grad for n, p in ss.model.params.items()}


class ExperienceReplay(ContinualLearner):
    def __init__(self, params):
        super().__init__(params)
        self.aser_mode = params.update == "ASER" or params.retrieve == "ASER"
        # MIR's virtual step reads the batch gradients, so the two-pass batch
        # pass takes them in ASER mode too
        self.mir = params.retrieve == "MIR"
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

    def fused_loss(self, state, ctx, xb, yb, mem):
        """The fused schedule's losses of one point: one train-mode forward
        over [batch; memory]; returns (loss_b + loss_m, loss_b, batch
        accuracy)."""
        mem_x, mem_y, mem_mask = mem
        batch = xb.shape[0]
        comb_mask = torch.cat([torch.ones_like(yb, dtype=torch.bool), mem_mask])
        logits = forward_train(state.model, torch.cat([xb, mem_x]), comb_mask)
        loss_b = self.criterion(logits[:batch], yb, ctx)
        loss_b = self.maybe_kd_blend(loss_b, logits[:batch], xb, ctx, state.agent)
        # the masked mean is 0 when no memory row is valid (ocl_tpu's
        # jnp.where(jnp.any(mem_mask), loss_m, 0.0))
        loss_m = self.criterion(logits[batch:], mem_y, ctx, mem_mask)
        loss_b, loss_m = dp.share(loss_b), dp.share(loss_m, mem_mask)
        return loss_b + loss_m, loss_b, (logits[:batch].argmax(1) == yb).float().mean()

    def batch_loss(self, state, ctx, xb, yb):
        """Two-pass: the incoming batch's loss and accuracy."""
        logits_b = forward_train(state.model, xb)
        loss_b = self.criterion(logits_b, yb, ctx)
        loss_b = self.maybe_kd_blend(loss_b, logits_b, xb, ctx, state.agent)
        return dp.share(loss_b), (logits_b.argmax(1) == yb).float().mean()

    def memory_loss(self, state, ctx, mem_x, mem_y, mem_mask):
        """Two-pass: the memory rows' loss (in ASER mode the pass only folds
        their BN statistics, and the loss is 0)."""
        logits_m = forward_train(state.model, mem_x, mem_mask)
        if self.aser_mode:
            return logits_m.new_zeros(())
        loss_m = self.criterion(logits_m, mem_y, ctx, mem_mask)
        loss_m = self.maybe_kd_blend(loss_m, logits_m, mem_x, ctx, state.agent, mem_mask)
        return dp.share(loss_m, mem_mask)

    def combined_loss(self, state, ctx, xb, yb, mem_x, mem_y, mem_mask):
        """ASER mode: the loss of one combined [memory; batch] pass."""
        comb_mask = torch.cat([mem_mask, torch.ones_like(yb, dtype=torch.bool)])
        comb_x, comb_y = torch.cat([mem_x, xb]), torch.cat([mem_y, yb])
        logits = forward_train(state.model, comb_x, comb_mask)
        loss = self.criterion(logits, comb_y, ctx, comb_mask)
        loss = self.maybe_kd_blend(loss, logits, comb_x, ctx, state.agent, comb_mask)
        return dp.share(loss, comb_mask)

    def fused_iter(self, state, ctx, xb, yb, ret_draws):
        with torch.no_grad():
            mem = self.retrieve.run(state.model, state.buffer, xb, yb, ret_draws)
        state.optimizer.zero_grad()
        loss, loss_b, acc_b = self.fused_loss(state, ctx, *dp.local_rows(xb, yb),
                                              dp.local_rows(*mem))
        loss.backward()
        dp.reduce_grads(state.model)
        state.optimizer.step()
        return loss_b, acc_b

    def two_pass_iter(self, state, ctx, xb, yb, ret_draws):
        model, opt, buf = state.model, state.optimizer, state.buffer
        xb_r, yb_r = dp.local_rows(xb, yb)
        opt.zero_grad()
        batch_grad = not self.aser_mode or self.mir
        with torch.set_grad_enabled(batch_grad):
            loss_b, acc_b = self.batch_loss(state, ctx, xb_r, yb_r)
        if batch_grad:
            loss_b.backward()

        mem_x, mem_y, mem_mask = dp.local_rows(*self.retrieve.run(
            model, buf, xb, yb, ret_draws, grads=global_batch_grads(model) if self.mir else None))
        if self.aser_mode:
            opt.zero_grad()   # only the combined pass feeds the step
        # ocl_tpu runs the memory pass when jnp.any(mem_mask). An empty buffer
        # has no valid row, which this host test sees; a retrieval that
        # returns no valid row from a filled buffer (match before its warmup
        # or with a short class) makes a pass that folds no BN statistics and
        # adds zero gradients (models/layers.py), so it changes nothing either
        if buf.current_index > 0:
            with torch.set_grad_enabled(not self.aser_mode):
                loss_m = self.memory_loss(state, ctx, mem_x, mem_y, mem_mask)
            if not self.aser_mode:
                loss_m.backward()

        if self.aser_mode:
            self.combined_loss(state, ctx, xb_r, yb_r, mem_x, mem_y, mem_mask).backward()
        dp.reduce_grads(model)
        opt.step()
        return loss_b, acc_b

    # ------------------------------------------------------------- stacked

    def stacked_retrieve(self, ss, ctx, xb, yb, ret_draws, grads=None):
        """Every point's retrieval; `grads` the stacked batch gradients by
        parameter name (MIR's virtual step reads them)."""
        with torch.no_grad():
            return point_map(ss, lambda v, c, x, y, d, g: self.retrieve.run(
                v.model, v.buffer, x, y, d, grads=g or None), ctx, xb, yb, ret_draws, grads or {})

    def stacked_update(self, ss, ctx, xb, yb, upd_draws):
        with torch.no_grad():
            point_map(ss, lambda v, c, x, y, d: self.update.run(v.model, v.buffer, x, y, d),
                      ctx, xb, yb, upd_draws)

    def stacked_step(self, ss, ctx, xb, yb, draws=None):
        if draws is None:
            draws = ss.draw(lambda g: self.draw(g, xb.shape[1]))
        run = self.stacked_fused_iter if self.fused else self.stacked_two_pass_iter
        for ret_draws in draws["retrieve"]:
            loss_b, acc_b = run(ss, ctx, xb, yb, ret_draws)
        self.stacked_update(ss, ctx, xb, yb, draws["update"])
        return loss_b.detach(), acc_b

    def stacked_fused_iter(self, ss, ctx, xb, yb, ret_draws):
        mem = self.stacked_retrieve(ss, ctx, xb, yb, ret_draws)
        ss.optimizer.zero_grad()
        loss, loss_b, acc_b = point_map(ss, self.fused_loss, ctx, xb, yb, mem)
        loss.sum().backward()
        ss.optimizer.step()
        return loss_b, acc_b

    def stacked_two_pass_iter(self, ss, ctx, xb, yb, ret_draws):
        ss.optimizer.zero_grad()
        batch_grad = not self.aser_mode or self.mir
        with torch.set_grad_enabled(batch_grad):
            loss_b, acc_b = point_map(ss, self.batch_loss, ctx, xb, yb)
        if batch_grad:
            loss_b.sum().backward()
        mem = self.stacked_retrieve(ss, ctx, xb, yb, ret_draws,
                                    stacked_grads(ss) if self.mir else None)
        if self.aser_mode:
            ss.optimizer.zero_grad()
        if ss.buffer.current_index > 0:
            with torch.set_grad_enabled(not self.aser_mode):
                loss_m = point_map(ss, self.memory_loss, ctx, *mem)
            if not self.aser_mode:
                loss_m.sum().backward()
        if self.aser_mode:
            point_map(ss, self.combined_loss, ctx, xb, yb, *mem).sum().backward()
        ss.optimizer.step()
        return loss_b, acc_b
