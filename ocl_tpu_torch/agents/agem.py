"""Averaged Gradient Episodic Memory (counterpart of ocl_tpu/agents/agem.py;
reference agents/agem.py).

Compute the batch gradient g and, from a retrieved memory batch, a reference
gradient g_ref; where <g, g_ref> < 0 project g <- g - (<g, g_ref> / ||g_ref||²)
g_ref, then step. The coefficient is a `torch.where` on the device. The
memory pass runs from the second task on, when the buffer holds a row; a
retrieval with no valid row folds no BN statistics and gives g_ref = 0, so
the coefficient is 0, as ocl_tpu's `jnp.any(mem_mask)` gate has it.

In a data-parallel step (parallel/dp.py) each rank takes its rows of the
batch and of the memory rows, and g and g_ref are each summed over the ranks
before the dot products, so every rank projects with the same coefficient.

`stacked_step` takes every point's losses under vmap and projects each
point's gradient with its own coefficient, from dot products over that
point's slice of the stacked leaves.
"""

from __future__ import annotations

import torch

from ocl_tpu_torch.agents.base import ContinualLearner, point_map
from ocl_tpu_torch.agents.er import ExperienceReplay, batch_grads, stacked_grads
from ocl_tpu_torch.buffer import build_retrieve, build_update
from ocl_tpu_torch.models import forward_train
from ocl_tpu_torch.optim import _per_point
from ocl_tpu_torch.parallel import dp


def _dot(a, b):
    return sum((x * y).sum() for x, y in zip(a, b))


def _dot_points(a, b):
    """[P] dot products of stacked leaves, point by point."""
    return sum((x * y).flatten(1).sum(1) for x, y in zip(a, b))


class AGEM(ContinualLearner):
    def __init__(self, params):
        super().__init__(params)
        self.retrieve = build_retrieve(self)
        self.update = build_update(self)

    draw = ExperienceReplay.draw
    stacked_retrieve = ExperienceReplay.stacked_retrieve
    stacked_update = ExperienceReplay.stacked_update

    def loss(self, state, ctx, x, y, mask=None):
        logits = forward_train(state.model, x, mask)
        loss = self.criterion(logits, y, ctx, mask)
        loss = self.maybe_kd_blend(loss, logits, x, ctx, state.agent, mask)
        return dp.share(loss, mask), logits

    def batch_loss(self, state, ctx, x, y):
        loss, logits = self.loss(state, ctx, x, y)
        return loss, (logits.argmax(1) == y).float().mean()

    def memory_loss(self, state, ctx, x, y, mask):
        return self.loss(state, ctx, x, y, mask)[0]

    def stacked_step(self, ss, ctx, xb, yb, draws=None):
        if draws is None:
            draws = ss.draw(lambda g: self.draw(g, xb.shape[1]))
        opt = ss.optimizer
        for ret_draws in draws["retrieve"]:
            opt.zero_grad()
            loss_b, acc_b = point_map(ss, self.batch_loss, ctx, xb, yb)
            loss_b.sum().backward()
            mem = self.stacked_retrieve(ss, ctx, xb, yb, ret_draws, stacked_grads(ss))
            if ctx.task_seen > 0 and ss.buffer.current_index > 0:
                g = [p.grad for p in opt.params]
                opt.zero_grad()
                point_map(ss, self.memory_loss, ctx, *mem).sum().backward()
                g_ref = [p.grad for p in opt.params]
                prod = _dot_points(g, g_ref)
                coef = torch.where(prod < 0,
                                   prod / torch.clamp(_dot_points(g_ref, g_ref), min=1e-12), 0.0)
                for p, gi, ri in zip(opt.params, g, g_ref):
                    p.grad = gi - _per_point(coef, ri) * ri
            opt.step()
        self.stacked_update(ss, ctx, xb, yb, draws["update"])
        return loss_b.detach(), acc_b

    def step(self, state, ctx, xb, yb, draws=None):
        model, opt, buf = state.model, state.optimizer, state.buffer
        if draws is None:
            draws = self.draw(state.generator, xb.shape[0])
        params = list(model.parameters())
        xb_r, yb_r = dp.local_rows(xb, yb)
        for ret_draws in draws["retrieve"]:
            opt.zero_grad()
            loss_b, logits = self.loss(state, ctx, xb_r, yb_r)
            loss_b.backward()
            dp.reduce_grads(model)
            acc_b = (logits.argmax(1) == yb_r).float().mean()
            mem_x, mem_y, mem_mask = dp.local_rows(*self.retrieve.run(
                model, buf, xb, yb, ret_draws, grads=batch_grads(model)))
            if ctx.task_seen > 0 and buf.current_index > 0:
                g = [p.grad for p in params]
                opt.zero_grad()
                self.loss(state, ctx, mem_x, mem_y, mem_mask)[0].backward()
                dp.reduce_grads(model)
                g_ref = [p.grad for p in params]
                prod = _dot(g, g_ref)
                coef = torch.where(prod < 0, prod / torch.clamp(_dot(g_ref, g_ref), min=1e-12),
                                   0.0)
                for p, gi, ri in zip(params, g, g_ref):
                    p.grad = gi - coef * ri
            opt.step()
        self.update.run(model, buf, xb, yb, draws["update"])
        return loss_b.detach(), acc_b
