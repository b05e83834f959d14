"""Faults planted in the port under a run, to show that the correctness check
fails them (the tests, and `calibrate.py`'s readings on the card). Each
takes the cell's loop after its set-up has built the port's state and
before the checked steps, breaks the timed path, and returns a function
that undoes it.

  frozen         a step that leaves its state unchanged (it runs on a copy);
  half_batch     the loss a mean over the first half of its rows alone;
  altered_write  every label the buffer writes altered where it is written;
  leaf_lr        the optimizer's update of one leaf in ten doubled (a few
                 leaves under a wrong learning rate).
"""

from __future__ import annotations

import copy

import torch


def frozen(loop):
    agent = loop.agent
    if hasattr(loop, "ss"):
        orig = agent.stacked_step
        agent.stacked_step = lambda ss, ctx, xb, yb, draws=None: orig(
            copy.deepcopy(ss), ctx, xb, yb, draws)
        return lambda: delattr(agent, "stacked_step")
    orig = agent.step
    agent.step = lambda state, ctx, xb, yb, draws=None: orig(
        copy.deepcopy(state), ctx, xb, yb, draws)
    return lambda: delattr(agent, "step")


def half_batch(loop):
    agent = loop.agent
    orig = agent.criterion

    def criterion(logits, labels, ctx, mask=None):
        h = logits.shape[0] // 2
        return orig(logits[:h], labels[:h], ctx, None if mask is None else mask[:h])

    agent.criterion = criterion
    return lambda: delattr(agent, "criterion")


def altered_write(loop):
    from ocl_tpu_torch.buffer.state import BufferState

    orig = BufferState.write
    classes = loop.arch["classes"]

    def write(self, slot_idx, x, y, write_mask):
        return orig(self, slot_idx, x, (y + 1) % classes, write_mask)

    BufferState.write = write

    def undo():
        BufferState.write = orig
    return undo


def leaf_lr(loop):
    opt = loop.ss.optimizer if hasattr(loop, "ss") else loop.state.optimizer
    params = opt.params if hasattr(opt, "params") else \
        [p for g in opt.param_groups for p in g["params"]]
    chosen = params[5::10]
    orig = opt.step

    def step(*args, **kwargs):
        before = [p.detach().clone() for p in chosen]
        out = orig(*args, **kwargs)
        with torch.no_grad():
            for p, b in zip(chosen, before):
                p.add_(p - b)
        return out

    opt.step = step
    return lambda: delattr(opt, "step")


FAULTS = {"frozen": frozen, "half_batch": half_batch, "altered_write": altered_write,
          "leaf_lr": leaf_lr}
