"""review_trick: one epoch of memory replay at gradients / 10 after each task
(counterpart of ocl_tpu/agents/review.py; reference agents/base.py:62-88).

The filled buffer is shuffled and cut into eps_mem_batch batches, the last
partial batch dropped. Each batch takes a train-mode step whose gradients are
divided by 10 before the optimizer step (under Adam that is not lr / 10).
"""

from __future__ import annotations

import torch


def review_pass(agent, state, ctx, perm=None):
    """In place on `state`. `perm` [current_index] replaces the shuffle's draw
    from the run's generator."""
    buf, model, opt = state.buffer, state.model, state.optimizer
    n = buf.current_index
    bs = agent.params.eps_mem_batch
    n_batches = n // bs
    if n_batches == 0:
        return state
    if perm is None:
        perm = torch.randperm(n, generator=state.generator, device=agent.device)
    for idx in perm[: n_batches * bs].reshape(n_batches, bs):
        opt.zero_grad()
        agent.review_loss(model, buf.imgs[idx], buf.labels[idx], ctx).backward()
        for p in model.parameters():
            p.grad.div_(10.0)
        opt.step()
    return state
