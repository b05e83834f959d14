"""review_trick: one epoch of memory replay at gradients / 10 after each task
(counterpart of ocl_tpu/agents/review.py; reference agents/base.py:62-88).

The filled buffer is shuffled and cut into eps_mem_batch batches, the last
partial batch dropped. Each batch takes a train-mode step whose gradients are
divided by 10 before the optimizer step (under Adam that is not lr / 10).
The loss is the agent's `review_loss`, with the batch's own random draws
from `review_draws` (SCR augments each batch; other agents draw nothing).
"""

from __future__ import annotations

import torch


def review_pass(agent, state, ctx, perm=None, draws=None):
    """In place on `state`. `perm` [current_index] replaces the shuffle's draw
    from the run's generator, and `draws` (one entry a batch) the batches'
    `review_draws`."""
    buf, model, opt = state.buffer, state.model, state.optimizer
    n = buf.current_index
    bs = agent.params.eps_mem_batch
    n_batches = n // bs
    if n_batches == 0:
        return state
    if perm is None:
        perm = torch.randperm(n, generator=state.generator, device=agent.device)
    for i, idx in enumerate(perm[: n_batches * bs].reshape(n_batches, bs)):
        batch_draws = agent.review_draws(state, bs) if draws is None else draws[i]
        opt.zero_grad()
        agent.review_loss(model, buf.imgs[idx], buf.labels[idx], ctx, batch_draws).backward()
        for p in model.parameters():
            p.grad.div_(10.0)
        opt.step()
    return state
