"""Maximally Interfered Retrieval (counterpart of ocl_tpu/buffer/mir.py;
reference utils/buffer/mir_retrieve.py:15-47).

A random subsample of the buffer is scored by how much one virtual SGD step
on the incoming batch (p - lr * g_b, no weight decay) raises each row's loss;
the eps_mem_batch rows that rise most are retrieved. Both scoring forwards
run in train mode without gradients, as the reference's do. The pre forward
is on the live model and folds the subsample's BN statistics into its running
statistics (the reference's side effect; nothing folds when no row is valid,
see models/layers.py). The post forward runs the virtual weights through
`functional_forward` and folds nothing. In a data-parallel step
(parallel/dp.py) `grads` are the global batch's, and each rank scores its
rows of the subsample, the BN statistics of both forwards over all of it;
the scores are gathered, so every rank picks the same rows.

Draws: "g" [mem_size] Gumbel noise for the subsample (ocl_tpu's rng).
"""

from __future__ import annotations

import torch

from ocl_tpu_torch.buffer.retrieve import gumbel, random_retrieve, top_k_indices
from ocl_tpu_torch.models import forward_train, functional_forward
from ocl_tpu_torch.ops.losses import NEG_INF, nll
from ocl_tpu_torch.parallel import dp


def build_mir_retrieve(agent):
    from ocl_tpu_torch.buffer import Strategy

    lr = float(agent.params.learning_rate)
    subsample = int(agent.params.subsample)
    k = int(agent.params.eps_mem_batch)
    mem_size = int(agent.params.mem_size)
    device = agent.device

    def draw(generator, batch):
        return {"g": gumbel((mem_size,), generator, device)}

    @torch.no_grad()
    def retrieve(model, buf, x, y, draws, grads=None):
        if grads is None:
            raise ValueError("MIR retrieval needs the batch gradients")
        sub_x, sub_y, _, sub_mask = random_retrieve(buf, subsample, draws["g"])
        virtual = {n: p - lr * grads[n] for n, p in model.named_parameters()}

        def score(m, x, y):
            logits_pre = forward_train(model, x, m)
            # the same mask on the post forward: both passes normalise with
            # the statistics of the same valid rows
            logits_post = functional_forward(model, virtual, x, train=True, w=m, fold=False)
            return torch.where(m, nll(logits_post.log_softmax(-1), y)
                               - nll(logits_pre.log_softmax(-1), y), NEG_INF)

        top = top_k_indices(dp.split_rows(score, sub_mask, sub_x, sub_y), k)
        mask = torch.arange(k, device=x.device) < torch.clamp(sub_mask.sum(), max=k)
        return sub_x[top], sub_y[top], mask

    return Strategy(draw, retrieve)
