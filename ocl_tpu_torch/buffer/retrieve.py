"""Stateless retrieval primitives over the fixed-shape buffer (counterpart of
ocl_tpu/buffer/retrieve.py).

Uniform sampling without replacement is Gumbel top-k, with the Gumbel noise
passed in. `jax.lax.top_k` puts the lower index first among equal scores;
`torch.topk` on CUDA does not promise that, so top-k here is a stable
descending sort, sliced.
"""

from __future__ import annotations

import torch

from ocl_tpu_torch.buffer.state import BufferState, valid_mask
from ocl_tpu_torch.ops.losses import NEG_INF


def gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise from `generator`, drawn as JAX draws it:
    -log(-log(u)) with u uniform in [tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def top_k_indices(scores, k: int):
    """Indices of the k largest entries along the last axis, lower index first
    among ties (jax.lax.top_k's order)."""
    return torch.sort(scores, dim=-1, descending=True, stable=True).indices[..., :k]


def exclusion_mask(idx, mask, mem: int):
    """[mem] bool, True at idx[i] where mask[i] (out of place, so that it
    also maps under vmap)."""
    excl = torch.zeros(mem + 1, dtype=torch.bool, device=idx.device)
    return excl.index_put((torch.where(mask, idx, mem),), torch.ones_like(mask))[:mem]


def sample_slots(g, eligible, k: int):
    """Uniformly sample up to k True positions of `eligible` w/o replacement,
    with Gumbel noise `g` (eligible's shape).

    Returns (idx [k], mask [k]) — mask[i] is False where fewer than k eligible
    slots existed (those idx entries are arbitrary positions).
    """
    scores = torch.where(eligible, g, NEG_INF)
    idx = top_k_indices(scores, k)
    mask = torch.arange(k, device=g.device) < eligible.sum()
    return idx, mask


def random_retrieve(buf: BufferState, num_retrieve: int, g, excl_mask=None):
    """(x [k,...], y [k], idx [k], mask [k]) uniform over filled slots;
    `g` [mem_size] Gumbel noise."""
    eligible = valid_mask(buf)
    if excl_mask is not None:
        eligible = eligible & ~excl_mask
    idx, mask = sample_slots(g, eligible, num_retrieve)
    return (*buf.take(idx), idx, mask)


def class_balanced_sample(buf: BufferState, n_smp_cls: int, g, excl_mask=None):
    """Up to n_smp_cls uniform samples from each class present in the buffer:
    one Gumbel top-k per class row of a [C, mem] eligibility matrix, with
    `g` [C, mem_size] Gumbel noise.

    Returns (x [C*n, ...], y [C*n], idx [C*n], mask [C*n]).
    """
    n_cls = buf.class_counts.shape[0]
    dev = g.device
    filled = valid_mask(buf)
    if excl_mask is not None:
        filled = filled & ~excl_mask
    elig = (buf.labels[None, :] == torch.arange(n_cls, device=dev)[:, None]) & filled[None, :]
    scores = torch.where(elig, g, NEG_INF)
    idx = top_k_indices(scores, n_smp_cls)                        # [C, n]
    counts = elig.sum(1)                                          # [C]
    mask = torch.arange(n_smp_cls, device=dev)[None, :] < counts[:, None]
    idx, mask = idx.reshape(-1), mask.reshape(-1)
    safe_idx = torch.where(mask, idx, 0)
    return (*buf.take(safe_idx), safe_idx, mask)
