"""KNN Shapley values over deep features, batched and mask-aware
(counterpart of ocl_tpu/ops/knn_sv.py; reference utils/buffer/aser_utils.py:7-61).

Pairwise squared distances eval x cand (the CUDA kernel on the card), a
stable per-row distance argsort, the indicator/factor recursion as a reverse
cumulative sum, scattered back to candidate order. Invalid candidates sort to
the end with +inf distance and label -1, and the recursion's position factors
use the count of *valid* candidates, so masked rows/columns reproduce the
reference's dynamically shaped result.
"""

from __future__ import annotations

import torch

from ocl_tpu_torch.ops.distance import pairwise_sqdist


def knn_sv(eval_feats, eval_y, eval_mask, cand_feats, cand_y, cand_mask, k: int):
    """SV matrix [n_eval, n_cand]; rows of invalid evals are zero."""
    n_eval, n_cand = eval_feats.shape[0], cand_feats.shape[0]
    dev = eval_feats.device
    n_valid = cand_mask.sum()

    d = pairwise_sqdist(eval_feats, cand_feats)
    d = torch.where(cand_mask[None, :], d, torch.inf)
    # stable, like jnp.argsort: equal distances keep candidate order
    sorted_ind = torch.sort(d, dim=1, stable=True).indices

    cl = torch.where(cand_mask, cand_y, -1)[sorted_ind]
    indicator = (eval_y[:, None] == cl).float()
    indicator_next = torch.cat(
        [indicator[:, 1:], torch.zeros((n_eval, 1), device=dev)], dim=1)
    diff = indicator - indicator_next

    pos = torch.arange(n_cand, device=dev)
    j1 = (pos + 1).float()
    last = pos == n_valid - 1
    denom = j1 * torch.where(last, 1.0, float(k))
    numer = torch.where(last, 1.0, torch.where(pos >= k, float(k), j1))
    factor = numer / denom

    rc = reverse_cumsum(diff * factor)
    sv = torch.zeros((n_eval, n_cand), device=dev).scatter(1, sorted_ind, rc)
    return torch.where(eval_mask[:, None], sv, 0.0)


# Summation order. Many SVs are equal in exact arithmetic (a run of
# candidates far from every eval point of their class shares one recursion
# value), so ASER's stable top-k orders them by the rounding of these two
# sums alone. They are one torch reduction each; the tests that hold ASER's
# choices against ocl_tpu's substitute XLA's order of additions here.


def reverse_cumsum(v):
    """out[:, j] = sum of v[:, j:] along the last axis of v [n, m]."""
    return torch.flip(torch.cumsum(torch.flip(v, dims=[1]), dim=1), dims=[1])


def sum_rows(sv):
    """Column sums of sv [n_eval, n_cand] -> [n_cand]."""
    return sv.sum(0)


def masked_mean(sv, eval_mask):
    """Mean over valid eval rows -> [n_cand]."""
    n = torch.clamp(eval_mask.float().sum(), min=1.0)
    return sum_rows(sv) / n


def masked_max(sv, eval_mask):
    return torch.where(eval_mask[:, None], sv, -torch.inf).amax(0)


def masked_min(sv, eval_mask):
    return torch.where(eval_mask[:, None], sv, torch.inf).amin(0)
