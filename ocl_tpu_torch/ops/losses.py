"""Losses (counterpart of ocl_tpu/ops/losses.py), mask-aware for fixed-shape
batches. Only the plain cross entropy is ported so far; the trick losses
(labels_trick, separated_softmax, kd, supcon, bce) come later."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _masked_mean(values, mask):
    if mask is None:
        return values.mean()
    mask = mask.to(values.dtype)
    return (values * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def cross_entropy(logits, labels, mask=None):
    """torch CrossEntropyLoss(reduction='mean') over the rows where `mask`."""
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, labels[:, None].long())[:, 0]
    return _masked_mean(nll, mask)
