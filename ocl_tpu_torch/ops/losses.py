"""Losses (counterpart of ocl_tpu/ops/losses.py), mask-aware for fixed-shape
batches: a `mask` [B] leaves rows out of the mean, and class restrictions
set the excluded logits to NEG_INF instead of gathering columns.

  * cross_entropy — torch CrossEntropyLoss(reduction='mean') over valid rows;
  * labels_trick_ce, separated_softmax_ce — the trick-aware criterion
    (reference agents/base.py:93-113);
  * kd_loss — T=2 softened KL (reference utils/kd_manager.py:6-11);
  * supcon_loss — multi-view supervised contrastive loss (reference
    utils/loss.py:19-96) with a validity mask;
  * bce_ohe — iCaRL's summed binary CE over one-hot targets (reference
    agents/icarl.py:63).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ocl_tpu_torch.parallel import dp

NEG_INF = -1e30


def _masked_mean(values, mask):
    if mask is None:
        return values.mean()
    mask = mask.to(values.dtype)
    return (values * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def nll(logp, labels):
    """Per-row negative log-likelihood of `labels` under log-probabilities
    `logp` [B, C]."""
    return -logp.gather(1, labels[:, None].long())[:, 0]


def cross_entropy(logits, labels, mask=None, class_mask=None):
    """Mean CE over the rows where `mask`; `class_mask` [C] bool restricts the
    softmax support."""
    if class_mask is not None:
        logits = torch.where(class_mask[None, :], logits, NEG_INF)
    return _masked_mean(nll(F.log_softmax(logits, dim=-1), labels), mask)


def labels_trick_ce(logits, labels, mask=None):
    """CE restricted to the classes present in the valid rows of the batch
    (reference agents/base.py:96-101 remaps labels onto that set)."""
    onehot = F.one_hot(labels.long(), logits.shape[-1]).to(torch.float32)
    if mask is not None:
        onehot = onehot * mask[:, None].to(torch.float32)
    # in a data-parallel step, the classes of the global batch's valid rows
    present = dp.rank_sum(onehot.sum(0)) > 0
    return cross_entropy(logits, labels, mask=mask, class_mask=present)


def separated_softmax_ce(logits, labels, old_mask, new_mask, mask=None):
    """Separate log-softmax over the old-task and the new-task classes; each
    row takes its label's own partition (reference agents/base.py:102-108)."""
    old_ls = F.log_softmax(torch.where(old_mask[None, :], logits, NEG_INF), dim=-1)
    new_ls = F.log_softmax(torch.where(new_mask[None, :], logits, NEG_INF), dim=-1)
    ls = torch.where(old_mask[labels.long()][:, None], old_ls, new_ls)
    return _masked_mean(nll(ls, labels), mask)


def kd_loss(student_logits, teacher_logits, T: float = 2.0, mask=None):
    """Softened-KL distillation: T² · mean over rows of −Σ p_t log p_s."""
    log_s = F.log_softmax(student_logits / T, dim=1)
    p_t = F.softmax(teacher_logits / T, dim=1)
    per_row = (-p_t * log_s).sum(1)
    return _masked_mean(per_row, mask) * (T ** 2)


def supcon_loss(features, labels, temperature: float = 0.07, mask=None):
    """Supervised contrastive loss, contrast_mode='all'.

    features: [bsz, n_views, d] (L2-normalised), labels: [bsz], mask: [bsz]
    validity (invalid rows are neither anchors nor contrasts).
    """
    bsz, n_views, _ = features.shape
    n = bsz * n_views
    dev = features.device
    # [views*bsz, d], view-major as torch.cat(torch.unbind(f, 1))
    contrast = torch.cat(features.unbind(1), dim=0)
    tiled_labels = labels.repeat(n_views)
    if mask is None:
        row_valid = torch.ones(n, dtype=torch.bool, device=dev)
    else:
        row_valid = mask.bool().repeat(n_views)

    sim = contrast @ contrast.T / temperature
    # stabilisation by the detached row max, as in the reference
    sim = sim - torch.where(row_valid[None, :], sim, NEG_INF).amax(1, keepdim=True).detach()

    pos_mask = (tiled_labels[:, None] == tiled_labels[None, :]).to(torch.float32)
    logits_mask = (1.0 - torch.eye(n, device=dev)) * row_valid[None, :].to(torch.float32)
    pos_mask = pos_mask * logits_mask

    exp_sim = torch.exp(sim) * logits_mask
    log_prob = sim - torch.log(torch.clamp(exp_sim.sum(1, keepdim=True), min=1e-30))
    mean_log_prob_pos = (pos_mask * log_prob).sum(1) / torch.clamp(pos_mask.sum(1), min=1.0)
    return -_masked_mean(torch.where(row_valid, mean_log_prob_pos, 0.0), row_valid)


def bce_ohe(logits, targets, class_mask=None, mask=None):
    """Binary CE with logits over one-hot-style targets, summed over the
    classes of `class_mask` (reference agents/icarl.py:63 uses the first
    `all_cls_num` columns)."""
    per_elt = torch.clamp(logits, min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))
    if class_mask is not None:
        per_elt = per_elt * class_mask[None, :].to(per_elt.dtype)
    return _masked_mean(per_elt.sum(1), mask)
