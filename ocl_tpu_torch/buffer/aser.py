"""ASER buffer strategies, KNN-SV based update and retrieve (counterpart of
ocl_tpu/buffer/aser.py; reference utils/buffer/aser_update.py + aser_retrieve.py).

Class-balanced sampling is per-class Gumbel top-k over the buffer's
class_counts; the KNN-SV scoring runs batched over fixed shapes with
validity masks, and its distances go through the CUDA kernel on the card.
The fill-or-score and random-or-score branches are host branches on the
buffer's Python-int counters. In a data-parallel step (parallel/dp.py) each
rank computes the features of its share of the rows and gathers the rest,
so every rank holds the same features, runs the kernel on the full
matrices and makes the same picks.
"""

from __future__ import annotations

import torch

from ocl_tpu_torch.buffer import Strategy
from ocl_tpu_torch.buffer.retrieve import (
    class_balanced_sample,
    exclusion_mask,
    gumbel,
    random_retrieve,
    sample_slots,
)
from ocl_tpu_torch.buffer.state import valid_mask, write_slots
from ocl_tpu_torch.config import n_classes_match
from ocl_tpu_torch.models import features_eval
from ocl_tpu_torch.ops.knn_sv import knn_sv, masked_max, masked_mean, masked_min, sum_rows
from ocl_tpu_torch.parallel.dp import row_map


def _stable_argsort(v):
    return torch.sort(v, stable=True).indices


def build_aser_update(agent) -> Strategy:
    """Reference aser_update.py:22-112.

    Reservoir-fill until full; then: evaluation set = class-balanced memory
    sample + minority-class inputs, candidate set = random memory sample
    (excluding eval) + incoming batch; buffered candidates with the lowest
    summed SV are replaced by incoming items with the highest.

    Draws: "thr" [] uniform (minority threshold), "eval" [C, mem] and
    "cand" [mem] Gumbel noise (ocl_tpu's r_thr, r_eval, r_cand).
    """
    params_ns = agent.params
    device = agent.device
    k = int(params_ns.k)
    n_cls = n_classes_match[params_ns.data]
    n_smp_cls = int(params_ns.n_smp_cls)
    n_total_smp = int(params_ns.n_smp_cls * n_cls)
    mem_size = int(params_ns.mem_size)

    def draw(generator, batch):
        return {"thr": torch.rand((), generator=generator, device=device),
                "eval": gumbel((n_cls, mem_size), generator, device),
                "cand": gumbel((mem_size,), generator, device)}

    def sv_replace(model, buf, x, y, over_mask, n_over, draws):
        batch = x.shape[0]
        mem = buf.mem_size
        # minority-class inputs from the overflow part (aser_utils.py:119-157)
        threshold = draws["thr"] / n_cls
        proportion = buf.class_counts.float() / mem_size
        minority = (proportion[y] < threshold) & over_mask

        # evaluation set: class-balanced + minority inputs
        ev_x, ev_y, ev_idx, ev_mask = class_balanced_sample(buf, n_smp_cls, draws["eval"])
        eval_x = torch.cat([ev_x, x])
        eval_y = torch.cat([ev_y, y])
        eval_mask = torch.cat([ev_mask, minority])

        # candidate set: random memory sample excluding eval + overflow batch
        excl = exclusion_mask(ev_idx, ev_mask, mem)
        cd_idx, cd_mask = sample_slots(draws["cand"], valid_mask(buf) & ~excl, n_total_smp)
        cd_x, cd_y = buf.take(cd_idx)
        cand_x = torch.cat([cd_x, x])
        cand_y = torch.cat([cd_y, y])
        cand_mask = torch.cat([cd_mask, over_mask])

        feats = row_map(lambda r: features_eval(model, r), torch.cat([eval_x, cand_x]))
        ef, cf = feats[: eval_x.shape[0]], feats[eval_x.shape[0]:]
        sv = sum_rows(knn_sv(ef, eval_y, eval_mask, cf, cand_y, cand_mask, k))

        # segment the sv-descending order: 'large' = kept, 'small' = dropped
        order = _stable_argsort(torch.where(cand_mask, -sv, torch.inf))
        n_valid_buf = cd_mask.sum()
        n_valid_total = n_valid_buf + n_over
        rank = torch.arange(order.shape[0], device=x.device)
        entry_is_cur = order >= n_total_smp
        in_large = rank < n_valid_buf
        in_small = (rank >= n_valid_buf) & (rank < n_valid_total)

        take_cur = in_large & entry_is_cur          # incoming items to insert
        drop_buf = in_small & ~entry_is_cur         # buffered slots to evict

        big = order.shape[0]
        cur_rank_pos = _stable_argsort(torch.where(take_cur, rank, big))[:batch]
        buf_rank_pos = _stable_argsort(torch.where(drop_buf, rank, big))[:batch]
        pair_mask = torch.arange(batch, device=x.device) < take_cur.sum()

        items = (order[cur_rank_pos] - n_total_smp).clamp(0, batch - 1)
        # JAX clamps an out-of-range gather; torch raises, so clamp the
        # positions of the masked-off pairs explicitly
        slots = cd_idx[order[buf_rank_pos].clamp(max=n_total_smp - 1)]
        write_slots(buf, slots, x[items], y[items], pair_mask)

    def update(model, buf, x, y, draws):
        batch = x.shape[0]
        mem = buf.mem_size
        cur = buf.current_index
        offset = min(max(0, mem - cur), batch)

        # 1) sequential fill of whatever still fits (reference :28-37)
        pos = torch.arange(batch, device=x.device)
        write_slots(buf, cur + pos, x, y, pos < offset)
        buf.current_index = cur + offset
        buf.n_seen_so_far += offset

        # 2) SV-based replacement for the overflow part (reference :42-112)
        n_over = batch - offset
        if buf.current_index >= mem and n_over > 0:
            sv_replace(model, buf, x, y, pos >= offset, n_over, draws)
        buf.n_seen_so_far += n_over
        return torch.full((batch,), -1, device=x.device)

    return Strategy(draw, update)


def build_aser_retrieve(agent) -> Strategy:
    """Reference aser_retrieve.py:22-92: random until the buffer fills, then
    top-eps_mem_batch candidates by adversarial/cooperative SV.

    Draws: "rand" [mem], "cand" [C, mem], "coop" [C, mem] Gumbel noise
    (ocl_tpu's r_rand, r_cand, r_coop)."""
    params_ns = agent.params
    device = agent.device
    k = int(params_ns.k)
    n_cls = n_classes_match[params_ns.data]
    n_smp_cls = int(params_ns.n_smp_cls)
    num_retrieve = int(params_ns.eps_mem_batch)
    mem_size = int(params_ns.mem_size)
    aser_type = params_ns.aser_type

    def draw(generator, batch):
        return {"rand": gumbel((mem_size,), generator, device),
                "cand": gumbel((n_cls, mem_size), generator, device),
                "coop": gumbel((n_cls, mem_size), generator, device)}

    def sv_path(model, buf, x, y, draws):
        cand_x, cand_y, cand_idx, cand_mask = class_balanced_sample(
            buf, n_smp_cls, draws["cand"])
        batch_mask = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)

        if aser_type == "neg_sv":
            feats = row_map(lambda r: features_eval(model, r), torch.cat([x, cand_x]))
            af, cf = feats[: x.shape[0]], feats[x.shape[0]:]
            sv = -sum_rows(knn_sv(af, y, batch_mask, cf, cand_y, cand_mask, k))
        else:
            excl = exclusion_mask(cand_idx, cand_mask, buf.mem_size)
            coop_x, coop_y, _, coop_mask = class_balanced_sample(
                buf, n_smp_cls, draws["coop"], excl_mask=excl)
            feats = row_map(lambda r: features_eval(model, r), torch.cat([x, coop_x, cand_x]))
            af = feats[: x.shape[0]]
            of = feats[x.shape[0]: x.shape[0] + coop_x.shape[0]]
            cf = feats[x.shape[0] + coop_x.shape[0]:]
            sv_adv = knn_sv(af, y, batch_mask, cf, cand_y, cand_mask, k)
            sv_coop = knn_sv(of, coop_y, coop_mask, cf, cand_y, cand_mask, k)
            if aser_type == "asv":
                sv = masked_max(sv_coop, coop_mask) - masked_min(sv_adv, batch_mask)
            else:  # "asvm" and anything else
                sv = masked_mean(sv_coop, coop_mask) - masked_mean(sv_adv, batch_mask)

        sv = torch.where(cand_mask, sv, -torch.inf)
        top = torch.sort(sv, descending=True, stable=True).indices[:num_retrieve]
        n_valid = torch.clamp(cand_mask.sum(), max=num_retrieve)
        mask = torch.arange(num_retrieve, device=x.device) < n_valid
        return cand_x[top], cand_y[top], mask

    def retrieve(model, buf, x, y, draws, grads=None):
        if buf.n_seen_so_far <= mem_size:
            mx, my, _, mask = random_retrieve(buf, num_retrieve, draws["rand"])
            return mx, my, mask
        return sv_path(model, buf, x, y, draws)

    return Strategy(draw, retrieve)
