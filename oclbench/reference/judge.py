"""Judging a run's first steps against the reference.

A run hands the reference what its timed path produced in its first steps
(a `record`): each step's batch loss, the per-leaf norms of the first
step's gradient as the optimizer got it and of the parameters' change after
the first step and over all the steps, and the buffer it left after each step (image fingerprints,
labels, class counts; for ASER also the rows it retrieved). The reference
replays the same steps from the same start, inputs and draws, and the
comparison reduces to these numbers:

  loss     the largest gap of a step's batch loss, over the reference's;
  grad1    the worst leaf's gap between the norms of the first gradient,
           over the larger of that leaf's reference norm and the median
           leaf's;
  change1  the worst leaf's gap, so measured, for the parameters' change
           after the first step (the worst point's): the optimizer's update
           leaf by leaf, before later steps magnify rounding; leaves left
           out as for change3_median, by the first step's change;
  change3_median  the median leaf's gap, so measured, for the
           parameters' change over the steps (the worst point's), leaving
           out leaves whose reference gradient is under a thousandth of
           the median leaf's (they move by round-off alone) and leaves
           whose reference change is under a thousand times the norm of
           their initial weights' fp32 spacing (the weights cannot hold
           such a change to better than a thousandth: a BatchNorm scale
           of 1 under lr 1e-4 moves by a few ulps). The worst leaf's gap
           (`change3_worst`, reported, not compared) swings from seed to
           seed: the later steps magnify a difference of 1e-7 in the
           weights a thousandfold in a few BatchNorm leaves, the
           reference's own as much as the port's;
  picks    the worst score margin by which one of ASER's picks departs
           from the reference's order, over the spread of the scores;
  exact    choices and writes that must agree exactly and did not:
           random retrievals, the reservoir's writes, buffer contents and
           class counts, writes no pick explains.

ASER's picks rest on sums of Shapley values that rounding can reorder among
near-equal candidates, so the reference judges each pick of the program by
the margin above and then applies the program's pick: the continuous
numbers then keep comparing like with like. Imports torch and this package.
"""

from __future__ import annotations

import torch

from oclbench.reference import er


def _scale(s):
    spread = float(s.max() - s.min()) if s.numel() else 0.0
    return spread if spread > 0 else 1.0


def selection_gap(sv, valid, chosen):
    """Margin by which `chosen` (a bool mask over candidates) departs from
    the top `chosen.sum()` of `sv` over `valid`, over the scores' spread."""
    s = sv[valid]
    n = int(chosen.sum())
    if s.numel() == 0 or n == 0:
        return 0.0
    srt = torch.sort(s, descending=True).values
    mid = (srt[n - 1] + srt[n]) / 2 if n < s.numel() else srt[-1] - _scale(s)
    v = torch.where(chosen, mid - sv, sv - mid)[valid]
    return max(0.0, float(v.max())) / _scale(s)


def update_gap(sv, valid, n_total, n_valid_buf, pairs):
    """Margin by which ASER update pairs `pairs` [(cur position, buffer
    position)] depart from the reference's scores: inserted batch items and
    kept buffer candidates above the cut at rank n_valid_buf, the others
    below, and pairs matched in rank order. Over the scores' spread."""
    s = sv[valid]
    if s.numel() == 0:
        return 0.0
    scale = _scale(s)
    srt = torch.sort(s, descending=True).values
    if n_valid_buf == 0:
        mid = srt[0] + scale
    elif n_valid_buf >= s.numel():
        mid = srt[-1] - scale
    else:
        mid = (srt[n_valid_buf - 1] + srt[n_valid_buf]) / 2
    n = sv.shape[0]
    chosen = torch.zeros(n, dtype=torch.bool, device=sv.device)
    for c, b in pairs:
        chosen[c] = True
        chosen[b] = True
    is_cur = torch.arange(n, device=sv.device) >= n_total
    above = chosen == is_cur   # inserted items and kept candidates
    v = torch.where(above, mid - sv, sv - mid)[valid]
    worst = max(0.0, float(v.max()))
    for i, (c1, b1) in enumerate(pairs):
        for c2, b2 in pairs[i + 1:]:
            dc, db = float(sv[c1] - sv[c2]), float(sv[b1] - sv[b2])
            if dc * db < 0:
                worst = max(worst, min(abs(dc), abs(db)))
    return worst / scale


class Follow:
    """Judges ASER's choices in a program record step by step and applies
    the program's; `picks` and `exact` accumulate."""

    def __init__(self, record):
        self.rec = record
        self.picks = 0.0
        self.exact = 0

    def retrieve_exact(self, t, st, slots, mask):
        fp, y, m = self.rec["retrieved"][t]
        buf = st.buf
        bad = (m != mask) | (mask & ((fp != er.fingerprint(buf.x[slots])) | (y != buf.y[slots])))
        self.exact += int(bad.sum())

    def retrieve(self, t, st, cand_idx, cand_mask, sv, own_slots, own_mask):
        fp, y, m = self.rec["retrieved"][t]
        buf = st.buf
        self.exact += abs(int(m.sum()) - int(own_mask.sum()))
        cand_fp = er.fingerprint(buf.x[cand_idx])
        chosen = torch.zeros_like(cand_mask)
        slots = own_slots.clone()
        for i in torch.nonzero(m).flatten().tolist():
            hit = torch.nonzero(cand_mask & (cand_fp == fp[i]) & ~chosen).flatten()
            if hit.numel() == 0:
                self.exact += 1
                self.picks = max(self.picks, 1.0)
                continue
            j = int(hit[0])
            chosen[j] = True
            slots[i] = cand_idx[j]
            self.exact += int(y[i] != buf.y[cand_idx[j]])
        self.picks = max(self.picks, selection_gap(sv, cand_mask, chosen))
        return slots, m.clone()

    def update(self, t, st, sc, own_pairs, xb, yb):
        fp_after, y_after, _ = self.rec["buffer"][t]
        buf = st.buf
        mem = buf.mem
        changed = (fp_after != er.fingerprint(buf.x[:mem])) | (y_after != buf.y[:mem])
        batch_fp = er.fingerprint(xb)
        n_total = sc["n_total"]
        pairs, positions = [], []
        for s in torch.nonzero(changed).flatten().tolist():
            item = torch.nonzero((batch_fp == fp_after[s]) & (yb == y_after[s])).flatten()
            pos = torch.nonzero((sc["cd_idx"] == s) & sc["mask"][:n_total]).flatten()
            if item.numel() == 0 or pos.numel() == 0:
                self.exact += 1
                self.picks = max(self.picks, 1.0)
                continue
            pairs.append((int(item[0]), s))
            positions.append((n_total + int(item[0]), int(pos[0])))
        self.picks = max(self.picks, update_gap(sc["sv"], sc["mask"], n_total,
                                                sc["n_valid_buf"], positions))
        return pairs


def leaf_gaps(prog, ref):
    """[P, L] gaps |prog - ref| of [P, L] leaf norms over max(ref, the
    median leaf's ref)."""
    denom = torch.maximum(ref, ref.median(dim=1, keepdim=True).values)
    return (prog - ref).abs() / torch.clamp(denom, min=torch.finfo(torch.float64).tiny)


def median_kept(gap, keep):
    """The worst point's median gap over its kept leaves."""
    return max((float(g[k].median()) if k.any() else 0.0) for g, k in zip(gap, keep))


def moved(ref, change):
    """[P, L] leaves whose reference gradient is at least a thousandth of
    the median leaf's and whose reference change `change` spans at least a
    thousand times the norm of their weights' fp32 spacing."""
    g = ref["grad1"]
    return (g >= 1e-3 * g.median(dim=1, keepdim=True).values) & \
        (ref[change] >= 1e3 * ref["spacing"])


def compare(prog, ref, follow_picks=0.0, follow_exact=0):
    """The numbers of a program record `prog` against the reference's
    record `ref` (both with "loss" [T, P], "grad1", "change1" and
    "change3" [P, L],
    "buffer": T x (fp [P, mem], y [P, mem], counts [P, C]))."""
    loss = float(((prog["loss"] - ref["loss"]).abs() / ref["loss"].abs()).max())
    exact = follow_exact
    for (pf, py, pc), (rf, ry, rc) in zip(prog["buffer"], ref["buffer"]):
        exact += int(((pf != rf) | (py != ry)).sum()) + int((pc != rc).sum())
    change1 = leaf_gaps(prog["change1"], ref["change1"])
    change = leaf_gaps(prog["change3"], ref["change3"])
    keep = moved(ref, "change3")
    return {"loss": loss,
            "grad1": float(leaf_gaps(prog["grad1"], ref["grad1"]).max()),
            "change1": float(torch.where(moved(ref, "change1"), change1, 0.0).max()),
            "change3_median": median_kept(change, keep),
            "change3_worst": float(torch.where(keep, change, 0.0).max()),
            "picks": follow_picks,
            "exact": exact}
