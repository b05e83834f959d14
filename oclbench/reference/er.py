"""Experience replay in plain PyTorch: the benchmark's reference step.

Two schedules of the survey's ER (Mai et al., arXiv:2101.10423, Algorithm 1)
as the benchmark's cells run them:

* `aser_step`: the reference implementation's two-pass step in ASER mode
  (Shim et al., arXiv:2009.00093): a train-mode pass over the incoming batch
  that only folds its BN statistics and reports its loss, the retrieval,
  a train-mode pass over the retrieved rows that only folds theirs, one
  combined [memory; batch] pass whose masked cross-entropy feeds SGD, then
  the buffer update with the new weights. Retrieval and update are ASER's
  (asvm): KNN Shapley values over eval-mode features, random retrieval
  until the stream has filled the buffer, a sequential fill until it is
  full.
* `fused_step`: random retrieval first, one train-mode pass over
  [batch; memory] whose BN statistics fold over the valid rows of both,
  loss_b + loss_m into SGD with per-point lr and weight decay, then the
  reservoir update.

Random choices come in as the step's draws (Gumbel noise for sampling
without replacement, uniforms for the reservoir and ASER's minority
threshold), so both sides of a comparison make the same choices. Every
top-k is a stable descending sort: the lower index first among equal
scores. Where ASER's choice rests on scores that rounding can reorder, the
step hands its own choice and its scores to a `follow` object (judge.py),
which may return another choice to apply. Imports torch and this package.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from oclbench.reference import model as M

NEG = -1e30


def fingerprint(x):
    """[...] float64 identity of images x [..., H, W, C] whose values are
    k / 255 for whole k: the sum of k times a fixed whole weight per element,
    exact in float64 whatever the order of the sum."""
    k = torch.round(x.reshape(*x.shape[:-3], -1).double() * 255.0)
    coeff = torch.arange(k.shape[-1], dtype=torch.float64, device=x.device) % 1021 + 1
    return k @ coeff


@dataclass
class Buffer:
    x: torch.Tensor          # [mem + 1, H, W, C]; the last row absorbs masked writes
    y: torch.Tensor          # [mem + 1] int64
    classes: int
    cur: int = 0             # slots filled, a prefix
    seen: int = 0

    @property
    def mem(self) -> int:
        return self.y.shape[0] - 1

    def valid(self):
        return torch.arange(self.mem, device=self.y.device) < self.cur

    def counts(self):
        """[classes] labels of the filled slots, counted afresh."""
        return torch.bincount(self.y[: self.cur], minlength=self.classes)

    def write(self, slots, x, y, mask):
        safe = torch.where(mask, slots, self.mem)
        self.x[safe] = x
        self.y[safe] = y


@dataclass
class State:
    params: dict
    stats: dict
    buf: Buffer
    lr: float
    wd: float
    record: dict = field(default_factory=dict)


def top_k(scores, k):
    return torch.sort(scores, dim=-1, descending=True, stable=True).indices[..., :k]


def sample_slots(g, eligible, k):
    idx = top_k(torch.where(eligible, g, NEG), k)
    return idx, torch.arange(k, device=g.device) < eligible.sum()


def exclusion(idx, mask, mem):
    excl = torch.zeros(mem + 1, dtype=torch.bool, device=idx.device)
    excl[torch.where(mask, idx, mem)] = True
    return excl[:mem]


def class_balanced(buf: Buffer, n, g, excl=None):
    """Up to n slots of each class in the buffer by Gumbel top-k over a
    [classes, mem] eligibility; (idx [C n], mask [C n]), an invalid entry's
    index 0."""
    filled = buf.valid()
    if excl is not None:
        filled = filled & ~excl
    c = torch.arange(buf.classes, device=g.device)
    elig = (buf.y[None, : buf.mem] == c[:, None]) & filled[None, :]
    idx = top_k(torch.where(elig, g, NEG), n)
    mask = torch.arange(n, device=g.device)[None, :] < elig.sum(1)[:, None]
    idx, mask = idx.reshape(-1), mask.reshape(-1)
    return torch.where(mask, idx, 0), mask


def sqdist(a, b):
    return (a * a).sum(1, keepdim=True) + (b * b).sum(1, keepdim=True).T - 2.0 * (a @ b.T)


def knn_sv(ef, ey, em, cf, cy, cm, k):
    """KNN Shapley values [n_eval, n_cand] (Jia et al.'s recursion as ASER's
    code computes it); invalid candidates sort last, rows of invalid evals
    are zero."""
    n_eval, n_cand = ef.shape[0], cf.shape[0]
    dev = ef.device
    n_valid = cm.sum()
    d = torch.where(cm[None, :], sqdist(ef, cf), torch.inf)
    order = torch.sort(d, dim=1, stable=True).indices
    cl = torch.where(cm, cy, -1)[order]
    ind = (ey[:, None] == cl).float()
    diff = ind - torch.cat([ind[:, 1:], torch.zeros((n_eval, 1), device=dev)], dim=1)
    pos = torch.arange(n_cand, device=dev)
    j1 = (pos + 1).float()
    last = pos == n_valid - 1
    factor = torch.where(last, 1.0, torch.where(pos >= k, float(k), j1)) / (
        j1 * torch.where(last, 1.0, float(k)))
    rc = torch.flip(torch.cumsum(torch.flip(diff * factor, dims=[1]), dim=1), dims=[1])
    sv = torch.zeros((n_eval, n_cand), device=dev).scatter(1, order, rc)
    return torch.where(em[:, None], sv, 0.0)


def eval_features(st: State, x, arch):
    with torch.no_grad():
        return M.features(st.params, st.stats, x, arch)


def sgd(st: State, grads, stacked_form: bool):
    """torch.optim.SGD's update (weight decay coupled into the gradient), or
    the stacked optimizer's order of the same terms."""
    with torch.no_grad():
        for (name, p), g in zip(st.params.items(), grads):
            if stacked_form:
                new = p - (g + p * st.wd) * st.lr
            else:
                g2 = g + st.wd * p if st.wd else g
                new = p.add(g2, alpha=-st.lr)
            st.params[name] = new.requires_grad_(True)


def loss_and_grads(st: State, x, y, w, arch):
    """The masked cross-entropy of one train-mode pass and its gradients."""
    for p in st.params.values():
        p.requires_grad_(True)
    with torch.enable_grad():
        loss = M.masked_ce(M.logits(st.params, st.stats, x, arch, train=True, w=w), y, w)
        grads = torch.autograd.grad(loss, list(st.params.values()))
    return loss.detach(), grads


# ------------------------------------------------------------------ ASER


def aser_retrieve_scores(st: State, arch, cfg, xb, yb, d):
    """ASER's asvm scores of its class-balanced candidates: (cand_idx,
    cand_mask, sv), sv -inf at invalid candidates."""
    buf, n, k = st.buf, cfg["n_smp_cls"], cfg["k"]
    cand_idx, cand_mask = class_balanced(buf, n, d["cand"])
    excl = exclusion(cand_idx, cand_mask, buf.mem)
    coop_idx, coop_mask = class_balanced(buf, n, d["coop"], excl)
    f = eval_features(st, torch.cat([xb, buf.x[coop_idx], buf.x[cand_idx]]), arch)
    b, c = xb.shape[0], coop_idx.shape[0]
    af, of, cf = f[:b], f[b: b + c], f[b + c:]
    ones = torch.ones(b, dtype=torch.bool, device=xb.device)
    cand_y = buf.y[cand_idx]
    sv_adv = knn_sv(af, yb, ones, cf, cand_y, cand_mask, k)
    sv_coop = knn_sv(of, buf.y[coop_idx], coop_mask, cf, cand_y, cand_mask, k)
    sv = sv_coop.sum(0) / torch.clamp(coop_mask.float().sum(), min=1.0) - \
        sv_adv.sum(0) / torch.clamp(ones.float().sum(), min=1.0)
    return cand_idx, cand_mask, torch.where(cand_mask, sv, -torch.inf)


def aser_retrieve_own(cand_idx, cand_mask, sv, k):
    top = torch.sort(sv, descending=True, stable=True).indices[:k]
    n_valid = torch.clamp(cand_mask.sum(), max=k)
    return cand_idx[top], torch.arange(k, device=sv.device) < n_valid


def aser_update_scores(st: State, arch, cfg, xb, yb, d, over_mask):
    """ASER's update candidates and their summed SVs: a dict of the
    candidates' slots `cd_idx` [n_total] and validity `mask` [n_total + B]
    (buffer candidates, then the batch's overflow items) and `sv`."""
    buf, n, k = st.buf, cfg["n_smp_cls"], cfg["k"]
    n_total = n * buf.classes
    threshold = d["thr"] / buf.classes
    proportion = buf.counts().float() / buf.mem
    minority = (proportion[yb] < threshold) & over_mask
    ev_idx, ev_mask = class_balanced(buf, n, d["eval"])
    excl = exclusion(ev_idx, ev_mask, buf.mem)
    cd_idx, cd_mask = sample_slots(d["cand"], buf.valid() & ~excl, n_total)
    eval_x = torch.cat([buf.x[ev_idx], xb])
    cand_x = torch.cat([buf.x[cd_idx], xb])
    f = eval_features(st, torch.cat([eval_x, cand_x]), arch)
    ef, cf = f[: eval_x.shape[0]], f[eval_x.shape[0]:]
    mask = torch.cat([cd_mask, over_mask])
    sv = knn_sv(ef, torch.cat([buf.y[ev_idx], yb]), torch.cat([ev_mask, minority]), cf,
                torch.cat([buf.y[cd_idx], yb]), mask, k).sum(0)
    return {"cd_idx": cd_idx, "mask": mask, "sv": sv, "n_total": n_total,
            "n_valid_buf": int(cd_mask.sum())}


def aser_update_own(sc, batch, n_over):
    """The (item, slot) pairs ASER's update writes: batch items ranked among
    the kept top n_valid_buf replace the buffered candidates ranked among
    the dropped, both taken in rank order."""
    sv, mask, n_total = sc["sv"], sc["mask"], sc["n_total"]
    dev = sv.device
    order = torch.sort(torch.where(mask, -sv, torch.inf), stable=True).indices
    nvb = sc["n_valid_buf"]
    rank = torch.arange(order.shape[0], device=dev)
    is_cur = order >= n_total
    take_cur = (rank < nvb) & is_cur
    drop_buf = (rank >= nvb) & (rank < nvb + n_over) & ~is_cur
    big = order.shape[0]
    cur_pos = torch.sort(torch.where(take_cur, rank, big), stable=True).indices[:batch]
    buf_pos = torch.sort(torch.where(drop_buf, rank, big), stable=True).indices[:batch]
    n_pairs = int(take_cur.sum())
    items = (order[cur_pos] - n_total)[:n_pairs]
    slots = sc["cd_idx"][order[buf_pos][:n_pairs]]
    return list(zip(items.tolist(), slots.tolist()))


def aser_update(st: State, arch, cfg, xb, yb, d, follow, t):
    buf = st.buf
    b = xb.shape[0]
    offset = min(max(0, buf.mem - buf.cur), b)
    pos = torch.arange(b, device=xb.device)
    buf.write(buf.cur + pos, xb, yb, pos < offset)
    buf.cur += offset
    buf.seen += offset
    n_over = b - offset
    if buf.cur >= buf.mem and n_over > 0:
        sc = aser_update_scores(st, arch, cfg, xb, yb, d, pos >= offset)
        pairs = aser_update_own(sc, b, n_over)
        if follow is not None:
            pairs = follow.update(t, st, sc, pairs, xb, yb)
        for item, slot in pairs:
            buf.x[slot] = xb[item]
            buf.y[slot] = yb[item]
    buf.seen += n_over


def aser_step(st: State, arch, cfg, xb, yb, draws, follow=None, t=0):
    """One ER step in ASER mode; returns (batch loss, gradients of the
    combined pass). Records what it retrieved and the buffer it leaves in
    `st.record` (lists by step), so that it can stand in for the program."""
    buf = st.buf
    with torch.no_grad():
        loss_b = M.masked_ce(M.logits(st.params, st.stats, xb, arch, train=True), yb)
    d = draws["retrieve"][0]
    k = cfg["eps_mem_batch"]
    if buf.seen <= buf.mem:
        slots, mask = sample_slots(d["rand"], buf.valid(), k)
        if follow is not None:
            follow.retrieve_exact(t, st, slots, mask)
    else:
        cand_idx, cand_mask, sv = aser_retrieve_scores(st, arch, cfg, xb, yb, d)
        slots, mask = aser_retrieve_own(cand_idx, cand_mask, sv, k)
        if follow is not None:
            slots, mask = follow.retrieve(t, st, cand_idx, cand_mask, sv, slots, mask)
    mem_x, mem_y = buf.x[slots], buf.y[slots]
    st.record.setdefault("retrieved", []).append(
        (fingerprint(mem_x), mem_y.clone(), mask.clone()))
    if buf.cur > 0:
        with torch.no_grad():
            M.logits(st.params, st.stats, mem_x, arch, train=True, w=mask)
    ones = torch.ones_like(yb, dtype=torch.bool)
    _, grads = loss_and_grads(st, torch.cat([mem_x, xb]), torch.cat([mem_y, yb]),
                              torch.cat([mask, ones]), arch)
    sgd(st, grads, stacked_form=False)
    aser_update(st, arch, cfg, xb, yb, draws["update"], follow, t)
    record_buffer(st)
    return loss_b, grads


def record_buffer(st: State):
    buf = st.buf
    st.record.setdefault("buffer", []).append(
        (fingerprint(buf.x[: buf.mem]), buf.y[: buf.mem].clone(), buf.counts()))


# ------------------------------------------------------------- fused ER


def reservoir(buf: Buffer, xb, yb, u):
    b = xb.shape[0]
    offset = min(max(0, buf.mem - buf.cur), b)
    idx = torch.arange(b, device=u.device)
    is_seq = idx < offset
    rand_slots = (u * float(buf.seen + offset)).to(torch.int64)
    slots = torch.where(is_seq, buf.cur + idx, rand_slots)
    valid = is_seq | (rand_slots < buf.mem)
    same = slots[None, :] == slots[:, None]
    later_wins = (same & (idx[None, :] > idx[:, None]) & valid[None, :]).any(1)
    buf.write(slots, xb, yb, valid & ~later_wins)
    buf.cur += offset
    buf.seen += b


def fused_step(st: State, arch, cfg, xb, yb, draws, follow=None, t=0):
    """One fused ER step with random retrieval and the reservoir update;
    returns (batch loss, gradients)."""
    buf = st.buf
    slots, mask = sample_slots(draws["retrieve"][0]["g"], buf.valid(), cfg["eps_mem_batch"])
    mem_x, mem_y = buf.x[slots], buf.y[slots]
    b = xb.shape[0]
    for p in st.params.values():
        p.requires_grad_(True)
    with torch.enable_grad():
        w = torch.cat([torch.ones_like(yb, dtype=torch.bool), mask])
        lg = M.logits(st.params, st.stats, torch.cat([xb, mem_x]), arch, train=True, w=w)
        loss_b = M.masked_ce(lg[:b], yb)
        loss = loss_b + M.masked_ce(lg[b:], mem_y, mask)
        grads = torch.autograd.grad(loss, list(st.params.values()))
    sgd(st, grads, stacked_form=True)
    reservoir(buf, xb, yb, draws["update"]["u"])
    record_buffer(st)
    return loss_b.detach(), grads

