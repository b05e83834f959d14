"""Replays a cell's first steps through the reference (er.py), point by
point, from the benchmark's own start: its weights, the buffer it filled,
the batches and the draws of each step. Returns a record in the layout the
program's side makes (judge.py), and the judge's numbers where a program
record is given to follow. Imports torch and this package.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch

from oclbench.reference import er
from oclbench.reference import model as M
from oclbench.reference.judge import Follow


@dataclass
class Start:
    """What every side starts from: `weights` a dict of leaves per lane,
    `buffer` (x [mem + 1, ...], y [mem + 1], cur, seen) shared by every
    point (copied per point), `points` [(lane, lr, wd)], and `steps`
    [(xb, yb, draws by lane)]."""
    weights: list
    buffer: tuple
    points: list
    steps: list


@contextlib.contextmanager
def precision(tf32: bool):
    """fp32 with TF32 off (the configuration's precision), or TF32 on (the
    nearest precision below it) for a control."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def point_record(rec, p):
    """Point p's share of a [P]-stacked record, as one point's record."""
    out = {"buffer": [(f[p], y[p], c[p]) for f, y, c in rec["buffer"]]}
    if "retrieved" in rec:
        out["retrieved"] = rec["retrieved"]
    return out


def leaf_norms(tensors):
    return torch.stack([t.double().norm() for t in tensors]).cpu()


def ulps(t):
    """The fp32 spacing at each element of t."""
    a = t.abs()
    return torch.nextafter(a, torch.full_like(a, torch.inf)) - a


def replay(step_fn, arch, cfg, start: Start, prog=None, tf32=False):
    """The reference's record of `start`'s steps for every point under the
    reference step `step_fn` (er.py's signature); with a program record
    `prog` to follow, also (picks, exact) of the judge."""
    names = [n for n, _, _, _ in M.leaves(arch)]
    losses, grad1, change1, change, spacing, bufs, retrieved = [], [], [], [], [], [], None
    picks, exact = 0.0, 0
    bx, by, cur, seen = start.buffer
    with precision(tf32):
        for p, (lane, lr, wd) in enumerate(start.points):
            w0 = start.weights[lane]
            st = er.State(params={n: w0[n].clone() for n in names},
                          stats=M.init_running(arch, bx.device),
                          buf=er.Buffer(bx.clone(), by.clone(), arch["classes"], cur, seen),
                          lr=lr, wd=wd)
            follow = Follow(point_record(prog, p)) if prog is not None else None
            point_losses = []
            for t, (xb, yb, draws) in enumerate(start.steps):
                loss, grads = step_fn(st, arch, cfg, xb, yb, draws[lane], follow, t)
                point_losses.append(float(loss))
                if t == 0:
                    grad1.append(leaf_norms(grads))
                    change1.append(leaf_norms([st.params[n].detach() - w0[n] for n in names]))
            change.append(leaf_norms([st.params[n].detach() - w0[n] for n in names]))
            spacing.append(leaf_norms([ulps(w0[n]) for n in names]))
            losses.append(point_losses)
            bufs.append(st.record["buffer"])
            if "retrieved" in st.record:
                retrieved = st.record["retrieved"]
            if follow is not None:
                picks, exact = max(picks, follow.picks), exact + follow.exact
            del st
    rec = {"loss": torch.tensor(losses, dtype=torch.float64).T,
           "grad1": torch.stack(grad1), "change1": torch.stack(change1),
           "change3": torch.stack(change),
           "spacing": torch.stack(spacing),
           "buffer": [tuple(torch.stack([b[t][i] for b in bufs]) for i in range(3))
                      for t in range(len(start.steps))]}
    if retrieved is not None:
        rec["retrieved"] = retrieved
    return rec, picks, exact
