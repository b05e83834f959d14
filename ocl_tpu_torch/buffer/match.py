"""Class-matched retrieval, match and mem_match (counterpart of
ocl_tpu/buffer/match.py; reference utils/buffer/sc_retrieve.py, mem_match.py
and buffer_utils.py:29-48).

After a warmup of `warmup * eps_mem_batch` seen samples, every wanted label
gets one buffered sample of its class, distinct within the class. If a class
has fewer exemplars than it is asked for, the whole retrieval is empty: an
all-False mask, decided on the device. The warmup is a Python-int test.
The picks read every slot's label (a slot-sharded buffer gathers them) and
the rows come through `take`, so a data-parallel step's ranks make the same
picks from the same draws.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ocl_tpu_torch.buffer.retrieve import exclusion_mask, gumbel, random_retrieve, top_k_indices
from ocl_tpu_torch.buffer.state import valid_mask
from ocl_tpu_torch.config import n_classes_match
from ocl_tpu_torch.ops.losses import NEG_INF


def match_labels(buf, n_classes: int, want_y, g, excl_mask=None):
    """One distinct same-class buffer index per entry of `want_y`, from a
    Gumbel top-k per class with noise `g` [n_classes, mem_size].

    Returns (idx [B], ok): `ok` is a bool tensor, False if a class of
    `want_y` has fewer exemplars than its multiplicity.
    """
    batch = want_y.shape[0]
    dev = g.device
    filled = valid_mask(buf)
    if excl_mask is not None:
        filled = filled & ~excl_mask
    elig = (buf.labels[None, :] == torch.arange(n_classes, device=dev)[:, None]) & filled[None, :]
    per_class = top_k_indices(torch.where(elig, g, NEG_INF), batch)   # [C, B]

    onehot = F.one_hot(want_y.long(), n_classes)
    occ_rank = onehot.cumsum(0) - onehot        # rank of each entry within its class
    rank = occ_rank[torch.arange(batch, device=dev), want_y]
    idx = per_class[want_y, rank]
    ok = (elig.sum(1) >= onehot.sum(0)).all()
    return idx, ok


def build_match_retrieve(agent):
    """Draws: "g" [n_classes, mem_size] Gumbel noise (ocl_tpu's rng)."""
    from ocl_tpu_torch.buffer import Strategy

    n_classes = n_classes_match[agent.params.data]
    num_retrieve = int(agent.params.eps_mem_batch)
    warmup = int(agent.params.warmup)
    mem_size = int(agent.params.mem_size)
    device = agent.device

    def draw(generator, batch):
        return {"g": gumbel((n_classes, mem_size), generator, device)}

    def retrieve(model, buf, x, y, draws, grads=None):
        idx, ok = match_labels(buf, n_classes, y, draws["g"])
        warm = buf.n_seen_so_far > num_retrieve * warmup
        mask = (ok & warm).expand(y.shape)
        return (*buf.take(idx), mask)

    return Strategy(draw, retrieve)


def build_mem_match_retrieve(agent):
    """mem_match (reference mem_match.py): random candidates plus a
    class-matched partner for each; the memory batch is the concatenated
    pair. Draws: "g" [mem_size] for the candidates and "match"
    [n_classes, mem_size] for the partners (ocl_tpu's r1, r2)."""
    from ocl_tpu_torch.buffer import Strategy

    n_classes = n_classes_match[agent.params.data]
    num_retrieve = int(agent.params.eps_mem_batch)
    warmup = int(agent.params.warmup)
    mem_size = int(agent.params.mem_size)
    device = agent.device

    def draw(generator, batch):
        return {"g": gumbel((mem_size,), generator, device),
                "match": gumbel((n_classes, mem_size), generator, device)}

    def retrieve(model, buf, x, y, draws, grads=None):
        mem = buf.mem_size
        cx, cy, cidx, cmask = random_retrieve(buf, num_retrieve, draws["g"])
        midx, ok = match_labels(buf, n_classes, cy, draws["match"],
                                excl_mask=exclusion_mask(cidx, cmask, mem))
        warm = buf.n_seen_so_far > num_retrieve * warmup
        mask = cmask & ok & warm
        mx, my = buf.take(midx)
        return torch.cat([cx, mx]), torch.cat([cy, my]), torch.cat([mask, mask])

    return Strategy(draw, retrieve)
