"""Reservoir-sampling buffer update as one vectorized scatter (counterpart of
ocl_tpu/buffer/reservoir.py; reference utils/buffer/reservoir_update.py:8-60).

Fill empty slots sequentially; for overflow items take uniform indices in
[0, n_seen_so_far) (after the fill), keep those < mem_size, and overwrite
with later batch items winning slot collisions (the reference's dict
idx_map). Returns the written slot per item (-1 where the item was dropped).
"""

from __future__ import annotations

import torch

from ocl_tpu_torch.buffer.state import BufferState, write_slots


def reservoir_update(buf: BufferState, x, y, u):
    """In place. `u` [batch] float32 uniforms in [0, 1)."""
    batch = x.shape[0]
    mem = buf.mem_size
    cur, seen = buf.current_index, buf.n_seen_so_far
    dev = u.device

    offset = min(max(0, mem - cur), batch)
    idx = torch.arange(batch, device=dev)
    is_seq = idx < offset
    seq_slots = cur + idx

    # f32 product, then truncation, as ocl_tpu/buffer/reservoir.py:31-32
    # (a Python scalar multiplies a float32 tensor in float32)
    rand_slots = (u * float(seen + offset)).to(torch.int64)

    slots = torch.where(is_seq, seq_slots, rand_slots)
    valid = is_seq | (rand_slots < mem)

    # later batch items win slot collisions (reference idx_map dict semantics)
    same = slots[None, :] == slots[:, None]
    later_wins = (same & (idx[None, :] > idx[:, None]) & valid[None, :]).any(1)
    write = valid & ~later_wins

    write_slots(buf, slots, x, y, write)
    buf.current_index = cur + offset
    buf.n_seen_so_far = seen + batch
    return torch.where(write, slots, -1)
