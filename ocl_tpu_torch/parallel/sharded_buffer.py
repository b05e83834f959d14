"""Slot-sharded memory bank over the ranks (counterpart of
ocl_tpu/parallel/sharded_buffer.py).

ocl_tpu places a BufferState's slot axis across the mesh and lets XLA's
partitioner turn each strategy into per-shard work and collectives. Here a
`ShardedBuffer` is that placement made explicit: rank r holds the images,
labels and GSS scores of slots [r M / W, (r + 1) M / W) (plus the scratch
row a masked write goes to), and `current_index`, `n_seen_so_far` and
`class_counts` are replicated, as ocl_tpu places them. It is one logical
buffer of M slots, and the strategies' code runs on it unchanged:

* `take(idx)` (the slots a retrieval drew, the same on every rank) gives
  every rank the rows: each rank fills the rows it owns, zeros elsewhere,
  and one sum over the ranks assembles them (x + 0 is x, so exactly);
* `labels` and `score` (class-balanced sampling reads every label, GSS every
  score) are gathered from the shards;
* `write` (a reservoir, ASER or GSS replacement, decided alike on every rank
  from the same draws and the whole incoming batch) writes the slots this
  rank owns; `class_counts` takes the evicted labels' counts, summed over
  the ranks, and the incoming labels' alike on every rank.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from ocl_tpu_torch.buffer.state import BufferState
from ocl_tpu_torch.parallel.mesh import Mesh


@dataclass
class ShardedBuffer(BufferState):
    """This rank's shard of a slot-sharded buffer of `total` slots."""

    mesh: Mesh | None = field(default=None, repr=False)
    total: int = 0

    @property
    def mem_size(self) -> int:
        return self.total

    @property
    def lo(self) -> int:
        return self.mesh.rank * (self.total // self.mesh.size)

    @property
    def owned(self) -> int:
        return self.slot_labels.shape[0] - 1

    def owns(self, idx):
        return (idx >= self.lo) & (idx < self.lo + self.owned)

    def _local(self, idx):
        """Local row of slot idx, or the scratch row where this rank does not
        own it."""
        return torch.where(self.owns(idx), idx - self.lo, self.owned)

    @property
    def imgs(self) -> torch.Tensor:
        return self.mesh.all_gather(self.slot_imgs[:-1])

    @property
    def labels(self) -> torch.Tensor:
        return self.mesh.all_gather(self.slot_labels[:-1])

    @property
    def score(self) -> torch.Tensor:
        return self.mesh.all_gather(self.slot_score[:-1])

    def own_rows(self):
        """(images, labels, validity) of the slots this rank holds."""
        valid = torch.arange(self.lo, self.lo + self.owned,
                             device=self.slot_labels.device) < self.current_index
        return self.slot_imgs[:-1], self.slot_labels[:-1], valid

    def take(self, idx):
        own = self.owns(idx)
        local = self._local(idx)
        x = torch.where(own.reshape(-1, *(1,) * (self.slot_imgs.dim() - 1)),
                        self.slot_imgs[local], 0.0)
        y = torch.where(own, self.slot_labels[local], 0)
        return self.mesh.all_reduce_(x), self.mesh.all_reduce_(y)

    def write(self, slot_idx, x, y, write_mask) -> None:
        own = self.owns(slot_idx) & write_mask
        local = torch.where(own, slot_idx - self.lo, self.owned)
        was_filled = (slot_idx < self.current_index) & own
        evicted = torch.zeros_like(self.class_counts).index_add_(
            0, self.slot_labels[local], -was_filled.long())
        self.class_counts += self.mesh.all_reduce_(evicted)
        self.class_counts.index_add_(0, y, write_mask.long())
        self.slot_imgs[local] = x
        self.slot_labels[local] = y

    def write_score(self, slot_idx, values, write_mask=None) -> None:
        own = self.owns(slot_idx)
        if write_mask is not None:
            own = own & write_mask
        self.slot_score[torch.where(own, slot_idx - self.lo, self.owned)] = values


def shard_buffer(buf: BufferState, mesh: Mesh) -> ShardedBuffer:
    """This rank's shard of `buf` (whole and alike on every rank): slots
    [r M / W, (r + 1) M / W) copied, the counters and class counts
    replicated. M must be a multiple of W."""
    total = buf.mem_size
    s = mesh.rows(total, "buffer slots")

    def part(t):
        return torch.cat([t[s], t[-1:]]).clone()

    return ShardedBuffer(part(buf.slot_imgs), part(buf.slot_labels), part(buf.slot_score),
                         buf.class_counts.clone(), buf.current_index, buf.n_seen_so_far,
                         mesh=mesh, total=total)


def gather_buffer(sbuf: ShardedBuffer) -> BufferState:
    """The whole buffer, on every rank (what the tests and chip_smoke.py read)."""
    def whole(t):
        return torch.cat([sbuf.mesh.all_gather(t[:-1]), t[-1:]])

    return BufferState(whole(sbuf.slot_imgs), whole(sbuf.slot_labels), whole(sbuf.slot_score),
                       sbuf.class_counts.clone(), sbuf.current_index, sbuf.n_seen_so_far)
