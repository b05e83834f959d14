"""Fixed-shape episodic memory (counterpart of ocl_tpu/buffer/state.py).

The buffer lives in fixed-shape device tensors that strategies update in
place. `current_index` (slots filled, a prefix) and `n_seen_so_far` are
Python ints: they depend only on batch counts, so branching on them costs no
device sync. Per-class counts are a device tensor kept up to date by
`write_slots`.

The image, label and score tensors hold one extra row past `mem_size`. A
write that is masked off is sent there instead of being dropped (JAX's
scatter mode="drop"), so a masked write needs no host-side compaction; the
row is never read.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ocl_tpu_torch.config import input_size_match, n_classes_match


@dataclass
class BufferState:
    slot_imgs: torch.Tensor     # [mem_size + 1, H, W, C] float32; last row is scratch
    slot_labels: torch.Tensor   # [mem_size + 1] int64; last row is scratch
    slot_score: torch.Tensor    # [mem_size + 1] float32 GSS score; last row is scratch
    class_counts: torch.Tensor  # [n_classes] int64 counts of labels in filled slots
    current_index: int = 0      # slots filled (prefix property)
    n_seen_so_far: int = 0

    @property
    def mem_size(self) -> int:
        return self.slot_labels.shape[0] - 1

    @property
    def imgs(self) -> torch.Tensor:
        return self.slot_imgs[:-1]

    @property
    def labels(self) -> torch.Tensor:
        return self.slot_labels[:-1]

    @property
    def score(self) -> torch.Tensor:
        return self.slot_score[:-1]

    def take(self, idx):
        """(images [k, ...], labels [k]) of slots `idx` [k]."""
        return self.imgs[idx], self.labels[idx]

    def write(self, slot_idx, x, y, write_mask) -> None:
        """write_slots' body (a slot-sharded buffer writes the slots it owns)."""
        mem = self.mem_size
        old_labels = self.slot_labels[slot_idx.clamp(0, mem - 1)]
        was_filled = (slot_idx < self.current_index) & write_mask
        self.class_counts.index_add_(0, old_labels, -was_filled.long())
        self.class_counts.index_add_(0, y, write_mask.long())
        safe_idx = torch.where(write_mask, slot_idx, mem)
        self.slot_imgs[safe_idx] = x
        self.slot_labels[safe_idx] = y

    def write_score(self, slot_idx, values, write_mask=None) -> None:
        """GSS scores `values` into slots `slot_idx` (where `write_mask`)."""
        if write_mask is not None:
            slot_idx = torch.where(write_mask, slot_idx, self.mem_size)
        self.slot_score[slot_idx] = values


def init_buffer(mem_size: int, data: str, device) -> BufferState:
    shape = tuple(input_size_match[data])
    return BufferState(
        slot_imgs=torch.zeros((mem_size + 1,) + shape, device=device),
        slot_labels=torch.zeros((mem_size + 1,), dtype=torch.int64, device=device),
        slot_score=torch.zeros((mem_size + 1,), device=device),
        class_counts=torch.zeros((n_classes_match[data],), dtype=torch.int64, device=device),
    )


def valid_mask(buf: BufferState) -> torch.Tensor:
    """[mem_size] bool — True for filled slots (slots fill as a prefix)."""
    return torch.arange(buf.mem_size, device=buf.slot_labels.device) < buf.current_index


def write_slots(buf: BufferState, slot_idx, x, y, write_mask) -> None:
    """Overwrite slot `slot_idx[i]` with (x[i], y[i]) where write_mask[i], in place.

    Keeps class_counts up to date: the evicted label of a filled slot loses
    one, the incoming label gains one. Masked-off writes change nothing.
    Duplicate slot indices must not occur among masked-on entries
    (strategies guarantee this).
    """
    buf.write(slot_idx, x, y, write_mask)


@dataclass
class StackedBuffer(BufferState):
    """P buffers of one shape as [P, mem_size + 1, ...] tensors (the stacked
    runs and tuner). The counters are shared Python ints: every point sees
    equally sized batches in lockstep, so they agree. `point_view` gives one
    point's BufferState under vmap."""

    @property
    def mem_size(self) -> int:
        return self.slot_labels.shape[1] - 1

    @property
    def imgs(self) -> torch.Tensor:
        return self.slot_imgs[:, :-1]

    @property
    def labels(self) -> torch.Tensor:
        return self.slot_labels[:, :-1]

    @property
    def score(self) -> torch.Tensor:
        return self.slot_score[:, :-1]

    def tensors(self):
        return self.slot_imgs, self.slot_labels, self.slot_score, self.class_counts

    def point_view(self, tensors) -> BufferState:
        """A BufferState over one point's `tensors` (as `tensors()` orders
        them) with these counters."""
        return BufferState(*tensors, current_index=self.current_index,
                           n_seen_so_far=self.n_seen_so_far)

    def point(self, p: int) -> BufferState:
        """Point p's buffer, copied."""
        return self.point_view(tuple(t[p].clone() for t in self.tensors()))


def stack_buffers(bufs) -> StackedBuffer:
    """The buffers `bufs` as one StackedBuffer (copies); their counters must
    agree."""
    counters = {(b.current_index, b.n_seen_so_far) for b in bufs}
    if len(counters) != 1:
        raise ValueError("stacked buffers must agree on their counters, got {}".format(counters))
    return StackedBuffer(*(torch.stack(ts) for ts in zip(
        *((b.slot_imgs, b.slot_labels, b.slot_score, b.class_counts) for b in bufs))),
        current_index=bufs[0].current_index, n_seen_so_far=bufs[0].n_seen_so_far)
