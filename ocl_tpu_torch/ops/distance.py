"""Pairwise squared euclidean distance: a hand-written CUDA kernel and its
plain torch version.

Replaces the Pallas TPU kernel `_kernel` of ocl_tpu/ops/pallas/distance.py
(launched by `_pairwise_sqdist_pallas`, dispatched by `pairwise_sqdist`). The
CUDA source is ocl_tpu_torch/csrc/pairwise_sqdist.cu; it computes
|a_i|^2 + |b_j|^2 - 2 a_i.b_j with fp32 accumulation (no TF32, no tensor
cores) and masks ragged edges itself. Its caller is the ASER KNN-SV scoring,
at <= 210 x 210 x 160 (at most 14.2 MFLOP): on the H100 it is bound by launch
and memory latency, not by FLOPs or bytes. Its launch plan (one tiling, the
copy width, the slabs over D and the shared bytes) is computed here, in
`launch_plan`, and passed to the C entry.

`pairwise_sqdist` takes a CPU tensor to `pairwise_sqdist_plain` and launches
the kernel on a CUDA tensor, or raises. Under `torch.func.vmap` (the stacked
runs and tuner of experiment/parallel_run.py) it goes through the custom op
`ocl_tpu_torch::pairwise_sqdist`, whose vmap rule calls
`pairwise_sqdist_batched`: one launch over a point axis, [P, N, D] x
[P, M, D] -> [P, N, M], as Pallas batches `pallas_call` under `jax.vmap` by
adding a grid dimension. On CPU tensors the batched call is
`pairwise_sqdist_plain_batched`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ocl_tpu_torch.ops._build import load_library

SMS = 132                 # streaming multiprocessors of an H100 SXM
# the one tiling, the constants of csrc/pairwise_sqdist.cu: a block owns
# BLOCK_M x BLOCK_N outputs, a group of LANES lanes a TILE_M x TILE_N tile of them
BLOCK_M, BLOCK_N = 8, 8
TILE_M, TILE_N = 2, 2
LANES = 8
THREADS = (BLOCK_M // TILE_M) * (BLOCK_N // TILE_N) * LANES
ROWS = BLOCK_M + BLOCK_N  # rows of a and b a block copies into shared memory
SUMS = ROWS               # floats of shared memory for the block's row norms
SMEM_MAX = 232_448        # dynamic shared bytes a block may opt in to
SMEM_DEFAULT = 49_152     # and may use without opting in
# blocks of the plan's kernel an SM holds at once at d = 160 (at least);
# chip_smoke.py holds it against CUDA's occupancy calculator on the card
BLOCKS_PER_SM = 8
MAX_GRID = 2**31 - 1      # blocks of a point (gridDim.x)
MAX_POINTS = 65_535       # points of a batched launch (gridDim.y)


class LaunchPlan(NamedTuple):
    """One launch of the kernel; the C entry reads these fields, in this
    order, as its struct LaunchPlan."""
    n: int
    m: int
    d: int
    block_m: int          # outputs of a block
    block_n: int
    tile_m: int           # outputs of a lane group
    tile_n: int
    lanes: int            # lanes of a group: they split d
    vec: int              # floats one copy moves: 4 (16 bytes) or 1
    slab: int             # floats of each row a copy round brings
    buffers: int          # 1: all of d in one round; 2: a ring of two slabs
    threads: int
    grid: int             # blocks of one point
    smem_bytes: int       # dynamic shared memory of a block
    points: int = 1       # independent products of one launch, one grid row each

    @property
    def waves(self) -> int:
        """Waves of blocks on the card, at BLOCKS_PER_SM blocks an SM."""
        return -(-self.grid * self.points // (SMS * BLOCKS_PER_SM))

    @property
    def opts_in(self) -> bool:
        """Whether the block takes more shared memory than CUDA's default."""
        return self.smem_bytes > SMEM_DEFAULT


class CPlan(ctypes.Structure):
    _fields_ = [(name, ctypes.c_int) for name in LaunchPlan._fields]


def load_width(d, *ptrs):
    """4 floats (16-byte copies) when d % 4 == 0 and every row start is
    16-byte aligned, else 1 (4-byte copies)."""
    return 4 if d % 4 == 0 and all(p % 16 == 0 for p in ptrs) else 1


def launch_plan(n, m, d, vec, points=1) -> LaunchPlan:
    """The launch of `points` [n, d] x [m, d] products with copy width `vec`:
    one block per BLOCK_M x BLOCK_N outputs of a point, dealt row by row, one
    row of the grid a point. Its rows over all of d go into shared memory in
    one round where they fit under SMEM_MAX, else d is walked in slabs (a
    multiple of LANES vectors) through a ring of two."""
    grid = -(-n // BLOCK_M) * -(-m // BLOCK_N)
    if grid > MAX_GRID:
        raise ValueError("pairwise_sqdist: {} x {} outputs need {} > {} blocks".format(
            n, m, grid, MAX_GRID))
    if not 1 <= points <= MAX_POINTS:
        raise ValueError("pairwise_sqdist: {} points, the grid takes 1 to {}".format(
            points, MAX_POINTS))
    if 4 * (ROWS * d + SUMS) <= SMEM_MAX:
        slab, buffers = d, 1
    else:
        step = LANES * 4
        slab, buffers = (SMEM_MAX // 4 - SUMS) // (2 * ROWS) // step * step, 2
    return LaunchPlan(n, m, d, BLOCK_M, BLOCK_N, TILE_M, TILE_N, LANES, vec, slab, buffers,
                      THREADS, grid, 4 * (buffers * ROWS * slab + SUMS), points)


@functools.lru_cache(maxsize=256)
def c_plan(n, m, d, vec, points=1) -> tuple[CPlan, int]:
    """`launch_plan(n, m, d, vec, points)` as the C entry reads it, and its
    address. One cache entry holds both; a caller keeps the struct while the
    C entry reads it, so an eviction cannot free it under the call."""
    c = CPlan(*launch_plan(n, m, d, vec, points))
    return c, ctypes.addressof(c)


def pairwise_sqdist_plain(a, b):
    """[N, M] squared distances; the torch expression of ocl_tpu's
    `_pairwise_sqdist_jnp` (ocl_tpu/ops/pallas/distance.py:56-59)."""
    a2 = (a * a).sum(1, keepdim=True)
    b2 = (b * b).sum(1, keepdim=True)
    return a2 + b2.T - 2.0 * (a @ b.T)


def pairwise_sqdist_plain_batched(a, b):
    """[P, N, M]: `pairwise_sqdist_plain` of each point of a [P, N, D] and
    b [P, M, D], as one batched expression."""
    a2 = (a * a).sum(-1, keepdim=True)
    b2 = (b * b).sum(-1, keepdim=True)
    return a2 + b2.transpose(-1, -2) - 2.0 * (a @ b.transpose(-1, -2))


def _check(a, b, dims=2):
    dev = a.device
    if dev != b.device:
        raise ValueError("pairwise_sqdist: a on {}, b on {}".format(dev, b.device))
    if dev.type != "cuda":
        raise ValueError("pairwise_sqdist: no kernel for device {}".format(dev))
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError("pairwise_sqdist: float32 only, got {} and {}".format(a.dtype, b.dtype))
    if a.dim() != dims or b.dim() != dims:
        raise ValueError("pairwise_sqdist: {}-D inputs only, got {}-D and {}-D".format(
            dims, a.dim(), b.dim()))
    if a.shape[-1] != b.shape[-1]:
        raise ValueError("pairwise_sqdist: feature dims differ, {} and {}".format(
            a.shape[-1], b.shape[-1]))
    if a.shape[:-2] != b.shape[:-2]:
        raise ValueError("pairwise_sqdist: point counts differ, {} and {}".format(
            a.shape[0], b.shape[0]))
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("pairwise_sqdist: inputs must be contiguous")
    return dev


def _is_batched(t):
    return torch._C._functorch.is_batchedtensor(t)


def pairwise_sqdist(a, b):
    """[N, M] squared distances between the rows of a [N, D] and b [M, D].

    CPU tensors take the plain version; CUDA tensors launch the kernel on the
    current stream (counted in `pairwise_sqdist.launches`) or raise. Under
    `torch.func.vmap` the call goes to the custom op, whose vmap rule makes
    one batched call for all points."""
    if _is_batched(a) or _is_batched(b):
        return _pairwise_sqdist_op(a, b)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return pairwise_sqdist_plain(a, b)
    dev = _check(a, b)
    n, d = a.shape
    m = b.shape[0]
    out = torch.empty((n, m), device=dev, dtype=torch.float32)
    if n == 0 or m == 0:
        return out
    return _launch(a, b, out, n, m, d, 1)


def pairwise_sqdist_batched(a, b):
    """[P, N, M] squared distances between the rows of a [P, N, D] and
    b [P, M, D], point by point, in one launch (counted once in
    `pairwise_sqdist.launches`). CPU tensors take
    `pairwise_sqdist_plain_batched`; CUDA tensors launch the kernel with a
    point axis or raise."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return pairwise_sqdist_plain_batched(a, b)
    dev = _check(a, b, dims=3)
    p, n, d = a.shape
    m = b.shape[1]
    out = torch.empty((p, n, m), device=dev, dtype=torch.float32)
    if p == 0 or n == 0 or m == 0:
        return out
    return _launch(a, b, out, n, m, d, p)


def _launch(a, b, out, n, m, d, points):
    dev = a.device
    a_ptr, b_ptr = a.data_ptr(), b.data_ptr()
    # `c` stays alive over the call
    c, plan = c_plan(n, m, d, load_width(d, a_ptr, b_ptr), points)
    lib = load_library("pairwise_sqdist.cu")
    if dev.index == torch.cuda.current_device():
        # the raw stream pointer, without building a torch.cuda.Stream per call
        err = lib.ocl_pairwise_sqdist_f32(a_ptr, b_ptr, out.data_ptr(), plan,
                                          torch._C._cuda_getCurrentRawStream(dev.index))
    else:
        with torch.cuda.device(dev):
            err = lib.ocl_pairwise_sqdist_f32(a_ptr, b_ptr, out.data_ptr(), plan,
                                              torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("pairwise_sqdist kernel launch failed: CUDA error {}".format(err))
    pairwise_sqdist.launches += 1
    return out


pairwise_sqdist.launches = 0


@torch.library.custom_op("ocl_tpu_torch::pairwise_sqdist", mutates_args=())
def _pairwise_sqdist_op(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`pairwise_sqdist` as an operator, so that vmap can batch it."""
    return pairwise_sqdist(a, b)


@_pairwise_sqdist_op.register_vmap
def _pairwise_sqdist_vmap(info, in_dims, a, b):
    """One batched call for all points; an unbatched operand is broadcast."""
    def points_first(t, dim):
        if dim is None:
            return t.expand(info.batch_size, *t.shape).contiguous()
        return t.movedim(dim, 0).contiguous()

    return pairwise_sqdist_batched(points_first(a, in_dims[0]), points_first(b, in_dims[1])), 0
