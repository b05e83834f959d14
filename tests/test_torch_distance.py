"""K1 (pairwise_sqdist): the port's plain version against the JAX Pallas
kernel (interpret mode, as tests/test_pallas_ops.py runs it) and numpy.

The CUDA kernel itself runs only on the card (chip_smoke.py compares it with
the plain version there); here the wrapper must take CPU tensors to the plain
version, count no launch, and refuse devices it has no kernel for, and the
launch plan it hands the kernel must cover every output once, fit the card's
limits and match the tiling the CUDA source builds.
"""

import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocl_tpu.ops.pallas.distance import pairwise_sqdist as jax_pairwise_sqdist
from ocl_tpu_torch.ops import _build
from ocl_tpu_torch.ops import distance as dist
from ocl_tpu_torch.ops.distance import pairwise_sqdist, pairwise_sqdist_plain

# rtol/atol 1e-4: fp32 sums of up to 160 products in another order
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n,m,d", [(13, 37, 50), (30, 30, 160), (10, 20, 160), (1, 1, 1)])
def test_plain_matches_pallas_interpret_and_numpy(n, m, d):
    g = np.random.RandomState(n * 1000 + m + d)
    a = g.randn(n, d).astype(np.float32)
    b = g.randn(m, d).astype(np.float32)
    want = ((a[:, None, :].astype(np.float64) - b[None, :, :]) ** 2).sum(-1)
    pallas = np.asarray(jax_pairwise_sqdist(jnp.asarray(a), jnp.asarray(b), force_pallas=True))
    before = pairwise_sqdist.launches
    got = pairwise_sqdist(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert pairwise_sqdist.launches == before  # CPU tensors launch nothing
    assert got.shape == (n, m) and got.dtype == np.float32
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(
        got, pairwise_sqdist_plain(torch.from_numpy(a), torch.from_numpy(b)).numpy())


def test_wrapper_refuses_devices_without_kernel():
    a = torch.zeros(4, 8)
    with pytest.raises(ValueError):
        pairwise_sqdist(a, torch.zeros(4, 8, device="meta"))
    with pytest.raises(ValueError):
        pairwise_sqdist(a.to("meta"), torch.zeros(4, 8, device="meta"))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No nvcc: the build raises instead of falling back."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build("pairwise_sqdist.cu")


def test_library_path_keys_on_source(monkeypatch, tmp_path):
    (tmp_path / "csrc").mkdir()
    src = tmp_path / "csrc" / "k.cu"
    monkeypatch.setattr(_build, "PKG_DIR", tmp_path)
    src.write_text("int x;")
    first = _build.library_path("k.cu")
    src.write_text("int y;")
    assert _build.library_path("k.cu") != first
    assert first.parent == _build.BUILD_DIR


# the ASER shapes (synthetic stream, CIFAR-100, then Mini-ImageNet at D 640
# and CORe50's update at D 2,560), chip_smoke.py's check shapes, and the
# edges: D = 1, 640, 2048, slabs over D and N = M = 1
SLICE_SHAPES = [(30, 30, 160), (10, 20, 160), (20, 20, 160),
                (210, 210, 160), (10, 200, 160), (200, 200, 160),
                (310, 310, 640), (10, 300, 640), (300, 300, 640), (110, 110, 2560)]
PLAN_SHAPES = SLICE_SHAPES + [(13, 37, 50), (7, 5, 3), (1000, 1000, 640), (7, 5, 2048),
                              (3, 5, 4096), (33, 17, 4099), (30, 30, 1), (30, 30, 640),
                              (30, 30, 2048), (1, 1, 160), (1, 1, 1), (1, 210, 160),
                              (210, 1, 160)]
CU_SOURCE = (_build.PKG_DIR / "csrc" / "pairwise_sqdist.cu").read_text()
SMEM_MAX = 232_448     # dynamic shared bytes a block may opt in to on the H100
SMEM_DEFAULT = 49_152  # and may use without opting in


def cu_constant(name):
    """The value of `constexpr int <name> = <int>` in the CUDA source."""
    return int(re.search(r"\b{} = (\d+)".format(name), CU_SOURCE).group(1))


def coverage(plan):
    """How often each output is stored, by the kernel's map from (block, lane
    group) to the group's first row and column."""
    tiles_n = -(-plan.m // plan.block_n)
    groups_n = plan.block_n // plan.tile_n
    block, group = np.divmod(np.arange(plan.grid * plan.threads // plan.lanes),
                             plan.threads // plan.lanes)
    row0 = block // tiles_n * plan.block_m + group // groups_n * plan.tile_m
    col0 = block % tiles_n * plan.block_n + group % groups_n * plan.tile_n
    count = np.zeros((plan.n, plan.m), dtype=np.int64)
    for i in range(plan.tile_m):
        for j in range(plan.tile_n):
            r, c = row0 + i, col0 + j
            keep = (r < plan.n) & (c < plan.m)
            np.add.at(count, (r[keep], c[keep]), 1)
    return count


# both copy widths where 16-byte copies are possible (d % 4 == 0)
@pytest.mark.parametrize("n,m,d,vec", [(n, m, d, vec) for n, m, d in PLAN_SHAPES
                                       for vec in (4, 1) if vec == 1 or d % 4 == 0])
def test_launch_plan_covers_each_output_once_within_limits(n, m, d, vec):
    plan = dist.launch_plan(n, m, d, vec)
    assert (coverage(plan) == 1).all()
    groups = (plan.block_m // plan.tile_m) * (plan.block_n // plan.tile_n)
    assert plan.threads == groups * plan.lanes
    assert groups == plan.block_m + plan.block_n  # one row norm a group
    assert plan.smem_bytes <= SMEM_MAX
    assert plan.opts_in == (plan.smem_bytes > SMEM_DEFAULT)
    assert plan.smem_bytes == 4 * (plan.buffers * dist.ROWS * plan.slab + dist.SUMS)
    assert plan.slab % vec == 0
    if 4 * (dist.ROWS * d + dist.SUMS) <= SMEM_MAX:
        assert (plan.slab, plan.buffers) == (d, 1)  # all of d in one copy round
    else:  # a ring of two slabs, each a whole number of the lanes' steps
        assert plan.buffers == 2 and 0 < plan.slab < d and plan.slab % (plan.lanes * 4) == 0


def test_launch_plan_fills_210x210_in_one_wave():
    for vec in (4, 1):
        plan = dist.launch_plan(210, 210, 160, vec)
        assert plan.waves == 1 and plan.grid <= dist.SMS * dist.BLOCKS_PER_SM


@pytest.mark.parametrize("n,m,d,opts_in,buffers", [
    (30, 30, 160, False, 1), (1000, 1000, 640, False, 1),  # the path; many waves
    (7, 5, 2048, True, 1), (3, 5, 4096, True, 2), (33, 17, 4099, True, 2),
])
def test_check_shapes_reach_the_large_shared_memory_and_the_ring(n, m, d, opts_in, buffers):
    plan = dist.launch_plan(n, m, d, dist.load_width(d, 0, 0))
    assert (plan.opts_in, plan.buffers) == (opts_in, buffers)


@pytest.mark.parametrize("d,a_off,b_off,want", [
    (160, 0, 0, 4), (2048, 0, 0, 4), (640, 16, 48, 4),   # d % 4 == 0, aligned
    (160, 4, 0, 1), (160, 0, 8, 1), (160, 12, 12, 1),   # a row start off 16 bytes
    (50, 0, 0, 1), (3, 0, 0, 1), (1, 0, 0, 1),          # d % 4 != 0
])
def test_load_width_is_4_bytes_exactly_when_d_or_alignment_says(d, a_off, b_off, want):
    assert dist.load_width(d, 4096 + a_off, 8192 + b_off) == want
    plan = dist.launch_plan(30, 30, d, dist.load_width(d, 4096 + a_off, 8192 + b_off))
    assert plan.vec == want


def test_load_width_of_a_view_one_float_into_its_storage():
    a = torch.zeros(30 * 160 + 1)[1:].view(30, 160)
    b = torch.zeros(30, 160)
    assert a.data_ptr() % 16 != 0 and b.data_ptr() % 16 == 0
    assert dist.load_width(160, a.data_ptr(), b.data_ptr()) == 1
    assert dist.load_width(160, b.data_ptr(), b.data_ptr()) == 4


def test_c_struct_matches_launch_plan_fields():
    body = re.search(r"struct LaunchPlan \{(.*?)\};", CU_SOURCE, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    fields = [f.strip() for decl in body.split(";") if decl.strip()
              for f in decl.strip()[len("int"):].split(",")]
    assert fields == list(dist.LaunchPlan._fields)
    assert [f for f, _ in dist.CPlan._fields_] == fields


def test_cuda_source_builds_every_plan_the_wrapper_makes():
    """The plan's tiling is the one the source builds, and the source takes
    both copy widths."""
    assert (dist.BLOCK_M, dist.BLOCK_N) == (cu_constant("kBlockM"), cu_constant("kBlockN"))
    assert (dist.TILE_M, dist.TILE_N) == (cu_constant("kTileM"), cu_constant("kTileN"))
    assert dist.LANES == cu_constant("kLanes")
    assert (dist.SMEM_MAX, dist.SMEM_DEFAULT) == (cu_constant("kSmemMax"),
                                                  cu_constant("kSmemDefault"))
    assert {int(v) for v in re.findall(r"p\.vec == (\d)\) return", CU_SOURCE)} == {4, 1}


def test_c_plan_keeps_its_struct_alive_at_a_stable_address():
    c, addr = dist.c_plan(30, 30, 160, 4)
    assert dist.c_plan(30, 30, 160, 4)[1] == addr == ctypes.addressof(c)
    assert tuple(getattr(c, f) for f in dist.LaunchPlan._fields) == tuple(
        dist.launch_plan(30, 30, 160, 4))


def test_c_plan_address_stays_right_after_its_cache_evicts():
    """A held struct outlives its cache entry, and a plan built again after
    eviction reads its own fields at its own address."""
    held, _ = dist.c_plan(30, 30, 160, 4)
    want = tuple(dist.launch_plan(30, 30, 160, 4))
    for n in range(2, 2 + 2 * dist.c_plan.cache_info().maxsize):
        dist.c_plan(n, 7, 160, 1)
    assert tuple(getattr(held, f) for f in dist.LaunchPlan._fields) == want
    c, addr = dist.c_plan(30, 30, 160, 4)
    assert addr == ctypes.addressof(c)
    got = (ctypes.c_int * len(want)).from_address(addr)
    assert tuple(got) == want


def test_cuda_tensors_never_reach_the_plain_version(monkeypatch):
    def plain(a, b):
        raise AssertionError("the plain version was called")

    monkeypatch.setattr(dist, "pairwise_sqdist_plain", plain)
    a = torch.zeros(4, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        dist.pairwise_sqdist(a, a)
    with pytest.raises(ValueError):
        dist.pairwise_sqdist(torch.zeros(4, 8), a)
