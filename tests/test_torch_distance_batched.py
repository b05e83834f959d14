"""K1 (pairwise_sqdist) with a point axis: the batched plain version, the
vmap rule that takes the stacked runs' calls to one batched call, and the
batched launch plan.

The batched CUDA launch runs only on the card (chip_smoke.py phase 21 holds
it against `pairwise_sqdist_plain_batched` at P in {1, 3, 84}); here the
batched wrapper must take CPU tensors to the plain version and count no
launch, refuse devices it has no kernel for, and its plan must give every
point one grid row over the single-point tiling, within the grid's limits.
"""

import re

import pytest
import torch

from ocl_tpu_torch.ops import _build
from ocl_tpu_torch.ops import distance as dist
from ocl_tpu_torch.ops.distance import (
    pairwise_sqdist,
    pairwise_sqdist_batched,
    pairwise_sqdist_plain,
    pairwise_sqdist_plain_batched,
)

CU_SOURCE = (_build.PKG_DIR / "csrc" / "pairwise_sqdist.cu").read_text()
# the synthetic stream's ASER shapes, the CIFAR-100 update's, and edges
SHAPES = [(30, 30, 160), (10, 20, 160), (20, 20, 160), (210, 210, 160), (7, 5, 3), (1, 1, 1)]


def _inputs(p, n, m, d, seed=0):
    g = torch.Generator().manual_seed(seed + p * 1000 + n * 10 + m)
    return torch.randn(p, n, d, generator=g), torch.randn(p, m, d, generator=g)


@pytest.mark.parametrize("p", [1, 3, 84])
@pytest.mark.parametrize("n,m,d", SHAPES)
def test_plain_batched_equals_a_call_a_point(p, n, m, d):
    """Each point's [N, M] block equals pairwise_sqdist_plain of that point
    (rtol 1e-6: bmm and mm may block their sums differently), with an exact
    zero diagonal for a point against itself."""
    a, b = _inputs(p, n, m, d)
    got = pairwise_sqdist_plain_batched(a, b)
    assert got.shape == (p, n, m) and got.dtype == torch.float32
    for i in range(p):
        torch.testing.assert_close(got[i], pairwise_sqdist_plain(a[i], b[i]),
                                   rtol=1e-6, atol=1e-5)
    before = pairwise_sqdist.launches
    assert torch.equal(pairwise_sqdist_batched(a, b), got)
    assert pairwise_sqdist.launches == before   # CPU tensors launch nothing


@pytest.mark.parametrize("in_dims", [(0, 0), (0, None), (None, 0)])
def test_vmap_takes_the_batched_version(monkeypatch, in_dims):
    """torch.func.vmap(pairwise_sqdist) on CPU tensors makes one batched call
    (the custom op's vmap rule), an unbatched operand broadcast to every
    point, and returns the plain batched result."""
    calls = []

    def spy(a, b):
        calls.append((tuple(a.shape), tuple(b.shape)))
        return pairwise_sqdist_plain_batched(a, b)

    monkeypatch.setattr(dist, "pairwise_sqdist_batched", spy)
    a, b = _inputs(3, 30, 20, 160)
    args = [a if in_dims[0] == 0 else a[0], b if in_dims[1] == 0 else b[0]]
    got = torch.func.vmap(pairwise_sqdist, in_dims=in_dims)(*args)
    assert calls == [((3, 30, 160), (3, 20, 160))]
    want = pairwise_sqdist_plain_batched(*(t if t.dim() == 3 else t.expand(3, *t.shape)
                                           for t in args))
    assert torch.equal(got, want)


def test_vmap_inside_a_function_with_sorts_and_masks():
    """The KNN-SV pattern under vmap: distances, a masked fill, a stable
    sort, as ops/knn_sv.py takes them."""
    a, b = _inputs(4, 12, 9, 16)
    mask = torch.arange(9) < 7

    def f(x, y):
        d = torch.where(mask[None, :], pairwise_sqdist(x, y), torch.inf)
        return torch.sort(d, dim=1, stable=True).indices

    got = torch.func.vmap(f)(a, b)
    for i in range(4):
        assert torch.equal(got[i], f(a[i], b[i]))


def test_batched_wrapper_refuses_devices_without_kernel(monkeypatch):
    def plain(a, b):
        raise AssertionError("the plain version was called")

    monkeypatch.setattr(dist, "pairwise_sqdist_plain_batched", plain)
    a = torch.zeros(2, 4, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        pairwise_sqdist_batched(a, a)
    with pytest.raises(ValueError):
        pairwise_sqdist_batched(torch.zeros(2, 4, 8), a)


@pytest.mark.parametrize("n,m,d", SHAPES)
@pytest.mark.parametrize("points", [1, 3, 84])
def test_batched_plan_is_the_single_plan_with_a_row_a_point(n, m, d, points):
    vec = dist.load_width(d, 0, 0)
    one = dist.launch_plan(n, m, d, vec)
    plan = dist.launch_plan(n, m, d, vec, points)
    assert plan._replace(points=1) == one
    assert plan.points == points and plan.grid == one.grid
    assert plan.waves == -(-one.grid * points // (dist.SMS * dist.BLOCKS_PER_SM))
    c, _ = dist.c_plan(n, m, d, vec, points)
    assert c.points == points and c.grid == one.grid


def test_batched_plan_bounds_its_grid():
    with pytest.raises(ValueError, match="points"):
        dist.launch_plan(30, 30, 160, 4, 0)
    with pytest.raises(ValueError, match="points"):
        dist.launch_plan(30, 30, 160, 4, dist.MAX_POINTS + 1)
    assert dist.launch_plan(30, 30, 160, 4, dist.MAX_POINTS).points == dist.MAX_POINTS


def test_cuda_source_launches_a_grid_row_a_point():
    """The C entry takes the plan's points as gridDim.y, the kernel offsets
    a, b and out by the point's strides, and the entry refuses a plan with
    more points than the grid holds."""
    assert re.search(r"kernel<<<dim3\(p\.grid, p\.points\)", CU_SOURCE)
    for ptr, stride in (("a", "n \\* d"), ("b", "m \\* d"), ("out", "n \\* m")):
        assert re.search(r"\b{} \+= point \* {};".format(ptr, stride), CU_SOURCE)
    assert int(re.search(r"kMaxPoints = (\d+)", CU_SOURCE).group(1)) == dist.MAX_POINTS
