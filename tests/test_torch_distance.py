"""K1 (pairwise_sqdist): the port's plain version against the JAX Pallas
kernel (interpret mode, as tests/test_pallas_ops.py runs it) and numpy.

The CUDA kernel itself runs only on the card (chip_smoke.py compares it with
the plain version there); here the wrapper must take CPU tensors to the plain
version, count no launch, and refuse devices it has no kernel for.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocl_tpu.ops.pallas.distance import pairwise_sqdist as jax_pairwise_sqdist
from ocl_tpu_torch.ops import _build
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
