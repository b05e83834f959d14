"""ASER on the port against ocl_tpu: `knn_sv` (with masks, and against the
numpy oracle of tests/test_knn_sv.py), and the ASER update and retrieval for
every aser_type on a full 40-slot buffer. Both packages get the same
weights, statistics, batch and random draws (rebuilt from ocl_tpu's key
splits, ocl_tpu/buffer/aser.py:44 and :130), so the written slots, labels,
class_counts and the retrieved rows must be equal exactly.

Many SVs are equal in exact arithmetic, and ASER's stable top-k then orders
them by rounding alone, so the exact comparisons run the port with XLA's
order of additions on the CPU (`xla_summation_order`).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocl_tpu.buffer.aser import build_aser_retrieve as j_build_aser_retrieve
from ocl_tpu.buffer.aser import build_aser_update as j_build_aser_update
from ocl_tpu.config import default_params as j_default_params
from ocl_tpu.models.resnet import Reduced_ResNet18 as JReducedResNet18
from ocl_tpu.ops.knn_sv import knn_sv as j_knn_sv
import ocl_tpu_torch.buffer.aser as port_aser
import ocl_tpu_torch.ops.knn_sv as port_knn_sv
from ocl_tpu_torch.buffer.aser import build_aser_retrieve, build_aser_update
from ocl_tpu_torch.config import default_params
from ocl_tpu_torch.ops.knn_sv import knn_sv
from test_knn_sv import np_knn_sv
from test_torch_buffer import MEM, N_CLS, assert_buffers_equal, batch, make_buffers
from test_torch_model import port_model, random_weights

NF = 4
ASER_HP = dict(data="synthetic", mem_size=MEM, k=3, n_smp_cls=2.0, eps_mem_batch=10)


def _t(a):
    return torch.tensor(np.asarray(a))


def _seq_scan(v, dim):
    """Inclusive scan along `dim`, adding one term after another in fp32."""
    parts = v.unbind(dim)
    acc, out = parts[0], [parts[0]]
    for p in parts[1:]:
        acc = acc + p
        out.append(acc)
    return torch.stack(out, dim)


def _xla_cumsum(v, block=16):
    """cumsum along the last axis of v [r, n] in XLA:CPU's order: its
    reduce-window rewrite scans blocks of 16 one term after another, then
    adds the scanned block totals."""
    r, n = v.shape
    if n <= block:
        return _seq_scan(v, 1)
    nb = -(-n // block)
    padded = torch.cat([v, v.new_zeros(r, nb * block - n)], 1).reshape(r, nb, block)
    inner = _seq_scan(padded, 2)
    before = _xla_cumsum(inner[:, :, -1], block)
    before = torch.cat([v.new_zeros(r, 1), before[:, :-1]], 1)
    return (inner + before[:, :, None]).reshape(r, -1)[:, :n]


def xla_summation_order(monkeypatch):
    """Run the port's SV sums in XLA:CPU's order of additions: rows one after
    another (exact for up to 30 rows, as here), and cumsum as above."""
    def reverse_cumsum(v):
        return torch.flip(_xla_cumsum(torch.flip(v, dims=[1])), dims=[1])

    def sum_rows(sv):
        return _seq_scan(sv, 0)[-1]

    monkeypatch.setattr(port_knn_sv, "reverse_cumsum", reverse_cumsum)
    monkeypatch.setattr(port_knn_sv, "sum_rows", sum_rows)
    monkeypatch.setattr(port_aser, "sum_rows", sum_rows)


def test_xla_summation_order_matches_xla():
    g = np.random.RandomState(3)
    for n in (5, 16, 17, 30, 40):
        v = (g.randn(4, n) * 10).astype(np.float32)
        want = np.asarray(jnp.flip(jnp.cumsum(jnp.flip(jnp.asarray(v), 1), axis=1), 1))
        got = torch.flip(_xla_cumsum(torch.flip(torch.from_numpy(v), dims=[1])), dims=[1])
        np.testing.assert_array_equal(got.numpy(), want)
        rows = (g.randn(min(n, 30), 20) * 10).astype(np.float32)
        np.testing.assert_array_equal(_seq_scan(torch.from_numpy(rows), 0)[-1].numpy(),
                                      np.asarray(jnp.sum(jnp.asarray(rows), axis=0)))


@pytest.mark.parametrize("seed", [0, 1])
def test_knn_sv_matches_jax_and_numpy(seed):
    g = np.random.RandomState(seed)
    ef, cf = g.randn(9, 16).astype(np.float32), g.randn(14, 16).astype(np.float32)
    ey, cy = g.randint(0, 3, 9), g.randint(0, 3, 14)
    em = np.array([1] * 7 + [0] * 2, bool)
    cm = np.array([1] * 11 + [0] * 3, bool)
    want = np.asarray(j_knn_sv(jnp.asarray(ef), jnp.asarray(ey), jnp.asarray(em),
                               jnp.asarray(cf), jnp.asarray(cy), jnp.asarray(cm), 3))
    got = knn_sv(*map(torch.from_numpy, (ef, ey, em, cf, cy, cm)), 3).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the valid block is the dynamically shaped reference result
    oracle = np_knn_sv(ef[:7], ey[:7], cf[:11], cy[:11], k=3)
    np.testing.assert_allclose(got[:7, :11], oracle, rtol=1e-5, atol=1e-5)
    assert (got[7:] == 0).all() and (got[:, 11:] == 0).all()


@pytest.fixture(scope="module")
def weights():
    params, stats = random_weights(11)
    return JReducedResNet18(10, nf=NF), params, stats


def _agents(module, aser_type):
    j_agent = SimpleNamespace(module=module, params=j_default_params(
        nf=NF, aser_type=aser_type, **ASER_HP))
    t_agent = SimpleNamespace(device=torch.device("cpu"), params=default_params(
        nf=NF, aser_type=aser_type, device="cpu", **ASER_HP))
    return j_agent, t_agent


def _batch(seed):
    # classes 0-2 are rare in the buffer below, so some inputs are minority
    return batch(seed, n_classes=3)


def _skewed_buffers(seed):
    labels = np.random.RandomState(seed).randint(3, N_CLS, MEM)
    labels[:2] = [0, 1]
    return make_buffers(MEM, MEM, 100, seed=seed, labels=labels)


@pytest.mark.parametrize("seed", [0, 1])
def test_aser_update(weights, seed, monkeypatch):
    xla_summation_order(monkeypatch)
    module, params, stats = weights
    j_agent, t_agent = _agents(module, "asvm")
    jbuf, tbuf = _skewed_buffers(seed + 20)
    before = tbuf.labels.clone(), tbuf.imgs.clone()
    x, y = _batch(seed + 30)
    key = jax.random.PRNGKey(seed)

    j_update = jax.jit(j_build_aser_update(j_agent))
    jbuf, _ = j_update(params, stats, jbuf, jnp.asarray(x), jnp.asarray(y), key)
    r_thr, r_eval, r_cand, _ = jax.random.split(key, 4)
    draws = {"thr": _t(jax.random.uniform(r_thr, ())),
             "eval": _t(jax.random.gumbel(r_eval, (N_CLS, MEM))),
             "cand": _t(jax.random.gumbel(r_cand, (MEM,)))}
    build_aser_update(t_agent).run(port_model(params, stats), tbuf,
                                   torch.from_numpy(x), torch.from_numpy(y), draws)
    assert_buffers_equal(jbuf, tbuf)
    assert not (torch.equal(tbuf.labels, before[0]) and torch.equal(tbuf.imgs, before[1]))


@pytest.mark.parametrize("aser_type", ["asvm", "asv", "neg_sv"])
def test_aser_retrieve(weights, aser_type, monkeypatch):
    xla_summation_order(monkeypatch)
    module, params, stats = weights
    j_agent, t_agent = _agents(module, aser_type)
    j_retrieve = jax.jit(j_build_aser_retrieve(j_agent))
    t_retrieve = build_aser_retrieve(t_agent)
    model = port_model(params, stats)
    x, y = _batch(40)
    for n_seen in (MEM, 100):  # random path while n_seen <= mem_size, then SV
        jbuf, tbuf = _skewed_buffers(50)
        jbuf = jbuf.replace(n_seen_so_far=jnp.asarray(n_seen, jnp.int32))
        tbuf.n_seen_so_far = n_seen
        key = jax.random.PRNGKey(n_seen)
        j_x, j_y, j_mask, _ = j_retrieve(params, stats, jbuf, jnp.asarray(x), jnp.asarray(y),
                                         None, key)
        r_rand, r_cand, r_coop = jax.random.split(key, 3)
        draws = {"rand": _t(jax.random.gumbel(r_rand, (MEM,))),
                 "cand": _t(jax.random.gumbel(r_cand, (N_CLS, MEM))),
                 "coop": _t(jax.random.gumbel(r_coop, (N_CLS, MEM)))}
        t_x, t_y, t_mask = t_retrieve.run(model, tbuf, torch.from_numpy(x),
                                          torch.from_numpy(y), draws)
        np.testing.assert_array_equal(t_mask.numpy(), np.asarray(j_mask))
        np.testing.assert_array_equal(t_y.numpy(), np.asarray(j_y))
        np.testing.assert_array_equal(t_x.numpy(), np.asarray(j_x))
