"""MIR, match, mem_match and GSS on the port against ocl_tpu's strategies,
from the same weights, BN statistics, buffer, batch and random draws (rebuilt
from ocl_tpu's key splits: mir.py:32, match.py:33 and :74, gss.py:100).

Retrieved rows, labels, masks and buffer slots must be equal exactly; BN
statistics after MIR's scoring forward at rtol 1e-3 / atol 1e-5, GSS scores
at rtol 1e-3 / atol 1e-4 (fp32, another order of reduction).

GSS scores are cosines of single-sample gradients. At nf 4 a ReLU input of
one image may sit within 2e-6 of zero, and XLA and torch then put it on
opposite sides, which moves that image's gradient by up to ~0.2 in thousands
of entries. The keys here draw bank batches clear of such images.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad

from ocl_tpu.agents.er import ExperienceReplay as JExperienceReplay
from ocl_tpu.config import default_params as j_default_params
from ocl_tpu_torch import interop
from ocl_tpu_torch.agents.er import ExperienceReplay
from ocl_tpu_torch.buffer.gss import _cosine_rows
from ocl_tpu_torch.config import default_params
from test_torch_buffer import MEM, N_CLS, assert_buffers_equal, class_images, make_buffers
from test_torch_model import port_model, random_weights

NF = 4
HP = dict(agent="ER", data="synthetic", mem_size=MEM, eps_mem_batch=10, batch=10,
          learning_rate=0.1, nf=NF, verbose=False)
STATS_TOL = dict(rtol=1e-3, atol=1e-5)


def _t(a):
    return torch.tensor(np.asarray(a))


_JAX = {}


def _agents(**cfg):
    """(ocl_tpu agent, port agent) for `cfg`; the ocl_tpu agent of a config,
    and so its jitted strategies, is built once per module."""
    key = tuple(sorted(cfg.items()))
    if key not in _JAX:
        j_agent = JExperienceReplay(j_default_params(**HP, **cfg))
        _JAX[key] = SimpleNamespace(retrieve_fn=jax.jit(j_agent.retrieve_fn),
                                    update_fn=jax.jit(j_agent.update_fn))
    return _JAX[key], ExperienceReplay(default_params(**HP, **cfg, device="cpu"))


def _batch(seed, lo=0, hi=N_CLS):
    g = np.random.RandomState(seed)
    y = g.randint(lo, hi, 10)
    return class_images(y, g), y


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def weights():
    return random_weights(31)


@pytest.mark.parametrize("fill", [MEM, 6, 0])
def test_mir_retrieve(weights, fill):
    params, stats = weights
    j_agent, t_agent = _agents(retrieve="MIR", subsample=20, fused_replay=False)
    jbuf, tbuf = make_buffers(MEM, fill, fill, seed=32)
    x, y = _batch(33)
    g = np.random.RandomState(34)
    grads = jax.tree_util.tree_map(lambda a: g.normal(0, 0.5, a.shape).astype(np.float32), params)
    key = jax.random.PRNGKey(35)
    j_x, j_y, j_mask, j_stats = j_agent.retrieve_fn(
        _jnp(params), _jnp(stats), jbuf, jnp.asarray(x), jnp.asarray(y), _jnp(grads), key)

    model = port_model(params, stats)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    t_x, t_y, t_mask = t_agent.retrieve.run(
        model, tbuf, torch.from_numpy(x), torch.from_numpy(y),
        {"g": _t(jax.random.gumbel(key, (MEM,)))}, grads=interop.from_jax(grads, {}))
    np.testing.assert_array_equal(t_mask.numpy(), np.asarray(j_mask))
    np.testing.assert_array_equal(t_y.numpy(), np.asarray(j_y))
    np.testing.assert_array_equal(t_x.numpy(), np.asarray(j_x))
    _, got_stats = interop.to_jax(model.state_dict())
    for a, b in zip(jax.tree_util.tree_leaves(got_stats), jax.tree_util.tree_leaves(j_stats)):
        np.testing.assert_allclose(a, np.asarray(b), **STATS_TOL)
    if fill == 0:  # no valid row: the pre forward folds nothing
        for k, v in model.state_dict().items():
            assert torch.equal(v, before[k]), k
    else:
        assert not torch.equal(model.bn1.running_mean, before["bn1.running_mean"])


def _match_buffers(name, short):
    """4 exemplars of each class for match (every batch label has a
    partner), 10 of each of classes 0-3 for mem_match (every candidate has
    one outside the candidates), or (short) one exemplar of each of classes
    0-8 and 31 of class 9."""
    labels = np.arange(MEM) % (N_CLS if name == "match" else 4)
    if short:
        labels = np.full(MEM, 9)
        labels[:9] = np.arange(9)
    return labels


@pytest.mark.parametrize("name", ["match", "mem_match"])
@pytest.mark.parametrize("n_seen,short", [(30, False), (100, False), (100, True)])
def test_match_retrieve(weights, name, n_seen, short):
    params, stats = weights
    j_agent, t_agent = _agents(retrieve=name)
    jbuf, tbuf = make_buffers(MEM, MEM, n_seen, seed=36, labels=_match_buffers(name, short))
    x, y = _batch(37)
    if short:
        y[:2] = 0   # two of class 0, one exemplar
    key = jax.random.PRNGKey(38)
    j_x, j_y, j_mask, _ = j_agent.retrieve_fn(
        _jnp(params), _jnp(stats), jbuf, jnp.asarray(x), jnp.asarray(y), None, key)
    if name == "match":
        draws = {"g": _t(jax.random.gumbel(key, (N_CLS, MEM)))}
    else:
        r1, r2 = jax.random.split(key)
        draws = {"g": _t(jax.random.gumbel(r1, (MEM,))),
                 "match": _t(jax.random.gumbel(r2, (N_CLS, MEM)))}
    t_x, t_y, t_mask = t_agent.retrieve.run(port_model(params, stats), tbuf,
                                            torch.from_numpy(x), torch.from_numpy(y), draws)
    np.testing.assert_array_equal(t_mask.numpy(), np.asarray(j_mask))
    np.testing.assert_array_equal(t_y.numpy(), np.asarray(j_y))
    np.testing.assert_array_equal(t_x.numpy(), np.asarray(j_x))
    assert t_mask.any().item() == (n_seen > 40 and not short)   # warmup 4 x 10
    if name == "match" and t_mask.any():
        np.testing.assert_array_equal(t_y.numpy(), y)             # a partner of each label


GSS = dict(update="GSS", gss_mem_strength=3, gss_batch_size=10)
# case -> (fill, batch classes): replacing needs a batch whose gradient points
# against every bank batch, which classes the buffer does not hold give
GSS_CASES = {"fill_empty": (0, (0, 5)), "fill_scored": (35, (0, 5)),
             "full_replace": (MEM, (5, 10)), "full_keep": (MEM, (0, 5))}


def gss_draws(key, batch):
    r_bank, r_cand, r_coin = jax.random.split(key, 3)
    return {"bank": _t(jax.random.gumbel(r_bank, (MEM,))),
            "cand": _t(jax.random.gumbel(r_cand, (MEM,))),
            "coin": _t(jax.random.uniform(r_coin, (batch,)))}


@pytest.mark.parametrize("case", sorted(GSS_CASES))
def test_gss_update(weights, case):
    params, stats = weights
    fill, (lo, hi) = GSS_CASES[case]
    j_agent, t_agent = _agents(**GSS)
    labels = np.random.RandomState(39).randint(0, 5, MEM)
    score = np.random.RandomState(40).uniform(-1, 1, MEM) * (np.arange(MEM) < fill)
    jbuf, tbuf = make_buffers(MEM, fill, fill, seed=41, labels=labels, score=score)
    before = tbuf.labels.clone(), tbuf.score.clone()
    x, y = _batch(43, lo, hi)
    key = jax.random.PRNGKey(45)  # a bank clear of ReLU kinks (see module doc)
    jbuf, _ = j_agent.update_fn(_jnp(params), _jnp(stats), jbuf,
                                jnp.asarray(x), jnp.asarray(y), key)
    t_agent.update.run(port_model(params, stats), tbuf, torch.from_numpy(x),
                       torch.from_numpy(y), gss_draws(key, 10))
    assert_buffers_equal(jbuf, tbuf)
    changed = not (torch.equal(tbuf.labels, before[0]) and torch.equal(tbuf.score, before[1]))
    assert changed == (case != "full_keep"), case
    if case.startswith("fill"):
        n = min(MEM - fill, 10)
        assert tbuf.current_index == fill + n
        if fill == 0:
            np.testing.assert_array_equal(tbuf.score[:n].numpy(), np.full(n, 0.1, np.float32))


@pytest.mark.parametrize("lo,hi", [(0, 5), (5, 10)])
def test_gss_jvp_gate_matches_bank(weights, lo, hi):
    """The gate's jvp dots equal <bank_i, batch grad> of the materialised
    bank, and max dot and max cosine have one sign (ocl_tpu/buffer/gss.py:
    104-107 against reference gss_greedy_update.py:25,65-80)."""
    params, stats = weights
    _, t_agent = _agents(**GSS)
    upd = t_agent.update.run
    _, tbuf = make_buffers(MEM, MEM, 100, seed=41,
                           labels=np.random.RandomState(39).randint(0, 5, MEM))
    x, y = (torch.from_numpy(a) for a in _batch(43, lo, hi))
    model = port_model(params, stats)
    p = {n: q.detach() for n, q in model.named_parameters()}
    xs, ys, ms, _ = upd.sample_bank_batches(tbuf, gss_draws(jax.random.PRNGKey(44), 10)["bank"])
    bgrad = grad(lambda pp: upd.ce_eval(model, pp, x, y))(p)
    dots = upd.bank_dots(model, p, xs, ys, ms, bgrad).numpy()
    bank = upd.mem_grad_bank(model, p, xs, ys, ms)
    bflat = torch.cat([g.reshape(-1) for g in bgrad.values()])
    np.testing.assert_allclose(dots, (bank @ bflat).numpy(), rtol=2e-3, atol=1e-6)
    cos_max = _cosine_rows(bank, bflat[None, :])[:, 0].max().item()
    assert (dots.max() < 0) == (cos_max < 0) == (lo == 5)
