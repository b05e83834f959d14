"""The slot-sharded buffer (ocl_tpu_torch/parallel/sharded_buffer.py): the
counterparts of tests/test_sharded_buffer.py's five tests, at W = 2 and 4.

Over a buffer of 64 slots split over the ranks, the port's random and
class-balanced retrieval, reservoir update, ASER retrieval (its SV sums in
XLA:CPU's order, test_torch_aser.py::xla_summation_order), GSS update and
NCM evaluation must equal the port's unsharded ones exactly (NCM's class
means, summed over the ranks, to rtol 1e-5) and ocl_tpu's, run on a buffer
slot-sharded over W virtual CPU devices, with the same draws (rebuilt from
its keys): exactly, but for GSS's scores, cosines of single-image gradients,
which hold to the port's score tolerance (rtol 1e-3 / atol 1e-4). Each W's
ranks run every check in one launch (one thread a rank, a 120 s limit that
fails instead of hanging).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_workers as workers
from ocl_tpu.agents.base import TrainState as JTrainState
from ocl_tpu.buffer import build_retrieve as j_build_retrieve
from ocl_tpu.buffer import build_update as j_build_update
from ocl_tpu.buffer.reservoir import reservoir_update as j_reservoir_update
from ocl_tpu.buffer.retrieve import class_balanced_sample as j_balanced
from ocl_tpu.buffer.retrieve import random_retrieve as j_random
from ocl_tpu.config import default_params as j_default_params
from ocl_tpu.data import prepare_test_loaders as j_prepare_test_loaders
from ocl_tpu.parallel.mesh import get_mesh
from ocl_tpu.parallel.sharded_buffer import shard_buffer as j_shard_buffer
from ocl_tpu.registry import agents as j_agents
from ocl_tpu_torch import interop
from ocl_tpu_torch.buffer.reservoir import reservoir_update
from ocl_tpu_torch.buffer.retrieve import class_balanced_sample, random_retrieve
from ocl_tpu_torch.config import default_params
from ocl_tpu_torch.data import prepare_test_loaders
from test_torch_buffer import N_CLS, batch, class_images, make_buffers
from test_torch_model import random_weights
from test_torch_parallel_dp import NF, buffer_spec, launch_cpu

MEM = 64
ASER = dict(data="synthetic", agent="ER", retrieve="ASER", update="ASER", aser_type="asvm",
            mem_size=MEM, eps_mem_batch=8, k=3, n_smp_cls=2.0, nf=NF, verbose=False)
GSS = dict(data="synthetic", agent="ER", update="GSS", mem_size=MEM, eps_mem_batch=8,
           gss_mem_strength=3, gss_batch_size=8, nf=NF, verbose=False)
NCM = dict(data="synthetic", agent="ER", ncm_trick=True, mem_size=MEM, eps_mem_batch=8,
           nf=NF, test_batch=16, verbose=False)


def _t(a):
    return torch.tensor(np.asarray(a))


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def make_case(w):
    """The inputs of every check, ocl_tpu's results on a buffer sharded over
    w virtual devices, and the port's unsharded results."""
    mesh = get_mesh(w)
    score = np.random.RandomState(5).uniform(-1, 1, MEM).astype(np.float32)
    jbuf, tbuf = make_buffers(MEM, MEM, 1000, seed=3 + w, score=score)
    # the reservoir update on a buffer 4 slots short of full: it fills 4
    # slots and draws slots for the other 4 among 68
    ubuf, tubuf = make_buffers(MEM, MEM - 4, MEM - 4, seed=4 + w)
    # GSS on classes 0-4 with a batch of classes 5-9: a batch whose gradient
    # opposes every memory batch's, so that the gate opens (that of seed 44
    # does at both W; the coin then replaces 3 and 5 slots)
    gbuf, tgbuf = make_buffers(MEM, MEM, 1000, seed=6 + w, score=score,
                               labels=np.arange(MEM) % 5)
    gx, gy = batch(44 + w, 8)
    gy = 5 + gy % 5
    gx = class_images(gy, np.random.RandomState(45 + w))
    params, stats = random_weights(11)
    sd = interop.from_jax(params, stats)
    keys = jax.random.split(jax.random.PRNGKey(7 + w), 6)
    x, y = batch(20 + w, 8)
    spec = {"state_dict": sd, "ctx_y": y}
    case = {"buffer": buffer_spec(tbuf), "k": 16, "n_smp_cls": 2,
            "g": _t(jax.random.gumbel(keys[0], (MEM,))),
            "gc": _t(jax.random.gumbel(keys[1], (N_CLS, MEM))),
            "update": (torch.from_numpy(x), torch.from_numpy(y),
                       _t(jax.random.uniform(keys[2], (8,)))),
            "aser": dict(spec, params=ASER), "aser_n_seen": 1000,
            "aser_batch": (torch.from_numpy(x), torch.from_numpy(y)),
            "update_buffer": buffer_spec(tubuf), "gss_buffer": buffer_spec(tgbuf),
            "gss": dict(spec, params=GSS),
            "gss_batch": (torch.from_numpy(gx), torch.from_numpy(gy)),
            "ncm": dict(spec, params=NCM, old_labels=list(range(N_CLS)))}
    r_rand, r_cand, r_coop = jax.random.split(keys[3], 3)
    case["aser_draws"] = {"rand": _t(jax.random.gumbel(r_rand, (MEM,))),
                          "cand": _t(jax.random.gumbel(r_cand, (N_CLS, MEM))),
                          "coop": _t(jax.random.gumbel(r_coop, (N_CLS, MEM)))}
    r_bank, r_cand, r_coin = jax.random.split(keys[4], 3)
    case["gss_draws"] = {"bank": _t(jax.random.gumbel(r_bank, (MEM,))),
                         "cand": _t(jax.random.gumbel(r_cand, (MEM,))),
                         "coin": _t(jax.random.uniform(r_coin, (8,)))}
    g = np.random.RandomState(30 + w)
    tests = [(class_images(lab, g), lab) for lab in
             (g.randint(0, N_CLS, 32), g.randint(0, N_CLS, 48))]
    case["loaders"] = prepare_test_loaders(tests, default_params(**NCM, device="cpu"), "cpu")
    case["noise"] = torch.zeros(N_CLS, NF * 8)

    # ocl_tpu, its buffer slot-sharded over w devices
    want = {}
    sbuf = j_shard_buffer(jbuf, mesh)
    xj, yj = jnp.asarray(x), jnp.asarray(y, jnp.int32)
    with mesh:
        want["random"] = jax.jit(lambda b: j_random(b, 16, keys[0]))(sbuf)
        want["balanced"] = jax.jit(lambda b: j_balanced(b, 2, keys[1]))(sbuf)
        want["update"] = jax.jit(j_reservoir_update)(j_shard_buffer(ubuf, mesh), xj, yj, keys[2])
        j_agent = j_agents["ER"](j_default_params(**ASER))
        zeros = jax.tree_util.tree_map(jnp.zeros_like, _jnp(params))
        want["aser"] = jax.jit(lambda b: j_build_retrieve(j_agent)(
            _jnp(params), _jnp(stats), b, xj, yj, zeros, keys[3]))(sbuf)
        g_agent = j_agents["ER"](j_default_params(**GSS))
        want["gss"] = jax.jit(lambda b: j_build_update(g_agent)(
            _jnp(params), _jnp(stats), b, jnp.asarray(gx), jnp.asarray(gy, jnp.int32),
            keys[4]))(j_shard_buffer(gbuf, mesh))[0]
        n_agent = j_agents["ER"](j_default_params(**NCM, n_devices=w))
        n_agent.old_labels = list(range(N_CLS))
        jstate = JTrainState(params=_jnp(params), batch_stats=_jnp(stats), opt_state=None,
                             buffer=sbuf, agent=None, rng=keys[5])
        want["ncm"] = n_agent.evaluate(jstate, j_prepare_test_loaders(tests, n_agent.params))
        assert ("ncm", w) in n_agent._eval_cache   # ocl_tpu's sharded program ran
    return case, want


def plain(case):
    """The port's unsharded results of the same checks, on one thread as
    the ranks run (a convolution's order of sums depends on the threads)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _plain(case)
    finally:
        torch.set_num_threads(threads)


def _plain(case):
    out = {}
    agent, state, _ = workers.build(dict(case["aser"], buffer=case["buffer"]))
    buf = state.buffer
    x, y, _, m = random_retrieve(buf, case["k"], case["g"])
    out["random"] = (x.numpy(), y.numpy(), m.numpy())
    x, y, idx, m = class_balanced_sample(buf, case["n_smp_cls"], case["gc"])
    out["balanced"] = (x.numpy(), y.numpy(), idx.numpy(), m.numpy())
    buf = workers.build(dict(case["aser"], buffer=case["update_buffer"]))[1].buffer
    replaced = reservoir_update(buf, *case["update"])
    out["update"] = (buf.labels.numpy(), buf.imgs.numpy(), buf.class_counts.numpy(),
                     replaced.numpy(), buf.current_index, buf.n_seen_so_far)
    agent, state, _ = workers.build(dict(case["aser"], buffer=case["buffer"]))
    state.buffer.n_seen_so_far = case["aser_n_seen"]
    with workers.arithmetic({"xla_order": True}):
        mx, my, mm = agent.retrieve.run(state.model, state.buffer, *case["aser_batch"],
                                        case["aser_draws"])
    out["aser"] = (mx.numpy(), my.numpy(), mm.numpy())
    g_agent, g_state, _ = workers.build(dict(case["gss"], buffer=case["gss_buffer"]))
    g_agent.update.run(g_state.model, g_state.buffer, *case["gss_batch"], case["gss_draws"])
    buf = g_state.buffer
    out["gss"] = (buf.labels.numpy(), buf.score.numpy(), buf.class_counts.numpy())
    n_agent, n_state, _ = workers.build(dict(case["ncm"], buffer=case["buffer"]))
    out["ncm"] = (n_agent.ncm_means(n_state, case["noise"]).numpy(),
                  n_agent._evaluate_ncm(n_state, case["loaders"], case["noise"]))
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=["w2", "w4"])
def checks(request):
    w = request.param
    case, want = make_case(w)
    ranks = launch_cpu(workers.buffer_checks, (case,), w)
    for r in ranks[1:]:   # every rank holds the same whole results
        for a, b in zip(jax.tree_util.tree_leaves(r), jax.tree_util.tree_leaves(ranks[0])):
            np.testing.assert_array_equal(a, b)
    return ranks[0], plain(case), want, case


def test_sharded_retrieval_matches_unsharded(checks):
    got, port, want, case = checks
    for kind in ("random", "balanced"):
        for a, b in zip(got[kind], port[kind]):
            np.testing.assert_array_equal(a, b)
    jx, jy, _, jm = want["random"]
    np.testing.assert_array_equal(got["random"][0], np.asarray(jx))
    np.testing.assert_array_equal(got["random"][1], np.asarray(jy))
    np.testing.assert_array_equal(got["random"][2], np.asarray(jm))
    for a, b in zip(got["balanced"], want["balanced"]):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_sharded_update_matches_unsharded(checks):
    got, port, want, case = checks
    for a, b in zip(got["update"], port["update"]):
        np.testing.assert_array_equal(a, b)
    jbuf, replaced = want["update"]
    np.testing.assert_array_equal(got["update"][0], np.asarray(jbuf.labels))
    np.testing.assert_array_equal(got["update"][1], np.asarray(jbuf.imgs))
    np.testing.assert_array_equal(got["update"][2], np.asarray(jbuf.class_counts))
    np.testing.assert_array_equal(got["update"][3], np.asarray(replaced))
    assert got["update"][4:] == (int(jbuf.current_index), int(jbuf.n_seen_so_far))
    assert (got["update"][3] >= 0).any()   # the update wrote a slot


def test_sharded_aser_scoring_matches_unsharded(checks):
    """Features of each rank's rows, gathered; K1's plain version on every
    rank: the retrieved rows exactly."""
    got, port, want, case = checks
    for a, b in zip(got["aser"], port["aser"]):
        np.testing.assert_array_equal(a, b)
    jx, jy, jm, _ = want["aser"]
    np.testing.assert_array_equal(got["aser"][2], np.asarray(jm))
    np.testing.assert_array_equal(got["aser"][1], np.asarray(jy))
    np.testing.assert_array_equal(got["aser"][0], np.asarray(jx))


def test_sharded_gss_update_matches_unsharded(checks):
    got, port, want, case = checks
    np.testing.assert_array_equal(got["gss"][0], port["gss"][0])
    np.testing.assert_array_equal(got["gss"][1], port["gss"][1])
    np.testing.assert_array_equal(got["gss"][2], port["gss"][2])
    np.testing.assert_array_equal(got["gss"][0], np.asarray(want["gss"].labels))
    # GSS scores are cosines of single-image gradients: against ocl_tpu at
    # test_torch_buffer.py::assert_buffers_equal's score tolerance
    np.testing.assert_allclose(got["gss"][1], np.asarray(want["gss"].score), rtol=1e-3,
                               atol=1e-4)
    assert not np.array_equal(got["gss"][0], case["gss_buffer"]["labels"])   # GSS replaced


def test_sharded_ncm_eval_matches_unsharded(checks):
    got, port, want, case = checks
    np.testing.assert_allclose(got["ncm"][0], port["ncm"][0], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got["ncm"][1], port["ncm"][1])
    np.testing.assert_array_equal(got["ncm"][1], np.asarray(want["ncm"]))


def test_interop_carries_a_sharded_buffer():
    """ocl_tpu's buffer maps to the ranks' slices of slots and back; the
    slices are the slots a ShardedBuffer holds (shard_buffer on a mesh of W
    ranks, as each rank would build it)."""
    from ocl_tpu_torch.parallel.mesh import Mesh
    from ocl_tpu_torch.parallel.sharded_buffer import shard_buffer

    jbuf, tbuf = make_buffers(MEM, 40, 70, seed=9)
    for w in (2, 4):
        shards = interop.buffer_shards_from_jax(jbuf, w)
        back = interop.buffer_from_shards(shards)
        for k in ("imgs", "labels", "score", "class_counts"):
            np.testing.assert_array_equal(back[k], np.asarray(getattr(jbuf, k)))
        assert back["current_index"] == 40 and back["n_seen_so_far"] == 70
        for r, shard in enumerate(shards):
            sbuf = shard_buffer(tbuf, Mesh(rank=r, size=w, device=torch.device("cpu"),
                                           backend="gloo"))
            np.testing.assert_array_equal(sbuf.slot_imgs[:-1].numpy(), shard["imgs"])
            np.testing.assert_array_equal(sbuf.slot_labels[:-1].numpy(), shard["labels"])
            np.testing.assert_array_equal(sbuf.class_counts.numpy(), shard["class_counts"])
            assert sbuf.current_index == int(shard["current_index"])
    with pytest.raises(ValueError, match="64 buffer slots cannot be split over 3 ranks"):
        interop.buffer_shards_from_jax(jbuf, 3)
