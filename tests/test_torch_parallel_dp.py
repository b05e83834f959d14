"""The port's data-parallel train step (ocl_tpu_torch/parallel/dp.py) over a
slot-sharded buffer, against ocl_tpu's `make_dp_train_task` on the virtual
CPU mesh of the same size (tests/conftest.py) and against the port's own
unsharded step, from the same weights, buffer, batches and draws (rebuilt
from ocl_tpu's key splits).

ER, fused and two-pass, at W = 2 and 4 (batch and retrieved rows 2 W, a
memory of 8 W slots, as tests/test_parallel_equivalence.py:57-59):
  * one step against ocl_tpu's DP step: loss within 1e-5, parameters and BN
    statistics within 1e-3 (that file's pins);
  * one step against the port's unsharded step: within 1e-4, the order of
    the ranks' sums being the only difference;
  * three steps: the buffer's labels and `current_index` exact, parameters
    within 3x the divergence of a 1e-7 control run through the unsharded
    step (a double-counted or mis-averaged gradient lands far past it);
  * every rank's parameters and BN statistics bit for bit the same.
ER + ASER, SCR, GSS and the CN-DPM wake step: test_torch_parallel_dp_agents.py.

Each W's ranks run every case in one launch (`launch_cpu`: a FileStore in
a fresh temporary directory, one thread a rank, a 120 s limit that fails
instead of hanging).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_workers as workers
from ocl_tpu.agents.base import TrainState as JTrainState
from ocl_tpu.config import default_params as j_default_params
from ocl_tpu.parallel.dp import make_dp_train_task
from ocl_tpu.parallel.mesh import get_mesh
from ocl_tpu.parallel.sharded_buffer import shard_buffer
from ocl_tpu.registry import agents as j_agents
from ocl_tpu_torch import interop, parallel
from test_torch_buffer import batch, make_buffers
from test_torch_model import random_weights

NF = 4
LIMIT_S = 120
ER_CASES = [("fused", 2), ("fused", 4), ("two_pass", 2), ("two_pass", 4)]


def launch_cpu(fn, args, w, limit_s=LIMIT_S):
    """parallel.launch of `fn` on w CPU ranks, each on one torch thread (the
    caller's one, shared out), stopped with an error after `limit_s`."""
    from ocl_tpu_torch.parallel import mesh as pmesh

    threads, limit = torch.get_num_threads(), pmesh.LAUNCH_TIMEOUT_S
    torch.set_num_threads(1)
    pmesh.LAUNCH_TIMEOUT_S = limit_s
    try:
        return parallel.launch(fn, args, w, "cpu")
    finally:
        torch.set_num_threads(threads)
        pmesh.LAUNCH_TIMEOUT_S = limit


def _t(a):
    return torch.tensor(np.asarray(a))


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _max_diff(a, b):
    return max(float(np.max(np.abs(np.asarray(x, np.float64) - np.asarray(y, np.float64))))
               for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)))


def _sd_diff(a, b):
    return max(float((a[k].double() - b[k].double()).abs().max()) for k in a)


def er_draws(key, steps, mem, batch_size, two_pass):
    """Each step's draws of ocl_tpu's random/random ER step from its carried
    key (ocl_tpu/agents/er.py: fused splits two ways a retrieval, two-pass
    three; then the update's split)."""
    out = []
    for _ in range(steps):
        if two_pass:
            rng, r_ret, _ = jax.random.split(key, 3)
        else:
            rng, r_ret = jax.random.split(key)
        key, r_upd = jax.random.split(rng)
        out.append({"retrieve": [{"g": _t(jax.random.gumbel(r_ret, (mem,)))}],
                    "update": {"u": _t(jax.random.uniform(r_upd, (batch_size,)))}})
    return out


def buffer_spec(tbuf):
    return {"imgs": tbuf.imgs.numpy().copy(), "labels": tbuf.labels.numpy().copy(),
            "score": tbuf.score.numpy().copy(), "current_index": tbuf.current_index,
            "n_seen": tbuf.n_seen_so_far}


def batches(seed, steps, b):
    xs, ys = zip(*(batch(seed + i, b) for i in range(steps)))
    return np.stack(xs), np.stack(ys)


def jax_dp(j_agent, params, stats, jbuf, key, xs, ys, w, ag=None, opt_state=None):
    """ocl_tpu's DP task over the first w virtual devices."""
    mesh = get_mesh(w)
    state = JTrainState(params=_jnp(params), batch_stats=_jnp(stats),
                        opt_state=opt_state if opt_state is not None else
                        j_agent.tx.init(_jnp(params)),
                        buffer=None if jbuf is None else shard_buffer(jbuf, mesh),
                        agent=ag, rng=key)
    fn = make_dp_train_task(j_agent, mesh)
    with mesh:
        if j_agent.params.agent == "CNDPM":
            return fn(state, jnp.asarray(xs), jnp.asarray(ys, jnp.int32))
        return fn(state, j_agent.before_train(ys), jnp.asarray(xs), jnp.asarray(ys, jnp.int32))


def er_case(schedule, w):
    """(specs, ocl_tpu's one-step state and metrics) of an ER case."""
    mem, b = 8 * w, 2 * w
    hp = dict(data="synthetic", agent="ER", mem_size=mem, eps_mem_batch=b, batch=b, nf=NF,
              verbose=False, fused_replay=schedule == "fused")
    params, stats = random_weights(40 + w)
    jbuf, tbuf = make_buffers(mem, mem // 2, mem // 2, seed=41 + w)
    xs, ys = batches(42 + w, 3, b)
    key = jax.random.PRNGKey(43 + w)
    j_agent = j_agents["ER"](j_default_params(**hp, scan_unroll=1))
    jstate, jm = jax_dp(j_agent, params, stats, jbuf, key, xs[:1], ys[:1], w)
    spec = {"params": hp, "state_dict": interop.from_jax(params, stats),
            "buffer": buffer_spec(tbuf), "ctx_y": ys, "xs": xs, "ys": ys,
            "draws": er_draws(key, 3, mem, b, schedule == "two_pass")}
    one = dict(spec, xs=xs[:1], ys=ys[:1], draws=spec["draws"][:1])
    return {"one": one, "three": spec}, (jstate, jm)


@pytest.fixture(scope="module")
def cases():
    """{W: {schedule: (specs, ocl_tpu's one-step result)}}, and each W's
    ranks' results of every spec."""
    out = {w: {} for w in (2, 4)}
    for schedule, w in ER_CASES:
        out[w][schedule] = er_case(schedule, w)
    ranks = {}
    for w in (2, 4):
        specs = {}
        for name, (spec, _) in out[w].items():
            specs[name + "/one"], specs[name + "/three"] = spec["one"], spec["three"]
        ranks[w] = launch_cpu(workers.run_specs, (specs,), w)
    return out, ranks


@pytest.mark.parametrize("schedule,w", ER_CASES)
def test_dp_er_step_matches_ocl_tpu_dp(cases, schedule, w):
    out, ranks = cases
    _, (jstate, jm) = out[w][schedule]
    got = ranks[w][0][schedule + "/one"]
    assert abs(got["loss"][0] - float(jm["loss"][0])) < 1e-5
    params, stats = interop.to_jax(got["sd"])
    assert _max_diff(params, jstate.params) < 1e-3
    assert _max_diff(stats, jstate.batch_stats) < 1e-3
    np.testing.assert_array_equal(got["buffer"]["labels"], np.asarray(jstate.buffer.labels))
    assert got["buffer"]["current_index"] == int(jstate.buffer.current_index)


@pytest.mark.parametrize("schedule,w", ER_CASES)
def test_dp_er_step_matches_unsharded(cases, schedule, w):
    out, ranks = cases
    specs, _ = out[w][schedule]
    want = workers.run_plain(specs["one"])
    got = ranks[w][0][schedule + "/one"]
    assert _sd_diff(got["sd"], want["sd"]) < 1e-4
    assert abs(got["loss"][0] - want["loss"][0]) < 1e-5
    for k in ("labels", "imgs", "counts"):
        np.testing.assert_array_equal(got["buffer"][k], want["buffer"][k])


@pytest.mark.parametrize("schedule,w", ER_CASES)
def test_dp_er_three_steps_within_control(cases, schedule, w):
    out, ranks = cases
    specs, _ = out[w][schedule]
    plain = workers.run_plain(specs["three"])
    ctrl = workers.run_plain(dict(specs["three"], perturb=1e-7))
    got = ranks[w][0][schedule + "/three"]
    assert got["buffer"]["current_index"] == plain["buffer"]["current_index"]
    np.testing.assert_array_equal(got["buffer"]["labels"], plain["buffer"]["labels"])
    np.testing.assert_array_equal(got["buffer"]["counts"], plain["buffer"]["counts"])
    d_dp, d_ctrl = _sd_diff(got["sd"], plain["sd"]), _sd_diff(ctrl["sd"], plain["sd"])
    assert d_dp <= 3.0 * d_ctrl + 1e-6, (d_dp, d_ctrl)


@pytest.mark.parametrize("w", [2, 4])
def test_dp_ranks_stay_bit_identical(cases, w):
    _, ranks = cases
    for name in ranks[w][0]:
        for r in ranks[w][1:]:
            for k, v in ranks[w][0][name]["sd"].items():
                assert torch.equal(v, r[name]["sd"][k]), (name, k)
            assert r[name]["loss"] == ranks[w][0][name]["loss"], name


def test_dp_step_refuses_what_it_does_not_run():
    from ocl_tpu_torch.config import default_params
    from ocl_tpu_torch.parallel import dp
    from ocl_tpu_torch.parallel.mesh import Mesh
    from ocl_tpu_torch.registry import agents

    mesh = Mesh(rank=0, size=2, device=torch.device("cpu"), backend="gloo")
    for kw in (dict(agent="ER", retrieve="MIR"), dict(agent="AGEM")):
        agent = agents[kw["agent"]](default_params(data="synthetic", nf=NF, device="cpu", **kw))
        with pytest.raises(NotImplementedError):
            dp.make_dp_train_task(agent, mesh)
    with pytest.raises(ValueError, match="5 batch rows cannot be split over 2 ranks"):
        mesh.rows(5, "batch rows")
