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
ER + ASER, SCR, GSS and the CN-DPM wake step: test_torch_parallel_dp_agents.py;
MIR, match and mem_match: test_torch_parallel_dp_replay.py; AGEM, EWC++, LwF
and the tricks: test_torch_parallel_dp_regularised.py; SCR's strategies and
the ASER paths of AGEM and SCR: test_torch_parallel_dp_scr.py (their cases
built by `dp_case`, held by the `assert_*` pins here). The DP step refuses
iCaRL and GDumb, as ocl_tpu's does, and takes every other agent.

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
from test_torch_agents import OLD_LABELS, agent_state, supcon_weights
from test_torch_augment import port_draws as aug_draws
from test_torch_buffer import N_CLS, batch, make_buffers
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


def retrieve_draws(name, r, mem):
    """ocl_tpu's draws of retrieval `name` from key `r` (ocl_tpu/buffer/)."""
    if name == "match":
        return {"g": _t(jax.random.gumbel(r, (N_CLS, mem)))}
    if name == "mem_match":
        r1, r2 = jax.random.split(r)
        return {"g": _t(jax.random.gumbel(r1, (mem,))),
                "match": _t(jax.random.gumbel(r2, (N_CLS, mem)))}
    if name == "ASER":
        r_rand, r_cand, r_coop = jax.random.split(r, 3)
        return {"rand": _t(jax.random.gumbel(r_rand, (mem,))),
                "cand": _t(jax.random.gumbel(r_cand, (N_CLS, mem))),
                "coop": _t(jax.random.gumbel(r_coop, (N_CLS, mem)))}
    return {"g": _t(jax.random.gumbel(r, (mem,)))}   # random, MIR


def update_draws(name, r, mem, batch_size):
    """ocl_tpu's draws of update `name` from key `r` (ocl_tpu/buffer/)."""
    if name == "ASER":
        r_thr, r_eval, r_cand, _ = jax.random.split(r, 4)
        return {"thr": _t(jax.random.uniform(r_thr, ())),
                "eval": _t(jax.random.gumbel(r_eval, (N_CLS, mem))),
                "cand": _t(jax.random.gumbel(r_cand, (mem,)))}
    if name == "GSS":
        r_bank, r_cand, r_coin = jax.random.split(r, 3)
        return {"bank": _t(jax.random.gumbel(r_bank, (mem,))),
                "cand": _t(jax.random.gumbel(r_cand, (mem,))),
                "coin": _t(jax.random.uniform(r_coin, (batch_size,)))}
    return {"u": _t(jax.random.uniform(r, (batch_size,)))}


def step_draws(p, key, steps, aug_rows=0):
    """Each step's draws of ocl_tpu's step for params `p` from its carried
    key, as the port's `step` takes them: ER's fused schedule and AGEM split
    the key two ways a retrieval, ER's two-pass schedule three, SCR three
    with its augmentation of `aug_rows` rows (ocl_tpu/agents/er.py:80, :97,
    agem.py:53, scr.py:66); then the update's split. None a step for an
    agent without draws."""
    if p.agent not in ("ER", "AGEM", "SCR"):
        return [None] * steps
    aser = "ASER" in (p.update, p.retrieve)
    fused = p.agent == "ER" and p.fused_replay and not aser and p.retrieve in ("random", "match")
    out = []
    for _ in range(steps):
        rng, r_ret, *r_aug = jax.random.split(key, 2 if fused or p.agent == "AGEM" else 3)
        key, r_upd = jax.random.split(rng)
        ret = retrieve_draws(p.retrieve, r_ret, p.mem_size)
        upd = update_draws(p.update, r_upd, p.mem_size, p.batch)
        if p.agent == "SCR":
            out.append({"iters": [{"retrieve": ret, "aug": aug_draws(r_aug[0], n=aug_rows)}],
                        "update": upd})
        else:
            out.append({"retrieve": [ret], "update": upd})
    return out


def buffer_spec(tbuf):
    return {"imgs": tbuf.imgs.numpy().copy(), "labels": tbuf.labels.numpy().copy(),
            "score": tbuf.score.numpy().copy(), "current_index": tbuf.current_index,
            "n_seen": tbuf.n_seen_so_far}


def batches(seed, steps, b, n_classes=N_CLS):
    xs, ys = zip(*(batch(seed + i, b, n_classes) for i in range(steps)))
    return np.stack(xs), np.stack(ys)


def jax_dp(j_agent, params, stats, jbuf, key, xs, ys, w, ag=None, opt_state=None, ctx_y=None):
    """ocl_tpu's DP task over the first w virtual devices (its TaskCtx from
    `ctx_y`, else from ys)."""
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
        return fn(state, j_agent.before_train(ys if ctx_y is None else ctx_y), jnp.asarray(xs),
                  jnp.asarray(ys, jnp.int32))


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
            "draws": step_draws(j_agent.params, key, 3)}
    one = dict(spec, xs=xs[:1], ys=ys[:1], draws=spec["draws"][:1])
    return {"one": one, "three": spec}, (jstate, jm)


def dp_case(hp, w, seed, fill=0, n_seen=0, labels=None, score=None, n_classes=N_CLS,
            agent=None, agent_edit=None, task_seen=0, xla_order=False):
    """A case of the agents' DP tests (test_torch_parallel_dp_{replay,
    regularised,scr}.py) for ocl_tpu default_params keywords `hp` at W = w:
    weights from `seed` (SupConResNet's for SCR), a memory of `fill` filled
    slots (labels random unless given, GSS scores `score`) that has seen
    `n_seen`, 3 batches from `n_classes` classes, ocl_tpu's agent pytree of
    test_torch_agents.py's config `agent` (a teacher, EWC's trees), each
    entry k of `agent_edit` replaced by agent_edit[k](entry), at
    `task_seen` tasks, each step's
    draws from one key; `xla_order` runs ASER's sums in XLA's order.
    Returns (the three steps' spec, whose DP run also reports its first
    step, and ocl_tpu's DP step over the first batch: (state, metrics))."""
    b = hp["batch"]
    params, stats = supcon_weights(seed) if hp["agent"] == "SCR" else random_weights(seed)
    j_agent = j_agents[hp["agent"]](j_default_params(**hp, scan_unroll=1))
    bufs = make_buffers(hp["mem_size"], fill, n_seen, seed=seed + 1, labels=labels,
                        score=score) if j_agent.uses_buffer else (None, None)
    xs, ys = batches(seed + 2, 3, b, n_classes)
    key = jax.random.PRNGKey(seed + 3)
    ag = None if agent is None else agent_state(agent, params, seed + 4)
    for k, f in (agent_edit or {}).items():
        ag[k] = f(ag[k])
    old = OLD_LABELS[: 4 * task_seen]
    j_agent.task_seen, j_agent.old_labels = task_seen, old
    jstate, jm = jax_dp(j_agent, params, stats, bufs[0], key, xs[:1], ys[:1], w,
                        ag=None if ag is None else _jnp(ag), ctx_y=ys)
    n_mem = {"match": b, "mem_match": 2 * hp["eps_mem_batch"]}.get(
        j_agent.params.retrieve, hp["eps_mem_batch"])
    spec = {"params": hp, "state_dict": interop.from_jax(params, stats),
            "buffer": None if bufs[1] is None else buffer_spec(bufs[1]), "agent": ag,
            "task_seen": task_seen, "old_labels": old, "ctx_y": ys, "xs": xs, "ys": ys,
            "draws": step_draws(j_agent.params, key, 3, aug_rows=n_mem + b),
            "xla_order": xla_order, "first": 1}
    return spec, (jstate, jm)


def launch_cases(cases, w, retrievals=None):
    """Every case's spec (and `retrievals`, see torch_parallel_workers.
    run_specs) on w ranks in one launch; returns each rank's results by
    case name."""
    specs = {name: spec for name, (spec, _) in cases.items()}
    return launch_cpu(workers.run_specs, (specs, retrievals), w)


def assert_matches_ocl_tpu_dp(got, jstate, jm, loss_tol=1e-5):
    """One DP step against ocl_tpu's (tests/test_parallel_equivalence.py's
    pins): the loss within `loss_tol`, parameters and BN statistics within
    1e-3, the buffer's counter and labels exact, its images within 1e-6."""
    assert abs(got["loss"][0] - float(jm["loss"][0])) < loss_tol, (got["loss"][0], jm["loss"])
    params, stats = interop.to_jax(got["sd"])
    assert _max_diff(params, jstate.params) < 1e-3
    assert _max_diff(stats, jstate.batch_stats) < 1e-3
    if "buffer" in got:
        assert got["buffer"]["current_index"] == int(jstate.buffer.current_index)
        np.testing.assert_array_equal(got["buffer"]["labels"], np.asarray(jstate.buffer.labels))
        assert np.max(np.abs(got["buffer"]["imgs"] - np.asarray(jstate.buffer.imgs))) < 1e-6


def assert_within_control(got, spec):
    """Three DP steps against the port's unsharded three: the buffer's
    counter and labels exact, its images within 1e-6, the parameters within
    3x the divergence of a run whose weights start 1e-7 off (a double-counted
    or mis-averaged gradient lands far past it)."""
    plain = workers.run_plain(spec)
    ctrl = workers.run_plain(dict(spec, perturb=1e-7))
    if "buffer" in got:
        assert got["buffer"]["current_index"] == plain["buffer"]["current_index"]
        np.testing.assert_array_equal(got["buffer"]["labels"], plain["buffer"]["labels"])
        assert np.max(np.abs(got["buffer"]["imgs"] - plain["buffer"]["imgs"])) < 1e-6
    d_dp, d_ctrl = _sd_diff(got["sd"], plain["sd"]), _sd_diff(ctrl["sd"], plain["sd"])
    assert d_dp <= 3.0 * d_ctrl + 1e-6, (d_dp, d_ctrl)


def assert_ranks_bit_identical(ranks):
    """Every rank's weights, BN statistics and losses those of rank 0 (after
    each spec's first steps too)."""
    for name, want in ranks[0].items():
        for r in ranks[1:]:
            for got, ref in ((r[name], want), (r[name].get("first"), want.get("first"))):
                for k, v in (ref or {}).get("sd", {}).items():
                    assert torch.equal(v, got["sd"][k]), (name, k)
                assert (got or {}).get("loss") == (ref or {}).get("loss"), name


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
    assert_ranks_bit_identical(cases[1][w])


def test_dp_step_refuses_what_it_does_not_run():
    """iCaRL and GDumb, the two agents ocl_tpu's make_dp_train_task cannot
    take either: iCaRL's six-argument task function does not fit its four
    in_shardings (TypeError at the call), GDumb has no task function
    (NotImplementedError)."""
    from ocl_tpu_torch.config import default_params
    from ocl_tpu_torch.parallel import dp
    from ocl_tpu_torch.parallel.mesh import Mesh
    from ocl_tpu_torch.registry import agents

    mesh = Mesh(rank=0, size=2, device=torch.device("cpu"), backend="gloo")
    for name in ("ICARL", "GDUMB"):
        agent = agents[name](default_params(data="synthetic", nf=NF, device="cpu", agent=name))
        with pytest.raises(NotImplementedError, match="make_dp_train_task cannot take it"):
            dp.make_dp_train_task(agent, mesh)
    j_mesh = get_mesh(2)
    icarl = j_agents["ICARL"](j_default_params(data="synthetic", nf=NF, agent="ICARL"))
    fn = make_dp_train_task(icarl, j_mesh)
    with j_mesh, pytest.raises(TypeError, match="missing 2 required positional arguments"):
        fn(jnp.zeros(()), jnp.zeros(()), jnp.zeros((1, 2)), jnp.zeros((1, 2), jnp.int32))
    with pytest.raises(NotImplementedError):
        make_dp_train_task(j_agents["GDUMB"](j_default_params(data="synthetic", nf=NF,
                                                              agent="GDUMB")), j_mesh)
    with pytest.raises(ValueError, match="5 batch rows cannot be split over 2 ranks"):
        mesh.rows(5, "batch rows")


ADMITTED = (
    [dict(agent=a, retrieve=r, update=u) for a in ("ER", "AGEM", "SCR")
     for r in ("random", "MIR", "ASER", "match", "mem_match")
     for u in ("random", "GSS", "ASER")]
    + [dict(agent="ER", fused_replay=False), dict(agent="EWC"), dict(agent="LWF"),
       dict(agent="CNDPM")]
    + [dict(agent="ER", **{t: True}) for t in ("labels_trick", "separated_softmax", "kd_trick",
                                                "kd_trick_star", "review_trick")])


@pytest.mark.parametrize("kw", ADMITTED, ids=["-".join(str(v) if v is not True else k
                                                       for k, v in kw.items()) for kw in ADMITTED])
def test_dp_step_admits_what_ocl_tpu_runs(kw):
    """Every agent, retrieval x update and trick that ocl_tpu's
    make_dp_train_task runs gets a data-parallel task (review_trick's pass
    comes after the task, outside it, in both packages)."""
    from ocl_tpu_torch.config import default_params
    from ocl_tpu_torch.parallel import dp
    from ocl_tpu_torch.parallel.mesh import Mesh
    from ocl_tpu_torch.registry import agents

    mesh = Mesh(rank=0, size=2, device=torch.device("cpu"), backend="gloo")
    agent = agents[kw["agent"]](default_params(data="synthetic", nf=NF, device="cpu", **kw))
    assert callable(dp.make_dp_train_task(agent, mesh))
