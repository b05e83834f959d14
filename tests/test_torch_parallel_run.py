"""The port's stacked runs (ocl_tpu_torch/experiment/parallel_run.py and the
stacked hooks of the agents) against ocl_tpu's vmapped step and against the
port's own sequential runs.

* One stacked step of two lanes, each from its own weights, buffer, batch
  and draws (rebuilt from that lane's ocl_tpu key split, as
  test_torch_agents.py::port_draws does), against
  `jax.vmap(agent._build_train_task_fn())` lane by lane: fused ER, ER +
  ASER, AGEM, EWC++ (then `after_train_stacked`'s per-point Fisher) and LwF.
  Params and BN statistics rtol 1e-3 / atol 1e-4; buffers exact. lr 0.01 at
  nf 4, for the reason test_torch_er_step.py gives.
* Stacked runs against sequential runs (as tests/test_parallel_equivalence.py
  holds ocl_tpu's): each run's task stream, shuffles and draws are exactly
  those of sequential run r; permuting the lanes permutes the results
  exactly; one paired step agrees to rounding.
* The per-point optimizer, and the CLI.
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocl_tpu.agents.base import TrainState as JTrainState
from ocl_tpu.config import default_params as j_default_params
from ocl_tpu.registry import agents as j_agents
from ocl_tpu_torch import interop
from ocl_tpu_torch.agents.base import TrainState, stack_ctx
from ocl_tpu_torch.agents.er import ExperienceReplay
from ocl_tpu_torch.config import build_parser, default_params, finalize
from ocl_tpu_torch.experiment import parallel_run
from ocl_tpu_torch.experiment.parallel_run import _stack, point_state
from ocl_tpu_torch.experiment.run import multiple_run
from ocl_tpu_torch.optim import StackedOptimizer, setup_opt
from ocl_tpu_torch.registry import agents
from test_torch_agents import port_draws
from test_torch_aser import xla_summation_order
from test_torch_buffer import MEM, assert_buffers_equal, batch, make_buffers
from test_torch_er_step import port_draws as aser_port_draws
from test_torch_model import port_model, random_weights

NF = 4
TOL = dict(rtol=1e-3, atol=1e-4)
HP = dict(data="synthetic", mem_size=MEM, eps_mem_batch=10, batch=10, learning_rate=0.01,
          nf=NF, verbose=False)
CONFIGS = {
    "er_fused": dict(agent="ER"),
    "er_aser": dict(agent="ER", update="ASER", retrieve="ASER", aser_type="asvm", k=3,
                    n_smp_cls=2.0),
    "agem": dict(agent="AGEM"),
    "ewc": dict(agent="EWC", fisher_update_after=1),
    "lwf": dict(agent="LWF"),
}
OLD_LABELS = [0, 2, 4, 6]
LANES = 2


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread: the suite's parallel workers share the host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _jstack(trees):
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *trees)


def _lane(tree, p):
    return jax.tree_util.tree_map(lambda a: np.asarray(a)[p], tree)


def _tstack(trees):
    return torch.utils._pytree.tree_map(lambda *xs: torch.stack(xs), *trees)


def lane_agent_state(name, params, seed):
    """ocl_tpu's agent pytree of one lane at task_seen 1."""
    g = np.random.RandomState(seed)
    ag = {}
    if name == "lwf":
        ag["teacher_params"], ag["teacher_stats"] = random_weights(seed)
        ag["has_teacher"] = np.float32(1.0)
    if name == "ewc":
        def tree(f):
            return jax.tree_util.tree_map(lambda a: f(a).astype(np.float32), params)

        ag.update(prev_params=tree(lambda a: a + g.normal(0, 0.05, a.shape)),
                  running_fisher=tree(lambda a: g.uniform(0, 1e-2, a.shape)),
                  tmp_fisher=tree(lambda a: g.uniform(0, 1e-2, a.shape)),
                  normalized_fisher=tree(lambda a: g.uniform(0, 1, a.shape)),
                  has_prev=np.float32(1.0), step_in_task=np.int32(0))
    return ag or None


@pytest.fixture(scope="module")
def jax_vmapped():
    """config name -> (jitted vmapped one-task fn, ocl_tpu agent)."""
    cache = {}

    def get(name):
        if name not in cache:
            cfg = CONFIGS[name]
            agent = j_agents[cfg["agent"]](j_default_params(**HP, **cfg))
            fn = jax.jit(jax.vmap(agent._build_train_task_fn(), in_axes=(0, None, 0, 0)))
            cache[name] = (fn, agent)
        return cache[name]

    return get


def run_stacked_both(jax_vmapped, name, monkeypatch):
    """One step of 2 lanes on both packages; returns (ocl_tpu stacked state,
    port StackedState, port agent, ocl_tpu agent)."""
    if name == "er_aser":
        xla_summation_order(monkeypatch)
    fn, j_agent = jax_vmapped(name)
    cfg = CONFIGS[name]
    task_seen = 0 if name == "er_fused" else 1
    fill, n_seen = (MEM, 100) if name == "er_aser" else (35, 35)
    lanes = []
    for p in range(LANES):
        params, stats = random_weights(21 + 10 * p)
        x, y = batch(30 + p)
        ag = lane_agent_state(name, params, 22 + 10 * p)
        jbuf, tbuf = make_buffers(MEM, fill, n_seen, seed=23 + p) if j_agent.uses_buffer \
            else (None, None)
        lanes.append(dict(params=params, stats=stats, x=x, y=y, ag=ag, jbuf=jbuf, tbuf=tbuf,
                          key=jax.random.PRNGKey(24 + p)))

    j_agent.task_seen, j_agent.old_labels = task_seen, OLD_LABELS[: 4 * task_seen]
    ctx = j_agent.before_train(lanes[0]["y"])
    jstates = [JTrainState(params=_jnp(ln["params"]), batch_stats=_jnp(ln["stats"]),
                           opt_state=j_agent.tx.init(_jnp(ln["params"])), buffer=ln["jbuf"],
                           agent=_jnp(ln["ag"]) if ln["ag"] is not None else None,
                           rng=ln["key"]) for ln in lanes]
    jstate, _ = fn(_jstack(jstates), ctx, jnp.stack([jnp.asarray(ln["x"])[None] for ln in lanes]),
                   jnp.stack([jnp.asarray(ln["y"], jnp.int32)[None] for ln in lanes]))

    agent = agents[cfg["agent"]](default_params(**HP, **cfg, device="cpu"))
    agent.task_seen, agent.old_labels = task_seen, OLD_LABELS[: 4 * task_seen]
    tstates = []
    for ln in lanes:
        model = port_model(ln["params"], ln["stats"])
        tstates.append(TrainState(
            model=model, optimizer=setup_opt("SGD", model.parameters(), HP["learning_rate"]),
            buffer=ln["tbuf"], generator=torch.Generator(),
            agent=interop.agent_from_jax(ln["ag"], model) if ln["ag"] is not None else None))
    ss = _stack(tstates)
    draws = None
    if j_agent.uses_buffer:
        lane_draws = [aser_port_draws("aser", ln["key"]) if name == "er_aser"
                      else port_draws(agent, ln["key"]) for ln in lanes]
        draws = _tstack(lane_draws)
    # every lane is handed the same labels (ctx is shared in ocl_tpu's vmap)
    tctx = stack_ctx(agent.before_train(lanes[0]["y"]), LANES)
    agent.stacked_step(ss, tctx, torch.stack([torch.from_numpy(ln["x"]) for ln in lanes]),
                       torch.stack([torch.from_numpy(ln["y"]) for ln in lanes]), draws=draws)
    return jstate, ss, agent, j_agent


def assert_lanes_close(jstate, ss):
    got = interop.stacked_to_jax(ss.model)
    want = jax.tree_util.tree_map(np.asarray, (jstate.params, jstate.batch_stats))
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert a.shape[0] == LANES
        np.testing.assert_allclose(a, b, **TOL)
    if ss.buffer is not None:
        for p in range(LANES):
            assert_buffers_equal(_lane(jstate.buffer, p), ss.buffer.point(p))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_stacked_step_matches_vmapped_ocl_tpu(jax_vmapped, monkeypatch, name):
    jstate, ss, agent, j_agent = run_stacked_both(jax_vmapped, name, monkeypatch)
    assert_lanes_close(jstate, ss)
    if name == "lwf":
        # the teacher normalises with batch statistics and folds nothing
        teacher = interop.stacked_to_jax(ss.agent["teacher"])
        for a, b in zip(jax.tree_util.tree_leaves(teacher),
                        jax.tree_util.tree_leaves((jstate.agent["teacher_params"],
                                                   jstate.agent["teacher_stats"]))):
            np.testing.assert_array_equal(a, np.asarray(b))
    if name == "ewc":
        got = interop.stacked_agent_to_jax(ss.agent)
        for tree in ("running_fisher", "tmp_fisher"):
            for a, b in zip(jax.tree_util.tree_leaves(got[tree]),
                            jax.tree_util.tree_leaves(jstate.agent[tree])):
                np.testing.assert_allclose(a, np.asarray(b), **TOL)
        # after the task: each lane's Fisher min-max normalised on its own
        j_agent.new_labels = agent.new_labels = [1, 3]
        jstate = j_agent.after_train_stacked(jstate, None)
        agent.after_train_stacked(ss, None)
        got = interop.stacked_agent_to_jax(ss.agent)
        for tree in ("normalized_fisher", "prev_params"):
            for a, b in zip(jax.tree_util.tree_leaves(got[tree]),
                            jax.tree_util.tree_leaves(jstate.agent[tree])):
                np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-6)
        for p in range(LANES):
            flat = np.concatenate([a[p].ravel() for a in
                                   jax.tree_util.tree_leaves(got["normalized_fisher"])])
            assert flat.min() == 0.0 and abs(flat.max() - 1.0) < 1e-6
        assert got["has_prev"].tolist() == [1.0, 1.0]


@pytest.mark.parametrize("masked", [False, True])
def test_stacked_forwards_match_separate_forwards(masked):
    """forward_train (its BN fold into each point's own buffers, rows masked
    out or not, and the all-masked point that folds nothing),
    forward_eval, features_eval and the teacher's forward over 3 stacked
    models against 3 separate forwards."""
    from ocl_tpu_torch.models import (bind, features_eval, forward_eval, forward_teacher,
                                      forward_train, snapshot, stack_models)

    def stacked_call(st, fn, *args):   # fn(model, *args) for every point, vmapped
        def one(tensors, *a):
            with bind(st.base, tensors) as model:
                return fn(model, *a)

        return torch.func.vmap(one)(st.tensors(), *args)

    models = [port_model(*random_weights(21 + 10 * p)) for p in range(3)]
    st = stack_models(models)
    teachers = stack_models([snapshot(m) for m in models])
    g = np.random.RandomState(0)
    x = torch.from_numpy(g.rand(3, 12, 32, 32, 3).astype(np.float32))
    w = torch.from_numpy(g.rand(3, 12) > 0.3) if masked else torch.ones(3, 12, dtype=torch.bool)
    if masked:
        w[2] = False
    got = stacked_call(st, forward_train, x, w)
    want = torch.stack([forward_train(m, x[p], w[p]) for p, m in enumerate(models)])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    for n, b in st.buffers.items():
        torch.testing.assert_close(b, torch.stack([dict(m.named_buffers())[n] for m in models]),
                                   rtol=1e-6, atol=1e-7)
    for fn in (forward_eval, features_eval):
        torch.testing.assert_close(stacked_call(st, fn, x),
                                   torch.stack([fn(m, x[p]) for p, m in enumerate(models)]),
                                   rtol=1e-5, atol=1e-5)
    before = {n: b.clone() for n, b in teachers.buffers.items()}
    torch.testing.assert_close(
        stacked_call(teachers, forward_teacher, x, w),
        torch.stack([forward_teacher(teachers.point(p), x[p], w[p]) for p in range(3)]),
        rtol=1e-5, atol=1e-5)
    for n, b in teachers.buffers.items():
        assert torch.equal(b, before[n])   # the teacher folds nothing


def test_stacked_interop_round_trips():
    """ocl_tpu's stacked weights and EWC agent tree (leaves [P, ...]) to the
    port's stacked state and back, exactly."""
    lanes = [random_weights(21 + 10 * p) for p in range(2)]
    params = _jstack([ln[0] for ln in lanes])
    stats = _jstack([ln[1] for ln in lanes])
    st = interop.stacked_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                  jax.tree_util.tree_map(np.asarray, stats), port_model(*lanes[0]))
    for a, b in zip(jax.tree_util.tree_leaves(interop.stacked_to_jax(st)),
                    jax.tree_util.tree_leaves((params, stats))):
        np.testing.assert_array_equal(a, np.asarray(b))
    ag = jax.tree_util.tree_map(np.asarray, _jstack(
        [lane_agent_state("ewc", ln[0], 22 + p) for p, ln in enumerate(lanes)]))
    back = interop.stacked_agent_to_jax(interop.stacked_agent_from_jax(ag, port_model(*lanes[0])))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(ag)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(ag)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_ewc_fisher_is_normalised_per_point_not_over_the_stack():
    """One lane's Fisher scaled up 1000x leaves the other lane's normalised
    Fisher as it was: a reduction over all stacked leaves would not."""
    agent = agents["EWC"](default_params(**HP, **CONFIGS["ewc"], device="cpu"))
    states = [agent.init_state(s) for s in (1, 2)]
    for s, scale in zip(states, (1.0, 1000.0)):
        g = torch.Generator().manual_seed(int(scale))
        for f in s.agent["running_fisher"].values():
            f.copy_(torch.rand(f.shape, generator=g) * scale)
    want = []
    for s in states:
        agent.after_train(s, None)
        want.append(s.agent["normalized_fisher"])
    ss = _stack([agent.init_state(s) for s in (1, 2)])
    for name, f in ss.agent["running_fisher"].items():
        f.copy_(torch.stack([s.agent["running_fisher"][name] for s in states]))
    agent.after_train_stacked(ss, None)
    for name, f in ss.agent["normalized_fisher"].items():
        for p in range(2):
            torch.testing.assert_close(f[p], want[p][name], rtol=1e-6, atol=1e-7)


# ------------------------------------------------- stacked against sequential

RUN_ARGS = ["--device", "cpu", "--data", "synthetic", "--agent", "ER", "--nf", "4",
            "--num_tasks", "2", "--synthetic_size", "20", "--mem_size", "30",
            "--num_runs", "3", "--learning_rate", "0.01", "--verbose", "False"]


def run_params(*extra):
    return finalize(build_parser().parse_args(RUN_ARGS + list(extra)))


def test_stacked_runs_see_the_sequential_runs_streams_shuffles_and_draws(monkeypatch):
    """Every batchify and draw of the stacked runner, grouped by run, equals
    the sequential runner's for that run, exactly: the same task streams,
    the same shuffles, the same draws from init_state(seed + r)."""
    records = {"batchify": [], "draw": []}
    batchify, draw = ExperienceReplay.batchify, ExperienceReplay.draw

    def rec_batchify(self, state, x, y, batch_size=None):
        out = batchify(self, state, x, y, batch_size)
        records["batchify"].append((state.generator, out))
        return out

    def rec_draw(self, generator, b):
        out = draw(self, generator, b)
        records["draw"].append((generator, out))
        return out

    monkeypatch.setattr(ExperienceReplay, "batchify", rec_batchify)
    monkeypatch.setattr(ExperienceReplay, "draw", rec_draw)

    def by_generator(recs):
        groups = {}   # the records keep each generator alive, so ids stay unique
        for gen, out in recs:
            groups.setdefault(id(gen), []).append(out)
        return list(groups.values())

    parallel_run.multiple_run_parallel(run_params("--parallel_runs", "True"))
    stacked = {k: by_generator(v) for k, v in records.items()}
    records = {"batchify": [], "draw": []}
    multiple_run(run_params())
    seq = {k: by_generator(v) for k, v in records.items()}
    for kind in ("batchify", "draw"):
        assert len(stacked[kind]) == len(seq[kind]) == 3
        for a, b in zip(stacked[kind], seq[kind]):
            assert len(a) == len(b) > 0
            for u, v in zip(a, b):
                torch.utils._pytree.tree_map(lambda s, t: torch.testing.assert_close(
                    s, t, rtol=0, atol=0), u, v)


def _three_states(agent, seeds):
    return [agent.init_state(s) for s in seeds]


def _task(seed, n=40):
    g = np.random.RandomState(seed)
    y = g.randint(0, 2, n)
    return torch.from_numpy(np.clip(0.5 + 0.3 * (y[:, None, None, None] - 0.5) +
                                    g.normal(0, 0.2, (n, 32, 32, 3)), 0, 1).astype(np.float32)), \
        torch.from_numpy(y)


@pytest.mark.parametrize("extra", [[], ["--update", "ASER", "--retrieve", "ASER"]],
                         ids=["fused", "aser"])
def test_permuting_lanes_permutes_results_exactly(extra):
    """Three runs stacked in two orders, each lane with its own batches and
    draws: the results are the same permutation of each other, bit for
    bit (no point reads another's tensors)."""
    params = run_params(*extra)
    agent = agents["ER"](params)
    seeds, perm = (5, 6, 7), [2, 0, 1]
    x, y = _task(3)
    xs = torch.stack([x[torch.randperm(40, generator=torch.Generator().manual_seed(s))]
                      for s in seeds]).reshape(3, 4, 10, 32, 32, 3)
    ys = torch.stack([y[torch.randperm(40, generator=torch.Generator().manual_seed(s))]
                      for s in seeds]).reshape(3, 4, 10)
    ctx = stack_ctx(agent.before_train(y.numpy()), 3)
    gens = [torch.Generator().manual_seed(s) for s in seeds]
    draws = [[agent.draw(g, 10) for g in gens] for _ in range(4)]
    outs = []
    for order in ([0, 1, 2], perm):
        ss = _stack([_three_states(agent, seeds)[i] for i in order])
        ss.buffer.current_index, ss.buffer.n_seen_so_far = 0, 0
        for i in range(4):
            agent.stacked_step(ss, ctx, xs[order, i], ys[order, i],
                               draws=_tstack([draws[i][j] for j in order]))
        outs.append(ss)
    a, b = outs
    for t, u in zip(list(a.model.params.values()) + list(a.model.buffers.values()) +
                    list(a.buffer.tensors()),
                    list(b.model.params.values()) + list(b.model.buffers.values()) +
                    list(b.buffer.tensors())):
        assert torch.equal(t[perm], u)


PAIRED = {
    "er_fused": ("ER", []),
    "er_two_pass": ("ER", ["--fused_replay", "False"]),
    "er_aser": ("ER", ["--update", "ASER", "--retrieve", "ASER"]),
    "er_mir": ("ER", ["--retrieve", "MIR", "--subsample", "20", "--fused_replay", "False"]),
    # a buffer of 10 is full after the first step: the second takes GSS's
    # gated replacement
    "er_gss": ("ER", ["--update", "GSS", "--gss_mem_strength", "3", "--gss_batch_size", "5",
                      "--mem_size", "10"]),
    "er_match": ("ER", ["--retrieve", "match", "--warmup", "0"]),
    "er_mem_match": ("ER", ["--retrieve", "mem_match", "--warmup", "0", "--fused_replay",
                            "False"]),
    "agem": ("AGEM", []),
    "agem_mir": ("AGEM", ["--retrieve", "MIR", "--subsample", "20"]),
    "ewc": ("EWC", []),
    "lwf": ("LWF", []),
}


@pytest.mark.parametrize("case", list(PAIRED))
def test_one_paired_step_agrees_with_the_sequential_runs(case):
    """Three runs from seeds 5-7 take a step, then are stacked; one more step
    of the stacked runs against each sequential run, with a filled buffer, a
    distillation teacher that differs from the weights and task_seen 1, each
    run with its own draws: the weights agree to the rounding of grouped
    convolutions, the buffers exactly."""
    agent_name, extra = PAIRED[case]
    params = run_params("--agent", agent_name, *extra)
    agent = agents[agent_name](params)
    seq = _three_states(agent, (5, 6, 7))
    x, y = _task(4)
    for s in seq:
        agent.step(s, agent.before_train(y.numpy()), x[:10], y[:10])
        if agent.needs_kd:
            with torch.no_grad():
                for q in s.agent["teacher"].parameters():
                    q.mul_(0.9)
            s.agent["has_teacher"].fill_(1.0)
    ss = _stack(seq)
    agent.end_task_labels()
    ctx = agent.before_train(y.numpy())
    assert ctx.task_seen == 1
    draws = [agent.draw(torch.Generator().manual_seed(10 + r), 10)
             if agent.uses_buffer else None for r in range(3)]
    xb, yb = x[10:20], y[10:20]
    for s, d in zip(seq, draws):
        agent.step(s, ctx, xb, yb, draws=d)
    agent.stacked_step(ss, stack_ctx(ctx, 3), xb.expand(3, *xb.shape), yb.expand(3, *yb.shape),
                       draws=_tstack(draws) if agent.uses_buffer else None)
    for p, s in enumerate(seq):
        got = point_state(ss, p, params)
        for (n, a), b in zip(s.model.state_dict().items(), got.model.state_dict().values()):
            torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-6,
                                       msg=lambda m, n=n: "{}: {}".format(n, m))
        if s.buffer is not None:
            assert s.buffer.current_index == min(20, params.mem_size)
            assert torch.equal(got.buffer.imgs, s.buffer.imgs)
            assert torch.equal(got.buffer.labels, s.buffer.labels)
            assert torch.equal(got.buffer.class_counts, s.buffer.class_counts)


def test_stacked_task_with_lr_0_point_stays_bit_identical():
    """An lr-0 point of a stacked task keeps its weights bit for bit while
    an lr-0.1 point moves (tests/test_parallel_tune.py:71's check)."""
    params = run_params("--mem_size", "20", "--batch", "4", "--eps_mem_batch", "4")
    agent = agents["ER"](params)
    s = agent.init_state(1000)
    init = {n: t.detach().clone() for n, t in s.model.named_parameters()}
    ss = _stack([s, s], lr=[0.0, 0.1], wd=[0.0, 0.0])
    g = np.random.RandomState(0)
    xs = torch.from_numpy(g.rand(4, 4, 32, 32, 3).astype(np.float32))
    ys = torch.from_numpy(g.randint(0, 2, (4, 4)))
    ctx = stack_ctx(agent.before_train(ys.numpy()), 2)
    agent.stacked_train_task(ss, ctx, xs.expand(2, *xs.shape), ys.expand(2, *ys.shape))
    deltas = [sum(float((ss.model.params[n][p].detach() - t).abs().sum()) for n, t in init.items())
              for p in range(2)]
    assert deltas[0] == 0.0
    assert deltas[1] > 1.0


@pytest.mark.parametrize("name", ["SGD", "Adam"])
def test_stacked_optimizer_matches_setup_opt(name):
    """Per-point SGD and Adam with per-point lr and wd, over three steps,
    against torch.optim from setup_opt point by point, within 1e-6."""
    g = torch.Generator().manual_seed(0)
    shapes = [(3, 4, 3, 3), (7,), (5, 2)]
    lrs, wds = [0.03, 0.1, 0.0], [0.01, 0.0, 0.001]
    leaves = [torch.randn((3,) + s, generator=g) for s in shapes]
    grads = [[torch.randn((3,) + s, generator=g) for s in shapes] for _ in range(3)]
    stacked = [t.clone().requires_grad_() for t in leaves]
    opt = StackedOptimizer(name, stacked, torch.tensor(lrs), torch.tensor(wds))
    for step in grads:
        for t, gr in zip(stacked, step):
            t.grad = gr.clone()
        opt.step()
    for p in range(3):
        ps = [torch.nn.Parameter(t[p].clone()) for t in leaves]
        ref = setup_opt(name, ps, lrs[p], wds[p])
        for step in grads:
            for q, gr in zip(ps, step):
                q.grad = gr[p].clone()
            ref.step()
        for q, t in zip(ps, stacked):
            torch.testing.assert_close(t[p].detach(), q.detach(), rtol=0, atol=1e-6)


def test_general_main_runs_three_stacked_runs():
    """The CLI of the acceptance criteria, at its size: the aggregate
    throughput line and the Avg_End_Acc line with a finite CI over 3 runs."""
    from ocl_tpu_torch.general_main import main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = main(build_parser().parse_args(
            ["--device", "cpu", "--data", "synthetic", "--agent", "ER", "--nf", "4",
             "--num_tasks", "2", "--synthetic_size", "60", "--mem_size", "50",
             "--num_runs", "3", "--parallel_runs", "True", "--verbose", "False"]))
    text = out.getvalue()
    assert "3 stacked runs" in text
    assert "aggregate stream throughput" in text and "Avg_End_Acc" in text
    (acc, ci) = res[0]
    assert 0.0 <= acc <= 1.0 and np.isfinite(ci)


@pytest.mark.parametrize("flags,reason", [
    (["--agent", "ICARL"], "no stacked runner"),
    (["--agent", "SCR"], "no stacked runner"),
    (["--review_trick", "True"], "review_trick"),
    (["--ncm_trick", "True"], "NCM"),
    (["--error_analysis", "True"], "error_analysis"),
    (["--online", "False"], "offline"),
    (["--ckpt_dir", "ckpt"], "ckpt_dir"),
])
def test_unstackable_runs_go_to_multiple_run_with_a_reason(monkeypatch, capsys, flags, reason):
    called = []
    monkeypatch.setattr("ocl_tpu_torch.experiment.run.multiple_run",
                        lambda params, store=False, save_path=None: called.append(params))
    params = run_params(*flags)
    assert reason in parallel_run.unstackable(params)
    parallel_run.multiple_run_parallel(params)
    assert called == [params]
    assert "[parallel_runs]" in capsys.readouterr().out
