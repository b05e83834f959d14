"""The port's stacked grid tuner (ocl_tpu_torch/experiment/parallel_tune.py)
against ocl_tpu's (ocl_tpu/experiment/parallel_tune.py), and the stacked
iCaRL NCM and GDumb retrain against theirs.

* The memory gate agrees with ocl_tpu's, except where ocl_tpu gates on the
  default params instead of the effective ones (its fault, not copied).
* tune_hyper_parallel's control flow, with recording fake agents in both
  packages whose accuracies are a fixed function of lr, wd, seed, tasks
  trained and test set: the same points, seeds, batches, accuracies and
  winner.
* Stacked NCM means and correct counts against `_make_stacked_ncm` on the
  same stacked weights and buffers (rtol 1e-5), and --abl_ncm_zero_empty,
  which ocl_tpu's stacked NCM lacks, against the sequential `ncm_means`.
* GDumb: at one val run, the memory and minibatch order exactly, and the
  lr-0 point's retrain (weights exact, BN statistics rtol 1e-3 / atol 1e-4)
  against ocl_tpu's `stacked_train_task`; at two val runs, each run's memory
  is that of its sequential run, and the two differ (ocl_tpu builds both
  from run 0's draws).
* Real tiny stacked tunes of each grid-capable agent, and main_tune's CLI.
"""

import os
import random
import shutil
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ocl_tpu.experiment.parallel_tune as j_pt
import ocl_tpu.registry as j_registry
import ocl_tpu_torch.registry as registry
from ocl_tpu.agents.base import TrainState as JTrainState
from ocl_tpu.config import default_params as j_default_params
from ocl_tpu.experiment import tune as j_tune
from ocl_tpu.experiment.parallel_run import _stack as j_stack
from ocl_tpu.models import init_model as j_init_model
from ocl_tpu_torch import interop
from ocl_tpu_torch.agents.base import StackedState, TaskCtx, TrainState, stack_ctx
from ocl_tpu_torch.config import default_params
from ocl_tpu_torch.data import prepare_test_loaders
from ocl_tpu_torch.experiment import parallel_tune as pt
from ocl_tpu_torch.experiment import tune
from ocl_tpu_torch.experiment.parallel_run import _stack, point_state
from ocl_tpu_torch.models import stack_models
from ocl_tpu_torch.optim import StackedOptimizer, setup_opt
from ocl_tpu_torch.registry import agents
from test_torch_buffer import MEM, N_CLS, class_images, make_buffers
from test_torch_model import port_model, random_weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-3, atol=1e-4)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread: the suite's parallel workers share the host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------------- the gate

GATE_CASES = [
    (dict(agent="ER", retrieve="MIR"), {"learning_rate": [0.01, 0.1]}),
    (dict(agent="ER"), {"subsample": [10, 50]}),
    (dict(agent="ER"), {"learning_rate": [0.01, 0.1], "weight_decay": [0.0, 0.01]}),
    (dict(agent="ICARL"), {"learning_rate": [0.01, 0.1]}),
    (dict(agent="GDUMB"), {"learning_rate": [0.01, 0.1]}),
    (dict(agent="SCR"), {"learning_rate": [0.01, 0.1]}),
    (dict(agent="ER", review_trick=True), {"learning_rate": [0.01, 0.1]}),
    (dict(agent="GDUMB", ncm_trick=True), {"learning_rate": [0.01, 0.1]}),
    (dict(agent="ER"), {"learning_rate": [0.01, 0.1], "retrieve": ["MIR"]}),
    (dict(agent="ER", mem_size=10000, num_runs_val=10),
     {"learning_rate": [0.1] * 7, "weight_decay": [0.0] * 4}),
    (dict(agent="ER", num_runs_val=3),
     {"learning_rate": [0.1] * 7, "weight_decay": [0.0] * 4}),
]


@pytest.mark.parametrize("kw,grid", GATE_CASES)
def test_gate_agrees_with_ocl_tpu(kw, grid):
    p = dict(data="synthetic", **kw)
    assert pt.supports_parallel_grid(default_params(**p, device="cpu"), grid) == \
        j_pt.supports_parallel_grid(j_default_params(**p), grid)


def test_gate_bounds_memory_by_the_effective_mem_size():
    """A length-1 `mem_size: [10000]` in the grid overrides the default 1000
    for every point: 84 points then need ~15.8 GiB, over the budget.
    ocl_tpu estimates from the default params and lets it through."""
    p = dict(data="synthetic", agent="ER", num_runs_val=3, mem_size=1000)
    grid = {"learning_rate": [0.1] * 7, "weight_decay": [0.0] * 4, "mem_size": [10000]}
    assert pt.STACK_BYTES_BUDGET == j_pt.STACK_BYTES_BUDGET == 8 << 30
    assert j_pt.supports_parallel_grid(j_default_params(**p), grid)
    assert not pt.supports_parallel_grid(default_params(**p, device="cpu"), grid)
    assert pt.supports_parallel_grid(default_params(**p, device="cpu"),
                                     dict(grid, mem_size=[1000]))


# ------------------------------------------------------ control flow vs ocl_tpu

N_TEST = 200   # rows of each fake test set
GRID = {"learning_rate": [0.01, 0.1, 0.03], "weight_decay": [0.0, 0.001]}


def fake_score(lr, wd, seed, trained, j):
    """The fake accuracy, in float32 arithmetic both packages reproduce."""
    f = np.float32
    s = f(0.9) - f(100.0) * (f(lr) - f(0.03)) * (f(lr) - f(0.03)) - f(10.0) * f(wd)
    return s + f(0.001) * f(seed % 7) + f(0.002) * f(trained) - f(0.01) * f(j)


def fake_accuracy(score):
    return min(max(int(np.floor(np.float32(score) * np.float32(N_TEST))), 0), N_TEST) / N_TEST


class JFakeAgent:
    """ocl_tpu's side: the accuracy comes out of its own stacked eval_fn,
    through logits right on the first floor(score * N_TEST) rows (a row's
    image holds 10000 * test set + row)."""

    log = None
    ncm_classify = False
    stacked_consumes_raw = False
    n_classes = 10

    def __init__(self, params):
        self.params = params
        lr, wd = float(params.learning_rate), float(params.weight_decay)
        self.tx = SimpleNamespace(init=lambda p: {"lr": jnp.float32(lr), "wd": jnp.float32(wd)})

    def init_state(self, key):
        seed = int(np.asarray(key).reshape(-1)[-1])
        self.log.append(("init", seed))
        return JTrainState(params={"seed": jnp.float32(seed), "trained": jnp.float32(0),
                                   "lr": jnp.float32(0), "wd": jnp.float32(0)},
                           batch_stats={}, opt_state=None, buffer=None, agent=None, rng=key)

    def before_train(self, y):
        self.log.append(("before_train", int(np.asarray(y).sum())))
        return None

    def before_task_stacked(self, state):
        return state

    def batchify(self, state, x, y):
        self.log.append(("batchify", x.shape[0], float(np.asarray(x, np.float64).sum())))
        return state, jnp.asarray(x), jnp.asarray(y)

    def stacked_train_task(self, state, ctx, xs, ys):
        p = dict(state.params, trained=state.params["trained"] + 1,
                 lr=state.opt_state["lr"], wd=state.opt_state["wd"])
        return state.replace(params=p)

    def after_train_stacked(self, state, ctx):
        return state

    def forward_eval_logits(self, params, stats, xb):
        code = xb[:, 0, 0, 0].astype(jnp.int32)
        j, row = code // 10000, code % 10000
        f = jnp.float32
        lr, wd = params["lr"], params["wd"]
        s = f(0.9) - f(100.0) * (lr - f(0.03)) * (lr - f(0.03)) - f(10.0) * wd
        s = s + f(0.001) * jnp.mod(params["seed"], 7) + f(0.002) * params["trained"] \
            - f(0.01) * j.astype(jnp.float32)
        k = jnp.floor(s * f(N_TEST)).astype(jnp.int32)
        pred = jnp.where(row < k, row % 10, (row + 1) % 10)
        return jax.nn.one_hot(pred, 10)


class FakeAgent:
    """The port's side: the same accuracies from the stacked points' lr, wd,
    seed and tasks trained."""

    log = None
    stacked_consumes_raw = False
    device = torch.device("cpu")
    n_classes = 10

    def __init__(self, params):
        self.params = params

    def init_state(self, seed):
        self.log.append(("init", seed))
        return {"seed": seed}

    def before_train(self, y):
        self.log.append(("before_train", int(np.asarray(y).sum())))
        return TaskCtx(torch.zeros(10, dtype=torch.bool), torch.zeros(10, dtype=torch.bool), 0)

    def before_task_stacked(self, ss):
        return ss

    def batchify(self, state, x, y):
        self.log.append(("batchify", x.shape[0], float(np.asarray(x, np.float64).sum())))
        return torch.from_numpy(np.asarray(x)), torch.from_numpy(np.asarray(y))

    def stacked_train_task(self, ss, ctx, xs, ys):
        assert xs.shape[0] == ss.points
        ss.trained += 1
        return ss

    def after_train_stacked(self, ss, ctx):
        return ss

    def evaluate_stacked(self, ss, loaders):
        return np.array([[fake_accuracy(fake_score(ss.lr[p], ss.wd[p], ss.seeds[p],
                                                   ss.trained, j))
                          for j in range(len(loaders))] for p in range(ss.points)])


def fake_stack(states, lr=None, wd=None):
    return SimpleNamespace(points=len(states), seeds=[s["seed"] for s in states], lr=lr, wd=wd,
                           trained=0)


@pytest.fixture
def fake_agents(monkeypatch):
    logs = {"port": [], "ocl_tpu": []}
    monkeypatch.setitem(registry.agents, "ER", type("Fake", (FakeAgent,), {"log": logs["port"]}))
    monkeypatch.setitem(j_registry.agents, "ER",
                        type("JFake", (JFakeAgent,), {"log": logs["ocl_tpu"]}))
    monkeypatch.setattr(pt, "_stack", fake_stack)
    return logs


@pytest.mark.parametrize("runs_val", [1, 2])
def test_tune_hyper_parallel_control_flow_matches_ocl_tpu(fake_agents, capsys, runs_val):
    g = np.random.RandomState(0)
    tasks = [(g.rand(20, 32, 32, 3).astype(np.float32), g.randint(2 * t, 2 * t + 2, 20), None)
             for t in range(2)]
    codes = [(10000 * j + np.arange(N_TEST)).astype(np.float32) for j in range(2)]
    tests = [(np.broadcast_to(c[:, None, None, None], (N_TEST, 32, 32, 3)).copy(),
              np.arange(N_TEST) % 10) for c in codes]
    kw = dict(data="synthetic", agent="ER", seed=5, num_runs_val=runs_val, parallel_runs=True,
              test_batch=64, verbose=False)
    got = tune.tune_hyper(tasks, prepare_test_loaders(tests, default_params(**kw, device="cpu"),
                                                      "cpu"),
                          default_params(**kw, device="cpu"), GRID)
    port_out = capsys.readouterr().out
    from ocl_tpu.data import prepare_test_loaders as j_prepare

    want = j_tune.tune_hyper(tasks, j_prepare(tests, j_default_params(**kw)),
                             j_default_params(**kw), GRID)
    j_out = capsys.readouterr().out
    assert got == want
    assert fake_agents["port"] == fake_agents["ocl_tpu"]
    assert [e for e in fake_agents["port"] if e[0] == "init"] == \
        [("init", 5 + 1000 + r) for r in range(runs_val)]
    scores = [line for line in port_out.splitlines() if "-> avg_end_acc" in line]
    assert scores == [line for line in j_out.splitlines() if "-> avg_end_acc" in line]
    assert len(scores) == 6
    assert "6 grid points x {} val runs = {} stacked".format(runs_val, 6 * runs_val) in port_out


# ----------------------------------------------------------- iCaRL's NCM

ICARL_HP = dict(data="synthetic", agent="ICARL", mem_size=MEM, eps_mem_batch=10, batch=10,
                nf=4, verbose=False, test_batch=20)
SEEN = list(range(8))


def ncm_lanes():
    """Two lanes of (weights, buffer) whose buffers hold classes 0-7 only."""
    labels = np.arange(MEM) % 8
    lanes = []
    for p in range(2):
        params, stats = random_weights(21 + 10 * p)
        jbuf, tbuf = make_buffers(MEM, MEM, MEM, seed=23 + p, labels=labels)
        lanes.append((params, stats, jbuf, tbuf))
    g = np.random.RandomState(4)
    y = g.randint(0, 8, 50)
    return lanes, [(class_images(y, g), y)]


def port_ncm_state(agent, lanes):
    states = []
    for params, stats, _, tbuf in lanes:
        model = port_model(params, stats)
        states.append(TrainState(model=model, optimizer=setup_opt("SGD", model.parameters(), 0.1),
                                 buffer=tbuf, generator=torch.Generator().manual_seed(9),
                                 agent={"teacher": model}))
    return _stack(states)


def test_stacked_ncm_matches_ocl_tpu():
    lanes, tests = ncm_lanes()
    j_agent = j_registry.agents["ICARL"](j_default_params(**ICARL_HP))
    jstate = j_stack([JTrainState(params=jax.tree_util.tree_map(jnp.asarray, pr),
                                  batch_stats=jax.tree_util.tree_map(jnp.asarray, st),
                                  opt_state=None, buffer=jb, agent=None,
                                  rng=jax.random.PRNGKey(7 + p))
                      for p, (pr, st, jb, _) in enumerate(lanes)])
    means_fn, classify_fn = j_pt._make_stacked_ncm(j_agent)
    j_means = np.asarray(means_fn(jstate))
    seen = np.zeros(N_CLS, bool)
    seen[SEEN] = True
    from ocl_tpu.data import prepare_test_loaders as j_prepare

    (x, y, m), = j_prepare(tests, j_default_params(**ICARL_HP))
    j_correct = np.asarray(classify_fn(jstate, jnp.asarray(j_means), jnp.asarray(seen), x, y, m))

    agent = agents["ICARL"](default_params(**ICARL_HP, device="cpu"))
    agent.old_labels = SEEN
    ss = port_ncm_state(agent, lanes)
    means = agent.ncm_means_stacked(ss).numpy()
    np.testing.assert_allclose(means[:, SEEN], j_means[:, SEEN], rtol=1e-5, atol=1e-6)
    accs = agent.evaluate_stacked(ss, prepare_test_loaders(tests, agent.params, "cpu"))
    np.testing.assert_array_equal(np.rint(accs[:, 0] * 50).astype(int), j_correct)


def test_stacked_ncm_honours_abl_ncm_zero_empty():
    """With --abl_ncm_zero_empty an empty class's mean is 1e6 in every point,
    as the sequential ncm_means makes it; ocl_tpu's stacked NCM draws unit
    noise there instead."""
    lanes, _ = ncm_lanes()
    agent = agents["ICARL"](default_params(**ICARL_HP, device="cpu", abl_ncm_zero_empty=True))
    ss = port_ncm_state(agent, lanes)
    noise = ss.draw(lambda g: torch.randn(N_CLS, 32, generator=g))
    for g in ss.generators:
        g.manual_seed(9)
    got = agent.ncm_means_stacked(ss)
    assert (got[:, 8:] == 1e6).all()
    for p in range(2):
        want = agent.ncm_means(point_state(ss, p, agent.params), noise[p])
        torch.testing.assert_close(got[p], want, rtol=1e-5, atol=1e-6)

    j_agent = j_registry.agents["ICARL"](j_default_params(**ICARL_HP, abl_ncm_zero_empty=True))
    jstate = j_stack([JTrainState(params=jax.tree_util.tree_map(jnp.asarray, pr),
                                  batch_stats=jax.tree_util.tree_map(jnp.asarray, st),
                                  opt_state=None, buffer=jb, agent=None,
                                  rng=jax.random.PRNGKey(7 + p))
                      for p, (pr, st, jb, _) in enumerate(lanes)])
    j_means = np.asarray(j_pt._make_stacked_ncm(j_agent)[0](jstate))
    np.testing.assert_allclose(np.linalg.norm(j_means[:, 8:], axis=-1), 1.0, rtol=1e-5)


# ------------------------------------------------------------------ GDumb

GDUMB_HP = dict(data="synthetic", agent="GDUMB", batch=10, mem_epoch=1, clip=10.0, nf=4,
                verbose=False)


def gdumb_task(seed=3, n=40):
    g = np.random.RandomState(seed)
    y = g.randint(0, 2, n)
    return class_images(y, g), y


def test_gdumb_stacked_retrain_matches_ocl_tpu():
    """One val run, two points at lr 0 and 0.01, a memory the task never
    overflows (ocl_tpu evicts with Python's unseeded global random): the
    port's greedy memory in ocl_tpu's order equals ocl_tpu's, and its stacked
    retrain on ocl_tpu's minibatch order and per-point inits ends where
    ocl_tpu's does for the lr-0 point: its weights stay their init bit for
    bit in both, its BN statistics fold alike. (The lr-0.01 point trains;
    over four steps at nf 4 with ocl_tpu's init, weights that differ by
    rounding part at ReLU inputs near zero, as
    test_torch_agents.py::test_gdumb_retrain_matches_ocl_tpu describes.)"""
    x, y = gdumb_task()
    hp = dict(GDUMB_HP, mem_size=60)
    j_ags = [j_registry.agents["GDUMB"](j_default_params(**hp, learning_rate=lr, inject_hp=True))
             for lr in (0.0, 0.01)]
    j0 = j_ags[0]
    s = j0.init_state(jax.random.PRNGKey(1000))
    jstate = j_stack([s.replace(opt_state=a.tx.init(s.params)) for a in j_ags])
    ctx = j0.before_train(y)
    out = j0.stacked_train_task(jstate, ctx, x, y)

    splits = jax.vmap(lambda r: jax.random.split(r, 3))(jstate.rng)
    order = np.asarray(jax.random.permutation(splits[0, 1], x.shape[0]))
    pair = jax.vmap(lambda r: jax.random.split(r))(splits[:, 0])
    j_mem_y = np.concatenate([[c] * j0.mem_c[c] for c in j0.mem_img])
    perm = np.asarray(jax.random.permutation(pair[0, 1], len(j_mem_y)))
    idx = torch.from_numpy(perm[: 40].reshape(4, 10).astype(np.int64))
    inits = [jax.tree_util.tree_map(np.asarray, j_init_model(j0.module, splits[p, 2], "synthetic"))
             for p in range(2)]

    agent = agents["GDUMB"](default_params(**hp, device="cpu"))
    for i in order:
        agent.greedy_balancing_update(x[i], int(y[i]), rng=None)
    mem_x, mem_y = agent.memory()
    np.testing.assert_array_equal(mem_y.numpy(), j_mem_y)
    np.testing.assert_array_equal(mem_x.numpy(),
                                  np.concatenate([np.stack(j0.mem_img[c]) for c in j0.mem_img]))
    model = stack_models([port_model(*inits[p]) for p in range(2)])
    init0 = {n: t[0].clone() for n, t in model.params.items()}
    ss = StackedState(model=model, optimizer=StackedOptimizer(
        "SGD", model.params.values(), torch.tensor([0.0, 0.01]), torch.tensor([0.0, 0.0])),
        buffer=None, generators=[None], hosts=[None], lane=[0, 0])
    agent.retrain_stacked(ss, stack_ctx(agent.before_train(y), 2), mem_x.expand(2, *mem_x.shape),
                          mem_y.expand(2, *mem_y.shape), idx.expand(2, *idx.shape))
    for n, t in init0.items():
        assert torch.equal(ss.model.params[n][0], t)
        assert not torch.equal(ss.model.params[n][1], t)   # the lr-0.01 point trained
    got = interop.stacked_to_jax(ss.model)
    want = jax.tree_util.tree_map(np.asarray, (out.params, out.batch_stats))
    init = [jax.tree_util.tree_map(np.asarray, t) for t in inits[0]]
    # the lr-0 point: weights its init in both packages, BN statistics folded
    # over the same minibatches in the same order
    for a, b, c in zip(jax.tree_util.tree_leaves(got[0]), jax.tree_util.tree_leaves(want[0]),
                       jax.tree_util.tree_leaves(init[0])):
        np.testing.assert_array_equal(b[0], c)
        np.testing.assert_array_equal(a[0], c)
    for a, b in zip(jax.tree_util.tree_leaves(got[1]), jax.tree_util.tree_leaves(want[1])):
        np.testing.assert_allclose(a[0], b[0], **TOL)


def test_gdumb_val_runs_keep_their_own_memory():
    """Two val runs of two grid points each: each run's memory is the one
    its sequential run builds from its own draws (evictions included), and
    the two runs' memories differ."""
    x, y = gdumb_task(n=60)
    p = default_params(**GDUMB_HP, mem_size=20, device="cpu")
    agent = agents["GDUMB"](p)
    states = [agent.init_state(1000 + r) for r in range(2)]
    ss = _stack([states[r] for r in (0, 0, 1, 1)], lr=[0.01, 0.1] * 2, wd=[0.0] * 4)
    assert ss.lane == [0, 0, 1, 1]
    agent.stacked_train_task(ss, stack_ctx(agent.before_train(y), 4), x, y)
    mems = []
    for r in range(2):
        agent.mem_img, agent.mem_c = agent.lane_memory[r]
        mems.append(agent.memory())
        seq = agents["GDUMB"](p)
        st = seq.init_state(1000 + r)
        seq.train_task(st, seq.before_train(y), x, y)
        want = seq.memory()
        assert torch.equal(mems[r][0], want[0]) and torch.equal(mems[r][1], want[1])
        assert sum(agent.mem_c.values()) == 20
    assert not torch.equal(mems[0][0], mems[1][0])


# ----------------------------------------------------- real tiny stacked tunes

def _stream(n_tasks=2, per_task=40, seed=0):
    g = np.random.RandomState(seed)
    out = []
    for t in range(n_tasks):
        y = g.randint(2 * t, 2 * t + 2, per_task)
        out.append((class_images(y, g), y, None))
    return out


@pytest.mark.parametrize("agent_name,kw", [
    ("ER", {}), ("ER", dict(update="ASER", retrieve="ASER")), ("AGEM", {}),
    ("EWC", {}), ("LWF", {}), ("ICARL", {}), ("GDUMB", dict(mem_epoch=2, clip=10.0))])
def test_stacked_tune_picks_a_grid_point(agent_name, kw, capsys):
    p = default_params(data="synthetic", agent=agent_name, mem_size=40, batch=10,
                       eps_mem_batch=10, nf=4, verbose=False, num_runs_val=2,
                       parallel_runs=True, test_batch=20, device="cpu", **kw)
    g = np.random.RandomState(1)
    ys = [g.randint(0, 4, 20) for _ in range(2)]
    loaders = prepare_test_loaders([(class_images(y, g), y) for y in ys], p, "cpu")
    grid = {"learning_rate": [0.01, 0.1], "weight_decay": [0.0, 0.001]}
    best = tune.tune_hyper(_stream(), loaders, p, grid)
    assert best in tune.parameter_grid(grid)
    out = capsys.readouterr().out
    assert "4 grid points x 2 val runs = 8 stacked tuning states" in out


def test_main_tune_runs_a_tiny_stacked_tune(tmp_path, monkeypatch, capsys):
    """main_tune with --parallel_runs True: config/general_1.yml cut to one
    run and one tuning task, two val runs, a 2 x 2 grid, at nf 4."""
    from ocl_tpu_torch.main_tune import build_parser, main

    (tmp_path / "config").mkdir()
    shutil.copy(os.path.join(REPO, "config", "global.yml"), tmp_path / "config")
    with open(os.path.join(REPO, "config", "general_1.yml")) as f:
        general = f.read()
    cuts = {"num_runs: 5": "num_runs: 1", "num_val: 2": "num_val: 1",
            "num_runs_val: 3": "num_runs_val: 2"}
    for old, new in cuts.items():
        assert old in general
        general = general.replace(old, new)
    (tmp_path / "general.yml").write_text(general)
    (tmp_path / "data.yml").write_text(
        "parameters:\n  data: synthetic\n  cl_type: nc\n  num_tasks: 3\n  synthetic_size: 20\n")
    (tmp_path / "tune.yml").write_text(
        "parameters:\n  learning_rate:\n  - 0.05\n  - 0.1\n  weight_decay:\n  - 0.0\n  - 0.0001\n")
    monkeypatch.chdir(tmp_path)
    random_state = random.getstate()   # main seeds the process's global generator
    try:
        result = main(build_parser().parse_args([
            "--general", "general.yml", "--data", "data.yml",
            "--default", os.path.join(REPO, "config", "agent", "er", "er_1k.yml"),
            "--tune", "tune.yml", "--device", "cpu", "--nf", "4", "--parallel_runs", "True"]))
    finally:
        random.setstate(random_state)
    out = capsys.readouterr().out
    assert "4 grid points x 2 val runs = 8 stacked tuning states" in out
    assert result["best_params"][0]["learning_rate"] in (0.05, 0.1)
    assert result["best_params"][0]["weight_decay"] in (0.0, 0.0001)
    assert "Tuning is done." in out
