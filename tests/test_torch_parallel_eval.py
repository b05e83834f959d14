"""The evaluation fan-out (agents/base.py::evaluate with `eval_mesh`,
parallel/dp.py::make_dp_eval) at W = 2 and 4: each rank holds its rows of
every test batch, the NCM exemplar sweep splits the buffer's rows, and the
counts are summed over the ranks.

The correct counts must equal ocl_tpu's `make_dp_eval` over W virtual CPU
devices and the port's unsharded evaluation, exactly: softmax, NCM (every
seen class has exemplars, so no noise mean enters) against ocl_tpu's
sharded NCM, and --error_analysis (its counts and `confusion` pickle)
against the port's own. A test batch that W does not divide raises in the
ranks, and the launch raises with it.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_workers as workers
from ocl_tpu.agents.base import TrainState as JTrainState
from ocl_tpu.config import default_params as j_default_params
from ocl_tpu.data import prepare_test_loaders as j_prepare_test_loaders
from ocl_tpu.parallel.dp import make_dp_eval
from ocl_tpu.parallel.mesh import get_mesh
from ocl_tpu.registry import agents as j_agents
from ocl_tpu_torch import interop
from ocl_tpu_torch.config import default_params
from ocl_tpu_torch.data import prepare_test_loaders
from test_torch_buffer import N_CLS, class_images, make_buffers
from test_torch_model import random_weights
from test_torch_parallel_dp import NF, buffer_spec, launch_cpu

HP = dict(data="synthetic", agent="ER", mem_size=64, eps_mem_batch=8, nf=NF, test_batch=16,
          verbose=False)


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def make_case(w, tmp_path):
    params, stats = random_weights(90 + w)
    jbuf, tbuf = make_buffers(64, 64, 64, seed=91 + w)
    g = np.random.RandomState(92 + w)
    # the second task's 40 images leave 8 padded rows in its last batch
    tests = [(class_images(lab, g), lab) for lab in
             (g.randint(0, N_CLS, 48), g.randint(0, N_CLS, 40))]
    spec = {"params": HP, "state_dict": interop.from_jax(params, stats),
            "ctx_y": np.arange(N_CLS)}
    case = {"softmax": spec,
            "ncm": dict(spec, params=dict(HP, ncm_trick=True), buffer=buffer_spec(tbuf),
                        old_labels=list(range(N_CLS))),
            "errors": dict(spec, params=dict(HP, error_analysis=True), task_seen=2,
                           old_labels=list(range(N_CLS))),
            "loaders": prepare_test_loaders(tests, default_params(**HP, device="cpu"), "cpu"),
            "noise": torch.zeros(N_CLS, NF * 8), "cwd": str(tmp_path)}
    mesh = get_mesh(w)
    j_agent = j_agents["ER"](j_default_params(**HP))
    j_loaders = j_prepare_test_loaders(tests, j_agent.params)
    fn = make_dp_eval(j_agent, mesh)
    with mesh:
        want = {"correct": [int(fn(_jnp(params), _jnp(stats), *loader)) for loader in j_loaders]}
        n_agent = j_agents["ER"](j_default_params(**HP, ncm_trick=True, n_devices=w))
        n_agent.old_labels = list(range(N_CLS))
        jstate = JTrainState(params=_jnp(params), batch_stats=_jnp(stats), opt_state=None,
                             buffer=jbuf, agent=None, rng=jax.random.PRNGKey(w))
        want["ncm"] = n_agent.evaluate(jstate, j_loaders)
        assert ("ncm", w) in n_agent._eval_cache
    return case, want


def plain(case, tmp_path):
    """The port's unsharded evaluation of the same cases, on one thread."""
    import os

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    cwd = os.getcwd()
    try:
        out = {}
        agent, state, _ = workers.build(case["softmax"])
        out["softmax"] = agent.evaluate(state, case["loaders"])
        n_agent, n_state, _ = workers.build(case["ncm"])
        out["ncm"] = n_agent._evaluate_ncm(n_state, case["loaders"], case["noise"])
        e_agent, e_state, _ = workers.build(case["errors"])
        os.chdir(tmp_path)
        out["errors"] = (e_agent.evaluate(e_state, case["loaders"]), e_agent.error_list)
        with open("confusion", "rb") as f:
            out["confusion"] = pickle.load(f)
        return out
    finally:
        os.chdir(cwd)
        torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=[2, 4], ids=["w2", "w4"])
def fan_out(request, tmp_path_factory):
    w = request.param
    ranks_dir, plain_dir = tmp_path_factory.mktemp("ranks"), tmp_path_factory.mktemp("plain")
    case, want = make_case(w, ranks_dir)
    ranks = launch_cpu(workers.eval_checks, (case,), w)
    with open(ranks_dir / "confusion", "rb") as f:
        confusion = pickle.load(f)
    return case, ranks, plain(case, plain_dir), want, confusion


def test_softmax_fan_out_matches_ocl_tpu_and_unsharded(fan_out):
    case, ranks, port, want, _ = fan_out
    totals = [int(m.sum()) for _, _, m in case["loaders"]]
    for r in ranks:
        np.testing.assert_array_equal(r["softmax"], port["softmax"])
        np.testing.assert_array_equal(r["softmax"], np.array(want["correct"]) / totals)


def test_ncm_fan_out_matches_ocl_tpu_and_unsharded(fan_out):
    _, ranks, port, want, _ = fan_out
    for r in ranks:
        np.testing.assert_array_equal(r["ncm"], port["ncm"])
        np.testing.assert_array_equal(r["ncm"], np.asarray(want["ncm"]))


def test_error_analysis_fan_out_matches_unsharded(fan_out):
    """Every rank gathers the logits: the same accuracies and old/new error
    counts on every rank, and rank 0's `confusion` pickle is the unsharded
    one."""
    _, ranks, port, _, confusion = fan_out
    for r in ranks:
        np.testing.assert_array_equal(r["errors"][0], port["errors"][0])
        assert r["errors"][1] == port["errors"][1]
    assert confusion == port["confusion"]


def test_indivisible_test_batch_raises(tmp_path):
    """15 test rows over 2 ranks: the ValueError names both numbers, and
    the launch ends with it (no rank goes on alone)."""
    case, _ = make_case(2, tmp_path)
    hp = dict(HP, test_batch=15)
    case["loaders"] = prepare_test_loaders(
        [(np.zeros((30, 32, 32, 3), np.float32), np.zeros(30, np.int64))],
        default_params(**hp, device="cpu"), "cpu")
    with pytest.raises(Exception, match="15 test batch rows cannot be split over 2 ranks"):
        launch_cpu(workers.eval_checks, (case,), 2)


def test_a_launch_past_its_limit_stops_every_rank():
    """A rank that hangs: the launch kills the ranks at its limit and raises,
    well before the rank would have returned."""
    import time

    t0 = time.time()
    with pytest.raises(TimeoutError, match="did not finish within 8 s"):
        launch_cpu(workers.linger, (600, 1), 2, limit_s=8)
    assert time.time() - t0 < 60
