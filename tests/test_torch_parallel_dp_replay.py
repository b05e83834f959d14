"""ER's replay strategies data-parallel over a slot-sharded buffer
(ocl_tpu_torch/parallel/dp.py): MIR, match, mem_match, and MIR retrieval
with the ASER update, at W = 2 and 4, batch and retrieved rows 2 W (mem_match
W + W), a memory of 8 W slots (tests/test_parallel_equivalence.py's sizes).

  * one step against ocl_tpu's `make_dp_train_task` on the virtual CPU
    devices: loss within 1e-5, parameters and BN statistics within 1e-3,
    the buffer's counter and labels exact, its images within 1e-6;
  * three steps against the port's unsharded steps: the buffer exact, the
    parameters within 3x a 1e-7 control's divergence;
  * every rank bit for bit the same;
  * MIR's retrieval alone, its subsample of 11 rows split over the ranks
    with masked padding: the unsharded picks exactly, and the BN running
    statistics its pre forward folds within 1e-5 (had every rank forwarded
    all 11 rows, the running variance would take n W / (n W - 1)).

Each W's ranks run every case in one launch (one thread a rank, 120 s).
"""

import numpy as np
import pytest
import torch

import torch_parallel_workers as workers
from test_torch_parallel_dp import (NF, assert_matches_ocl_tpu_dp, assert_ranks_bit_identical,
                                    assert_within_control, dp_case, launch_cases)

WS = (2, 4)


def case_args(name, w):
    """dp_case's arguments of case `name` at W = w."""
    mem, b = 8 * w, 2 * w
    hp = dict(data="synthetic", agent="ER", mem_size=mem, eps_mem_batch=b, batch=b, nf=NF,
              learning_rate=0.01, verbose=False)
    by_class = np.arange(mem) % 4   # every class of batches from classes 0-3 has exemplars
    return {
        "mir": (dict(hp, retrieve="MIR", subsample=11), dict(fill=mem, n_seen=3 * mem)),
        "match": (dict(hp, retrieve="match"),
                  dict(fill=mem, n_seen=3 * mem, labels=by_class, n_classes=4)),
        "mem_match": (dict(hp, retrieve="mem_match", eps_mem_batch=w),
                      dict(fill=mem, n_seen=3 * mem, labels=by_class, n_classes=4)),
        "mir_aser": (dict(hp, retrieve="MIR", subsample=11, update="ASER", k=2, n_smp_cls=1.0),
                     dict(fill=mem, n_seen=3 * mem, xla_order=True)),
    }[name]


NAMES = ("mir", "match", "mem_match", "mir_aser")
CASES = [(n, w) for w in WS for n in NAMES]


def mir_grads(spec, seed):
    """Batch gradients for MIR's virtual step, by parameter name."""
    g = np.random.RandomState(seed)
    return {k: (0.1 * g.randn(*v.shape)).astype(np.float32)
            for k, v in spec["state_dict"].items() if not k.endswith(("running_mean", "running_var",
                                                                      "num_batches_tracked"))}


@pytest.fixture(scope="module")
def cases():
    """{W: {name: (specs, ocl_tpu's one-step result)}}, {W: MIR's retrieval
    (spec, grads)} and each W's ranks' results."""
    out, retrievals, ranks = {}, {}, {}
    for w in WS:
        out[w] = {n: dp_case(*case_args(n, w)[:1], w, 90 + 10 * NAMES.index(n) + w,
                             **case_args(n, w)[1]) for n in NAMES}
        spec = out[w]["mir"][0]
        retrievals[w] = {"mir_retrieval": (spec, mir_grads(spec, 7))}
        ranks[w] = launch_cases(out[w], w, retrievals[w])
    return out, retrievals, ranks


@pytest.mark.parametrize("name,w", CASES)
def test_dp_replay_step_matches_ocl_tpu_dp(cases, name, w):
    out, _, ranks = cases
    _, (jstate, jm) = out[w][name]
    got = ranks[w][0][name]["first"]
    assert_matches_ocl_tpu_dp(got, jstate, jm)
    if name in ("match", "mem_match"):   # past the warm-up: the memory pass ran
        assert got["buffer"]["n_seen"] > 4 * out[w][name][0]["params"]["eps_mem_batch"]


@pytest.mark.parametrize("name,w", CASES)
def test_dp_replay_three_steps_within_control(cases, name, w):
    out, _, ranks = cases
    assert_within_control(ranks[w][0][name], out[w][name][0])


@pytest.mark.parametrize("w", WS)
def test_dp_replay_ranks_stay_bit_identical(cases, w):
    assert_ranks_bit_identical(cases[2][w])


@pytest.mark.parametrize("w", WS)
def test_dp_mir_retrieval_folds_the_unsharded_statistics(cases, w):
    _, retrievals, ranks = cases
    spec, grads = retrievals[w]["mir_retrieval"]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want = workers.mir_retrieval(spec, grads)
    finally:
        torch.set_num_threads(threads)
    for r in ranks[w]:
        got = r["mir_retrieval"]
        for a, b in zip(got["picks"], want["picks"]):
            np.testing.assert_array_equal(a, b)
        assert got["picks"][2].all()
        for k, v in want["stats"].items():
            assert float((got["stats"][k] - v).abs().max()) < 1e-5, k
