"""SCR with each retrieval and update, and AGEM with ASER's retrieval,
data-parallel (ocl_tpu_torch/parallel/dp.py): batch 2 W, W memory rows
(match: 2 W, mem_match: W + W), a memory of 8 W slots, SupConResNet for
SCR, lr 0.01 (test_torch_parallel_dp_agents.py's SCR step: at nf 4 a ReLU
input within rounding of zero may flip between XLA and torch). Held as
test_torch_parallel_dp_replay.py holds the replay strategies: one step
against ocl_tpu's `make_dp_train_task`, three against the port's unsharded
steps within a 1e-7 control, every rank bit for bit the same.

SCR retrieves before any backward, so MIR scores with zero batch gradients
(ocl_tpu/agents/scr.py:69-72), its subsample split over the ranks. The ASER
paths (SCR's update, AGEM's retrieval) run K1's plain version on the CPU on
features gathered from every rank's rows, in XLA's order of sums. The
cases run at W = 2 only: a second launch at W = 4 (about 15 s of start-up
beside 5-10 s of ocl_tpu's compile a case) would take the file past 120 s
alone; test_torch_parallel_dp_replay.py and _regularised.py hold the DP
step's reductions at W = 4.

SCR at nf 4 is chaotic: over three steps a 1e-7 shift of the weights moves
them by 1e-2, and under the ASER update it changes the replaced slots from
9 of the 10 weight seeds 240-249. That case starts from seed 243, whose
replacements the shift leaves alone, so its exact-label pin holds the DP
step and not the rounding.
"""

import numpy as np
import pytest

from test_torch_parallel_dp import (NF, assert_matches_ocl_tpu_dp, assert_ranks_bit_identical,
                                    assert_within_control, dp_case, launch_cases)

NAMES = ("scr_mir", "scr_match", "scr_mem_match", "scr_gss", "scr_aser_update",
         "scr_aser_retrieve", "agem_aser")
W = 2


def case_args(name, w):
    """dp_case's (hp, keywords) of case `name` at W = w."""
    mem, b = 8 * w, 2 * w
    hp = dict(data="synthetic", agent="SCR", mem_size=mem, eps_mem_batch=w, batch=b, nf=NF,
              head="mlp", temp=0.07, learning_rate=0.01, verbose=False)
    full = dict(fill=mem, n_seen=3 * mem)
    by_class = dict(full, labels=np.arange(mem) % 4, n_classes=4)
    aser = dict(k=2, n_smp_cls=1.0)
    return {
        "scr_mir": (dict(hp, retrieve="MIR", subsample=11), full),
        "scr_match": (dict(hp, retrieve="match"), by_class),
        "scr_mem_match": (dict(hp, retrieve="mem_match"), by_class),
        "scr_gss": (dict(hp, update="GSS", gss_mem_strength=2, gss_batch_size=w),
                    dict(full, score=np.random.RandomState(w).uniform(-1, 1, mem))),
        "scr_aser_update": (dict(hp, update="ASER", **aser), dict(full, xla_order=True, seed=243)),
        "scr_aser_retrieve": (dict(hp, retrieve="ASER", **aser), dict(full, xla_order=True)),
        "agem_aser": (dict(hp, agent="AGEM", retrieve="ASER", eps_mem_batch=b, **aser),
                      dict(full, task_seen=1, xla_order=True)),
    }[name]


@pytest.fixture(scope="module")
def cases():
    """{name: (spec, ocl_tpu's one-step result)} and the ranks' results."""
    out = {}
    for i, n in enumerate(NAMES):
        hp, kw = case_args(n, W)
        out[n] = dp_case(hp, W, kw.pop("seed", 200 + 10 * i + W), **kw)
    return out, launch_cases(out, W)


@pytest.mark.parametrize("name", NAMES)
def test_dp_scr_step_matches_ocl_tpu_dp(cases, name):
    out, ranks = cases
    _, (jstate, jm) = out[name]
    assert_matches_ocl_tpu_dp(ranks[0][name]["first"], jstate, jm)


@pytest.mark.parametrize("name", NAMES)
def test_dp_scr_three_steps_within_control(cases, name):
    out, ranks = cases
    assert_within_control(ranks[0][name], out[name][0])


def test_dp_scr_ranks_stay_bit_identical(cases):
    assert_ranks_bit_identical(cases[1])
