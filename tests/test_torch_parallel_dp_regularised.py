"""AGEM, EWC++, LwF and ER's loss tricks data-parallel (ocl_tpu_torch/
parallel/dp.py), batch and retrieved rows 2 W, a memory of 8 W slots, at
task_seen 1 (a teacher, EWC's penalty, AGEM's projection, the old classes
all in play), held as test_torch_parallel_dp_replay.py holds the replay
strategies: one step against ocl_tpu's `make_dp_train_task`, three against
the port's unsharded steps within a 1e-7 control, every rank bit for bit
the same. Every case at W = 2; AGEM and EWC++, whose gradients are read
before the step, and LwF and kd_trick, whose teachers normalise over the
global batch, at W = 4 too.

Two direct checks where a naive port passes those pins:
  * EWC++'s temporary Fisher (started at zero) after one DP step: the
    unsharded one within 1e-4 of its largest entry. It squares the
    gradient summed over the ranks; Σ_r g_r² would differ by the cross
    terms;
  * AGEM's projection fires in the case held (its step departs from the
    unprojected one), so the one-step pin holds the projected gradient.
"""

import jax
import numpy as np
import pytest

import torch_parallel_workers as workers
from test_torch_parallel_dp import (NF, _sd_diff, assert_matches_ocl_tpu_dp,
                                    assert_ranks_bit_identical, assert_within_control, dp_case,
                                    launch_cases)

NAMES = ("agem", "ewc", "lwf", "labels_trick", "separated_softmax", "kd_trick", "kd_trick_star")
WIDE = ("agem", "ewc", "lwf", "kd_trick")   # also at W = 4
CASES = [(n, 2) for n in NAMES] + [(n, 4) for n in WIDE]


def case_args(name, w):
    """dp_case's (hp, keywords) of case `name` at W = w."""
    mem, b = 8 * w, 2 * w
    hp = dict(data="synthetic", agent="ER", mem_size=mem, eps_mem_batch=b, batch=b, nf=NF,
              learning_rate=0.01, verbose=False)
    buf = dict(fill=mem, n_seen=3 * mem, task_seen=1)
    return {
        # memory of classes 5-9, batches of 0-4: their gradients conflict
        "agem": (dict(hp, agent="AGEM"),
                 dict(buf, labels=5 + np.arange(mem) % 5, n_classes=5)),
        # fisher_update_after 2: the second step folds the temporary Fisher;
        # lambda 0.1 keeps the loss near 1, where fp32 resolves 1e-5 (at the
        # default 100 it is about 5,500, and its rounding alone is 5e-4)
        "ewc": (dict(hp, agent="EWC", fisher_update_after=2, lambda_=0.1),
                dict(task_seen=1, agent="ewc",
                     agent_edit={"tmp_fisher": lambda t: jax.tree_util.tree_map(np.zeros_like,
                                                                                 t)})),
        "lwf": (dict(hp, agent="LWF"), dict(task_seen=1, agent="lwf")),
        "labels_trick": (dict(hp, labels_trick=True), buf),
        "separated_softmax": (dict(hp, separated_softmax=True, fused_replay=False), buf),
        "kd_trick": (dict(hp, kd_trick=True, fused_replay=False), dict(buf, agent="kd_trick")),
        "kd_trick_star": (dict(hp, kd_trick_star=True), dict(buf, agent="kd_trick_star")),
    }[name]


@pytest.fixture(scope="module")
def cases():
    """{W: {name: (spec, ocl_tpu's one-step result)}} and each W's ranks'
    results."""
    out, ranks = {}, {}
    for w in (2, 4):
        names = NAMES if w == 2 else WIDE
        out[w] = {n: dp_case(case_args(n, w)[0], w, 128 + 10 * NAMES.index(n) + w,
                             **case_args(n, w)[1]) for n in names}
        ranks[w] = launch_cases(out[w], w)
    return out, ranks


@pytest.mark.parametrize("name,w", CASES)
def test_dp_regularised_step_matches_ocl_tpu_dp(cases, name, w):
    out, ranks = cases
    _, (jstate, jm) = out[w][name]
    assert_matches_ocl_tpu_dp(ranks[w][0][name]["first"], jstate, jm)


@pytest.mark.parametrize("name,w", CASES)
def test_dp_regularised_three_steps_within_control(cases, name, w):
    out, ranks = cases
    assert_within_control(ranks[w][0][name], out[w][name][0])


@pytest.mark.parametrize("w", [2, 4])
def test_dp_regularised_ranks_stay_bit_identical(cases, w):
    assert_ranks_bit_identical(cases[1][w])


def first_step(spec):
    return dict(spec, xs=spec["xs"][:1], ys=spec["ys"][:1], draws=spec["draws"][:1])


@pytest.mark.parametrize("w", [2, 4])
def test_dp_ewc_fisher_squares_the_summed_gradient(cases, w):
    out, ranks = cases
    want = workers.run_plain(first_step(out[w]["ewc"][0]))["tmp_fisher"]
    for r in ranks[w]:
        got = r["ewc"]["first"]["tmp_fisher"]
        scale = max(float(v.abs().max()) for v in want.values())
        assert scale > 0
        assert max(float((got[k] - v).abs().max()) for k, v in want.items()) < 1e-4 * scale


@pytest.mark.parametrize("w", [2, 4])
def test_dp_agem_case_projects(cases, w):
    """The held AGEM step's weights differ from those of the same step
    without the memory pass (task_seen 0), which they equal bit for bit
    where the coefficient is 0: the projection fired."""
    spec = first_step(cases[0][w]["agem"][0])
    projected = workers.run_plain(spec)
    plain = workers.run_plain(dict(spec, task_seen=0, old_labels=[]))
    weights = [k for k in projected["sd"] if not k.endswith(("running_mean", "running_var"))]
    assert _sd_diff({k: projected["sd"][k] for k in weights},
                    {k: plain["sd"][k] for k in weights}) > 0
