"""The port as a whole, at run level, on the CPU at nf 4.

* Its flags are ocl_tpu's, plus --device.
* Its continuum draws the same tasks as ocl_tpu's from a seeded np.random
  stream (tools/parity_vs_reference.py::make_stream).
* ER + ASER and two-pass ER on the CI parity streams land within the band of
  the committed torch-oracle matrices that ocl_tpu meets
  (tests/test_reference_parity.py:120-133): |dAvg_End_Acc| < 0.05 over
  seeds 1-5 for ASER; ER over seeds 1-2 at the 2-seed band 0.08.
* The CLI runs end to end and prints the Avg_End_Acc line.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import make_parity_goldens as G  # noqa: E402
import parity_vs_reference as pv  # noqa: E402

from ocl_tpu.config import build_parser as j_build_parser  # noqa: E402
from ocl_tpu_torch.config import build_parser, default_params  # noqa: E402
from ocl_tpu_torch.data import continuum, prepare_test_loaders  # noqa: E402
from ocl_tpu_torch.registry import agents  # noqa: E402


def _flags(parser):
    return {a.dest: (a.default, getattr(a.type, "__name__", a.type), tuple(a.choices or ()), a.nargs)
            for a in parser._actions if a.dest != "help"}


def test_flags_match_ocl_tpu():
    ours, theirs = _flags(build_parser()), _flags(j_build_parser())
    assert set(ours) - set(theirs) == {"device"}
    assert ours["device"][0] == "cuda"
    # scan_unroll's default comes from an environment variable in ocl_tpu
    for dest in set(theirs) - {"scan_unroll"}:
        assert ours[dest] == theirs[dest], dest


def test_stream_matches_make_stream():
    seed, per_class, difficulty, num_tasks = 3, 20, 0.7, 3
    tasks, tests = pv.make_stream(seed, per_class, difficulty, num_tasks)
    params = default_params(data="synthetic", cl_type="nc", num_tasks=num_tasks,
                            synthetic_size=per_class, synthetic_difficulty=difficulty,
                            num_runs=1, verbose=False, device="cpu")
    np.random.seed(seed)
    stream = continuum("synthetic", "nc", params)
    stream.new_run()
    ours = [(x, y) for x, y, _ in stream]
    for (x, y), (jx, jy) in zip(ours + stream.test_data(), tasks + tests):
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
    assert len(ours) == len(tasks)


def run_port_side(cfg, tasks, tests, seed):
    """Accuracy matrix of one port run on a parity stream (the counterpart of
    tools/parity_vs_reference.py::run_ocl_side)."""
    hp = G.CI_HP
    params = default_params(
        data="synthetic", cl_type="nc", num_tasks=len(tasks), verbose=False,
        num_runs=1, nf=hp["nf"], mem_size=hp["mem_size"],
        eps_mem_batch=hp["eps_mem_batch"], learning_rate=hp["lr"],
        batch=hp["batch"], device="cpu", **cfg)
    agent = agents[params.agent](params)
    state = agent.init_state(seed)
    loaders = prepare_test_loaders(tests, params, "cpu")
    rows = []
    for x, y in tasks:
        state = agent.train_learner(state, x, y)
        rows.append(agent.evaluate(state, loaders))
    return np.stack(rows)


@pytest.mark.parametrize("name,seeds,band", [("ASER", G.CI_SEEDS, 0.05), ("ER", (1, 2), 0.08)])
def test_golden_parity(name, seeds, band):
    ref_rows, port_rows = [], []
    for seed in seeds:
        ref_rows.append(np.load(G.golden_path(name, seed)))
        tasks, tests = pv.make_stream(seed, G.CI_STREAM["per_class"],
                                      G.CI_STREAM["difficulty"], G.CI_STREAM["num_tasks"])
        port_rows.append(run_port_side(dict(G.GOLDEN_CONFIGS[name]), tasks, tests, seed))
    ref_acc, _ = pv.summarize(ref_rows)
    port_acc, _ = pv.summarize(port_rows)
    assert abs(ref_acc - port_acc) < band, (name, ref_acc, port_acc)


def test_cli_runs_er_aser():
    cmd = [sys.executable, "-m", "ocl_tpu_torch.general_main", "--device", "cpu",
           "--data", "synthetic", "--agent", "ER", "--update", "ASER", "--retrieve", "ASER",
           "--nf", "4", "--num_tasks", "2", "--synthetic_size", "60", "--mem_size", "50",
           "--num_runs", "1"]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    last = [line for line in proc.stdout.splitlines() if "Avg_End_Acc" in line]
    assert last and last[-1].startswith("----------- Avg_End_Acc"), proc.stdout[-3000:]
    acc = float(last[-1].split("Avg_End_Acc (")[1].split(",")[0])
    assert 0.0 <= acc <= 1.0


@pytest.mark.parametrize("flags", [
    dict(fused_replay=True),                                   # fused ER schedule
    dict(fused_replay=False, labels_trick=True),               # trick losses
    dict(fused_replay=False, optimizer="Adam"),
    dict(fused_replay=False, update="GSS"),
    dict(fused_replay=False, retrieve="MIR"),
])
def test_unported_options_raise(flags):
    params = default_params(data="synthetic", nf=4, mem_size=20, device="cpu", **flags)
    with pytest.raises(NotImplementedError):
        agents["ER"](params).init_state(0)


def test_debug_nans_raises_on_non_finite_loss():
    params = default_params(data="synthetic", nf=4, mem_size=20, device="cpu",
                            fused_replay=False, verbose=False, debug_nans=True,
                            learning_rate=1e30)
    agent = agents["ER"](params)
    state = agent.init_state(0)
    x, y = pv.make_stream(1, 20, 0.0, 5)[0][0]
    with pytest.raises(FloatingPointError, match="debug_nans"):
        agent.train_learner(state, x, y)
