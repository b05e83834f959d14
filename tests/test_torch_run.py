"""The port as a whole, at run level, on the CPU at nf 4.

* Its flags are ocl_tpu's, plus --device.
* Its continuum draws the same tasks as ocl_tpu's from a seeded np.random
  stream (tools/parity_vs_reference.py::make_stream).
* ER + ASER, two-pass ER, MIR, GSS, AGEM, EWC++, LwF, iCaRL, GDumb and SCR
  on the CI parity streams land within the band of the committed
  torch-oracle matrices that ocl_tpu meets
  (tests/test_reference_parity.py:120-133): |dAvg_End_Acc| < 0.05 over seeds
  1-5 for ASER (and GDumb, in test_torch_run_gdumb.py); the others over
  seeds 1-2 at the 2-seed band 0.08. The runs take one CPU thread (see
  test_golden_parity).
* MIR: along a parity run, every retrieval picks the rows ocl_tpu's picks
  from the same state and draws.
* The CLI runs end to end and prints the Avg_End_Acc line, with the default
  flags (fused ER), with ER + ASER, with iCaRL, GDumb and SCR, and with
  --error_analysis, which writes the `confusion` pickle.
* What is still not ported raises NotImplementedError.
"""

import contextlib
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

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
    kw = dict(data="synthetic", cl_type="nc", num_tasks=len(tasks), verbose=False, num_runs=1,
              nf=hp["nf"], mem_size=hp["mem_size"], eps_mem_batch=hp["eps_mem_batch"],
              learning_rate=hp["lr"], batch=hp["batch"], device="cpu")
    kw.update(cfg)   # a config's own values win (SCR's eps_mem_batch)
    params = default_params(**kw)
    agent = agents[params.agent](params)
    state = agent.init_state(seed)
    loaders = prepare_test_loaders(tests, params, "cpu")
    rows = []
    for x, y in tasks:
        state = agent.train_learner(state, x, y)
        rows.append(agent.evaluate(state, loaders))
    return np.stack(rows)


GOLDEN_PINS = [("ASER", G.CI_SEEDS, 0.05), ("ER", (1, 2), 0.08), ("MIR", (1, 2), 0.08),
               ("GSS", (1, 2), 0.08), ("AGEM", (1, 2), 0.08), ("EWC", (1, 2), 0.08),
               ("LWF", (1, 2), 0.08), ("ICARL", (1, 2), 0.08), ("SCR", (1, 2), 0.08)]
# tested in test_torch_run_gdumb.py, which says why five seeds
GDUMB_PIN = ("GDUMB", G.CI_SEEDS, 0.05)


@contextlib.contextmanager
def torch_threads(n):
    old = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(old)


def golden_gap(name, seeds):
    """(golden, port) Avg_End_Acc of `name` over `seeds` of the parity streams."""
    ref_rows, port_rows = [], []
    for seed in seeds:
        ref_rows.append(np.load(G.golden_path(name, seed)))
        tasks, tests = pv.make_stream(seed, G.CI_STREAM["per_class"],
                                      G.CI_STREAM["difficulty"], G.CI_STREAM["num_tasks"])
        # ocl_tpu's pins add the ocl-only flags (CN-DPM's CI sleep budget)
        cfg = dict(G.GOLDEN_CONFIGS[name], **G.OCL_EXTRA.get(name, {}))
        port_rows.append(run_port_side(cfg, tasks, tests, seed))
    return pv.summarize(ref_rows)[0], pv.summarize(port_rows)[0]


@pytest.mark.parametrize("name,seeds,band", GOLDEN_PINS)
def test_golden_parity(name, seeds, band):
    """On one thread: at nf 4 a run's accuracy hangs on the order of its
    fp32 sums, which torch's CPU kernels choose by their thread count, so
    one thread gives every host the same runs (`python
    tests/test_torch_run.py` prints the gaps at 1, 2, 4 and 8 threads)."""
    with torch_threads(1):
        ref_acc, port_acc = golden_gap(name, seeds)
    assert abs(ref_acc - port_acc) < band, (name, ref_acc, port_acc)


def test_mir_retrieval_matches_ocl_tpu_along_a_parity_run():
    """Tasks 0-1 of the seed-1 parity stream with MIR (the golden's config):
    at every step, ocl_tpu's MIR retrieval runs on the port's state as the
    port's retrieval sees it (weights, BN statistics after the batch pass,
    the batch gradients, buffer, batch, the same Gumbel draw) and must pick
    the same rows, exactly, and fold the same BN statistics (rtol 1e-3 /
    atol 1e-5). The buffer fills during task 1, so the subsample is drawn
    from a partial and from a full buffer. Step-level parity of the rest of
    the step is test_torch_agents.py's."""
    import jax
    import jax.numpy as jnp

    from ocl_tpu.buffer.state import init_buffer as j_init_buffer
    from ocl_tpu.config import default_params as j_default_params
    from ocl_tpu.registry import agents as j_agents
    from ocl_tpu_torch import interop

    hp = G.CI_HP
    kw = dict(data="synthetic", cl_type="nc", num_tasks=G.CI_STREAM["num_tasks"], verbose=False,
              nf=hp["nf"], mem_size=hp["mem_size"], eps_mem_batch=hp["eps_mem_batch"],
              learning_rate=hp["lr"], batch=hp["batch"], **G.GOLDEN_CONFIGS["MIR"])
    tasks, _ = pv.make_stream(1, G.CI_STREAM["per_class"], G.CI_STREAM["difficulty"],
                              G.CI_STREAM["num_tasks"])
    agent = agents["ER"](default_params(device="cpu", **kw))
    j_retrieve = jax.jit(j_agents["ER"](j_default_params(**kw)).retrieve_fn)
    mem, calls = agent.params.mem_size, []
    run = agent.retrieve.run

    def both(model, buf, x, y, draws, grads=None):
        params, stats = interop.to_jax(model.state_dict())
        j_buf = j_init_buffer(mem, "synthetic").replace(
            imgs=jnp.asarray(buf.imgs.numpy()), labels=jnp.asarray(buf.labels.numpy(), jnp.int32),
            current_index=jnp.asarray(buf.current_index, jnp.int32),
            n_seen_so_far=jnp.asarray(buf.n_seen_so_far, jnp.int32))
        key = jax.random.PRNGKey(len(calls))
        j_x, j_y, j_mask, j_stats = j_retrieve(
            params, stats, j_buf, jnp.asarray(x.numpy()), jnp.asarray(y.numpy(), jnp.int32),
            interop.to_jax(grads)[0], key)
        out = run(model, buf, x, y, {"g": torch.tensor(np.asarray(jax.random.gumbel(key, (mem,))))},
                  grads)
        for a, b in zip(out, (j_x, j_y, j_mask)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(jax.tree_util.tree_leaves(interop.to_jax(model.state_dict())[1]),
                        jax.tree_util.tree_leaves(j_stats)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-3, atol=1e-5)
        calls.append((buf.current_index, bool(out[2].any())))
        return out

    agent.retrieve = agent.retrieve._replace(run=both)
    state = agent.init_state(1)
    for x, y in tasks[:2]:
        state = agent.train_learner(state, x, y)
    filled = [cur for cur, _ in calls]
    assert filled[0] == 0 and 0 < min(f for f in filled if f) < mem and filled[-1] == mem
    assert sum(valid for _, valid in calls) == len(calls) - 1   # all but the first step


def run_cli(*flags, cwd=REPO):
    cmd = [sys.executable, "-m", "ocl_tpu_torch.general_main", "--device", "cpu",
           "--data", "synthetic", "--agent", "ER", "--nf", "4", "--num_tasks", "2",
           "--synthetic_size", "60", "--mem_size", "50", "--num_runs", "1", *flags]
    # one intra-op thread: under a loaded host (the parallel test run) torch's
    # default of one thread per core spins against the other processes and
    # an ER + ASER run of seconds ran past the timeout
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    proc = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    last = [line for line in proc.stdout.splitlines() if "Avg_End_Acc" in line]
    assert last and last[-1].startswith("----------- Avg_End_Acc"), proc.stdout[-3000:]
    acc = float(last[-1].split("Avg_End_Acc (")[1].split(",")[0])
    assert 0.0 <= acc <= 1.0


def test_cli_runs_er_aser():
    run_cli("--update", "ASER", "--retrieve", "ASER")


def test_cli_runs_default_er():
    """No --fused_replay flag: the fused schedule, ocl_tpu's default."""
    run_cli()


@pytest.mark.parametrize("flags", [["--agent", "ICARL"], ["--agent", "GDUMB", "--mem_epoch", "2"],
                                   ["--agent", "SCR"], ["--agent", "SCR", "--review_trick", "True"]],
                         ids=["icarl", "gdumb", "scr", "scr-review"])
def test_cli_runs_icarl_gdumb_scr(flags):
    run_cli(*flags)


def test_cli_error_analysis_writes_confusion(tmp_path):
    """--error_analysis with ER: the confusion pickle lands in the working
    directory and holds one (task, predicted task) pair per test image."""
    import pickle

    run_cli("--error_analysis", "True", cwd=tmp_path)
    with open(tmp_path / "confusion", "rb") as fp:
        correct_lb, predict_lb = pickle.load(fp)
    assert len(correct_lb) == len(predict_lb) > 0
    assert set(correct_lb) == {0, 1} and set(predict_lb) <= {-1, 0, 1}


def stored_accuracies(tmp_path, slow_lead=None, **flags):
    """multiple_run's --store accuracy matrix, run in `tmp_path` on one
    torch thread (a rank's share of one thread is one thread too). With
    `slow_lead` (delay_s, group_timeout_s), two ranks run
    torch_parallel_workers.py::slow_lead_run instead."""
    import pickle

    from ocl_tpu_torch import parallel
    from ocl_tpu_torch.experiment.run import multiple_run

    (tmp_path / "config").mkdir(parents=True)
    (tmp_path / "config" / "global.yml").write_text(
        "path:\n  result: {}/\n  tables: {}/\n".format(tmp_path / "result", tmp_path))
    params = default_params(data="synthetic", nf=4, mem_size=20, synthetic_size=20, num_tasks=2,
                            num_runs=2, verbose=False, device="cpu", **flags)
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        with torch_threads(1):
            if slow_lead is None:
                multiple_run(params, store=True, save_path="acc.pkl")
            else:
                import torch_parallel_workers as workers

                parallel.launch(workers.slow_lead_run, (params,) + tuple(slow_lead), 2, "cpu")
        with open(tmp_path / "result" / "synthetic" / "acc.pkl", "rb") as f:
            return pickle.load(f)["acc_array"]
    finally:
        os.chdir(cwd)


@pytest.fixture(scope="module")
def one_process_accuracies(tmp_path_factory):
    acc = stored_accuracies(tmp_path_factory.mktemp("one"))
    assert acc.shape == (2, 2, 2)
    return acc


def test_n_devices_2_matches_one_process(tmp_path, monkeypatch, one_process_accuracies):
    """--n_devices 2 starts two ranks: rank 0 trains, the evaluation fans
    out over both; the accuracy matrix is the single process's, exactly.
    The ranks get 120 s, then fail the test."""
    monkeypatch.setattr("ocl_tpu_torch.parallel.mesh.LAUNCH_TIMEOUT_S", 120)
    two = stored_accuracies(tmp_path, n_devices=2)
    np.testing.assert_array_equal(two, one_process_accuracies)


def test_n_devices_2_outwaits_the_group_timeout(tmp_path, monkeypatch, one_process_accuracies):
    """Rank 0 trains its first task for longer than the group's collective
    timeout (a 5 s sleep against 2 s) while rank 1 waits to evaluate: the
    wait is not a collective, so the run ends, with the single process's
    accuracy matrix."""
    monkeypatch.setattr("ocl_tpu_torch.parallel.mesh.LAUNCH_TIMEOUT_S", 120)
    two = stored_accuracies(tmp_path, slow_lead=(5.0, 2.0), n_devices=2)
    np.testing.assert_array_equal(two, one_process_accuracies)


def test_debug_nans_raises_on_non_finite_loss():
    params = default_params(data="synthetic", nf=4, mem_size=20, device="cpu",
                            fused_replay=False, verbose=False, debug_nans=True,
                            learning_rate=1e30)
    agent = agents["ER"](params)
    state = agent.init_state(0)
    x, y = pv.make_stream(1, 20, 0.0, 5)[0][0]
    with pytest.raises(FloatingPointError, match="debug_nans"):
        agent.train_learner(state, x, y)


def thread_report(threads=(1, 2, 4, 8)):
    """|golden - port| of each pin at each thread count, one run at a time."""
    for name, seeds, band in GOLDEN_PINS + [GDUMB_PIN]:
        for n in threads:
            with torch_threads(n):
                ref_acc, port_acc = golden_gap(name, seeds)
            print("{} seeds {}-{} band {}: {} thread(s) golden {:.4f} port {:.4f} |d| {:.4f}".format(
                name, seeds[0], seeds[-1], band, n, ref_acc, port_acc, abs(ref_acc - port_acc)),
                flush=True)


def seed_report(names):
    """Golden and port Avg_End_Acc of each configuration in `names`, seed by
    seed over seeds 1-5, on one thread."""
    with torch_threads(1):
        for name in names:
            for seed in G.CI_SEEDS:
                ref_acc, port_acc = golden_gap(name, (seed,))
                print("{} seed {}: golden {:.4f} port {:.4f}".format(name, seed, ref_acc, port_acc),
                      flush=True)


def ocl_seed_report(name, seeds=G.CI_SEEDS):
    """Golden and ocl_tpu's own Avg_End_Acc of configuration `name`, seed by
    seed, through ocl_tpu's pin (tests/test_reference_parity.py::
    _golden_compare). For one CPU thread, run the process on one core
    (`taskset -c 0`); seeds can go to processes of their own."""
    from test_reference_parity import _golden_compare

    for seed in seeds:
        t0 = time.time()
        ref_acc, ocl_acc = _golden_compare(name, (seed,))
        print("{} seed {}: golden {:.4f} ocl_tpu {:.4f} ({:.0f} s)".format(
            name, seed, ref_acc, ocl_acc, time.time() - t0), flush=True)


if __name__ == "__main__":
    # no argument: the thread report; "seeds NAME ...": the per-seed report;
    # "ocl_seeds NAME [SEED ...]": ocl_tpu's own per-seed report
    if sys.argv[1:2] == ["seeds"]:
        seed_report(sys.argv[2:])
    elif sys.argv[1:2] == ["ocl_seeds"]:
        ocl_seed_report(sys.argv[2], [int(s) for s in sys.argv[3:]] or G.CI_SEEDS)
    else:
        thread_report()
