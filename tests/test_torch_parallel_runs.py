"""Stacked runs and stacked tune points dealt round-robin to two ranks
(experiment/parallel_run.py and parallel_tune.py under --n_devices 2)
against the same stacked program on one rank.

A rank stacks its share of the points (runs 0 and 2 on rank 0, run 1 on
rank 1), each point keeping its own stream, weights and draws, and the
accuracies come back in point order. The one-rank program runs on one torch
thread as each rank does (a convolution's order of sums depends on the
threads); the tolerance is then the stacked runner's for one paired
computation (tests/test_torch_parallel_run.py), 1e-5, and the tuner must
pick the same grid point. ocl_tpu pads its points to the device count
(parallel_tune.py:190-191): 2 grid points x 1 val run at W = 2 needs none,
3 points need one, which is dropped again before the winner is chosen.
The ranks of each launch get 120 s, then fail the test.
"""

import contextlib
import os
import pickle

import numpy as np
import pytest
import torch

from ocl_tpu_torch.config import build_parser, finalize


@pytest.fixture(autouse=True)
def launch_limit(monkeypatch):
    monkeypatch.setattr("ocl_tpu_torch.parallel.mesh.LAUNCH_TIMEOUT_S", 120)


ARGS = ["--device", "cpu", "--data", "synthetic", "--agent", "ER", "--nf", "4",
        "--num_tasks", "2", "--synthetic_size", "20", "--mem_size", "30",
        "--learning_rate", "0.01", "--verbose", "False", "--parallel_runs", "True"]


@contextlib.contextmanager
def one_thread_in(path):
    old, cwd = torch.get_num_threads(), os.getcwd()
    torch.set_num_threads(1)
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(cwd)
        torch.set_num_threads(old)


def stacked_accuracies(path, *flags):
    from ocl_tpu_torch.experiment.parallel_run import multiple_run_parallel

    (path / "config").mkdir(parents=True)
    (path / "config" / "global.yml").write_text(
        "path:\n  result: {}/\n  tables: {}/\n".format(path / "result", path))
    params = finalize(build_parser().parse_args(ARGS + ["--num_runs", "3"] + list(flags)))
    with one_thread_in(path):
        metrics = multiple_run_parallel(params, store=True, save_path="acc.pkl")
    with open(path / "result" / "synthetic" / "acc.pkl", "rb") as f:
        return pickle.load(f)["acc_array"], metrics


def test_stacked_runs_over_two_ranks_match_one_rank(tmp_path):
    one, m1 = stacked_accuracies(tmp_path / "one")
    two, m2 = stacked_accuracies(tmp_path / "two", "--n_devices", "2")
    assert one.shape == two.shape == (3, 2, 2)
    np.testing.assert_allclose(two, one, rtol=0, atol=1e-5)
    np.testing.assert_allclose(m2[0], m1[0], atol=1e-5)


@pytest.mark.parametrize("grid", [[0.01, 0.1], [0.001, 0.01, 0.1]], ids=["2pts", "3pts"])
def test_stacked_tune_over_two_ranks_picks_the_same_point(tmp_path, capfd, grid):
    """Each grid point's avg_end_acc line (rank 0 prints them once the ranks'
    accuracies are gathered) within 1e-5 of the one-rank tune's, and the
    same winner."""
    from ocl_tpu_torch.config import default_params
    from ocl_tpu_torch.data import prepare_test_loaders
    from ocl_tpu_torch.experiment.parallel_tune import tune_hyper_parallel
    from ocl_tpu_torch.experiment.tune import _merged, parameter_grid
    from test_torch_buffer import class_images

    g = np.random.RandomState(0)
    tune_data = []
    for t in range(2):
        y = g.randint(2 * t, 2 * t + 2, 40)
        tune_data.append((class_images(y, g), y, None))
    tests = [(class_images(y, g), y) for y in (g.randint(0, 2, 16), g.randint(2, 4, 16))]
    tune = {"learning_rate": grid}
    got = {}
    for w in (0, 2):
        params = default_params(data="synthetic", agent="ER", nf=4, mem_size=20,
                                eps_mem_batch=10, batch=10, test_batch=8, num_runs_val=1,
                                verbose=False, device="cpu", n_devices=w)
        loaders = prepare_test_loaders(tests, params, "cpu")
        capfd.readouterr()
        with one_thread_in(tmp_path):
            best = tune_hyper_parallel(tune_data, loaders, params, tune, parameter_grid(tune),
                                       _merged)
        text = capfd.readouterr().out
        accs = [float(line.split()[-1]) for line in text.splitlines() if "-> avg_end_acc" in line]
        got[w] = best, accs, text
    assert len(got[0][1]) == len(got[2][1]) == len(grid)
    np.testing.assert_allclose(got[2][1], got[0][1], rtol=0, atol=1e-5)
    assert got[2][0] == got[0][0]
    pad = len(grid) % 2
    assert "({} padding), dealt to 2 ranks".format(pad) in got[2][2]


@pytest.mark.parametrize("stacked", [False, True], ids=["sequential", "stacked"])
def test_sequential_tuner_over_two_ranks_matches_one_process(tmp_path, capfd, stacked):
    """main_tune's tuner (multiple_run_tune_separate) under --n_devices 2:
    rank 0 trains every grid point and the final run, and each evaluation
    fans out over both ranks; with --parallel_runs the stacked points are
    dealt to the ranks, each on every test row. The best point and the
    stored accuracy matrix are the single process's, exactly (the final
    run trains on rank 0 alone in both), and the tuner started the ranks
    once."""
    from ocl_tpu_torch.config import default_params
    from ocl_tpu_torch.experiment.tune import multiple_run_tune_separate

    got = {}
    for w in (0, 2):
        path = tmp_path / str(w)
        (path / "config").mkdir(parents=True)
        (path / "config" / "global.yml").write_text(
            "path:\n  result: {}/\n  tables: {}/\n".format(path / "result", path))
        params = default_params(data="synthetic", agent="ER", nf=4, num_tasks=3,
                                synthetic_size=20, mem_size=30, num_val=1, num_runs=1,
                                num_runs_val=1, verbose=False, device="cpu", n_devices=w,
                                parallel_runs=stacked)
        capfd.readouterr()
        with one_thread_in(path):
            multiple_run_tune_separate(params, {"learning_rate": [0.01, 0.1]}, "tune.pkl")
        layout = [ln for ln in capfd.readouterr().out.splitlines() if ln.startswith("[parallel]")]
        assert layout == ([] if w == 0 else ["[parallel] 2 ranks on the CPU, backend gloo"])
        with open(path / "result" / "synthetic" / "nc" / "tune.pkl", "rb") as f:
            got[w] = pickle.load(f)
    assert got[2]["best_params"] == got[0]["best_params"]
    assert got[0]["acc_array"].shape == (1, 2, 2)
    np.testing.assert_array_equal(got[2]["acc_array"], got[0]["acc_array"])
