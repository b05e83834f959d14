"""The port's sequential tuner against ocl_tpu's (ocl_tpu/experiment/tune.py).

Both packages' agent registries are patched with the same recording agent,
whose accuracies are a fixed function of its params, its seed and what it
was trained on, so no step runs: the control flow must match exactly, the
(params, seed, data) sequence, the best points, the pickle and the CSV
(read back with pandas; `Time` differs). Then one real tiny tune of the
port at nf 4 through its CLI."""

import os
import pickle
import random
import shutil

import numpy as np
import pandas as pd
import pytest
import torch

import ocl_tpu.registry as j_registry
import ocl_tpu_torch.registry as registry
from ocl_tpu.config import default_params as j_default_params
from ocl_tpu.experiment import tune as j_tune
from ocl_tpu_torch.config import default_params
from ocl_tpu_torch.experiment import tune

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID = {"learning_rate": [0.01, 0.1, 0.03], "weight_decay": [0.0, 0.001]}
BASE = dict(data="synthetic", agent="ER", num_tasks=5, synthetic_size=20, num_val=2,
            num_runs=2, num_runs_val=2, seed=5, verbose=False, model_name="FAKE")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Every test on one torch thread: under the suite's parallel workers,
    torch's default of a thread a core oversubscribes the host, and a run
    of seconds takes minutes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class FakeAgent:
    """Records (lr, wd, seed) at init_state and a digest of every task it
    trains on; its accuracy on test set j peaks at lr 0.03 and wd 0 and
    moves with the seed and the tasks seen."""

    log = None

    def __init__(self, params):
        self.params = params

    def init_state(self, seed):
        if not isinstance(seed, int):        # ocl_tpu hands a PRNGKey: [0, seed]
            seed = int(np.asarray(seed).reshape(-1)[-1])
        p = self.params
        self.log.append(("init", float(p.learning_rate), float(p.weight_decay), seed))
        return {"seed": seed, "trained": 0}

    def train_learner(self, state, x, y):
        self.log.append(("train", x.shape[0], float(np.asarray(x, np.float64).sum()),
                         int(np.asarray(y).sum())))
        state["trained"] += 1
        return state

    def evaluate(self, state, test_loaders):
        p = self.params
        score = 0.9 - abs(np.log10(p.learning_rate) - np.log10(0.03)) - 10 * p.weight_decay
        return np.array([score - 0.01 * j + 0.001 * (state["seed"] % 7) + 0.002 * state["trained"]
                         for j in range(len(test_loaders))])


@pytest.fixture
def fake_agents(monkeypatch, tmp_path):
    """Both registries' ER is the recording agent, with a log each; the
    working directory holds config/global.yml."""
    logs = {"port": [], "ocl_tpu": []}
    for name, reg in (("port", registry.agents), ("ocl_tpu", j_registry.agents)):
        fake = type("Fake", (FakeAgent,), {"log": logs[name]})
        monkeypatch.setitem(reg, "ER", fake)
    (tmp_path / "config").mkdir()
    shutil.copy(os.path.join(REPO, "config", "global.yml"), tmp_path / "config")
    monkeypatch.chdir(tmp_path)
    return logs


@pytest.mark.parametrize("mode", ["online", "offline", "train_val"])
def test_tune_separate_matches_ocl_tpu(fake_agents, mode):
    kw = dict(BASE, online=mode != "offline", train_val=mode == "train_val")
    got = tune.multiple_run_tune_separate(default_params(**kw, device="cpu"), GRID, "port.pkl")
    want = j_tune.multiple_run_tune_separate(j_default_params(**kw), GRID, "ocl.pkl")
    assert fake_agents["port"] == fake_agents["ocl_tpu"]
    grid_runs = len(tune.parameter_grid(GRID)) * BASE["num_runs_val"]
    assert sum(e[0] == "init" for e in fake_agents["port"]) == (grid_runs + 1) * BASE["num_runs"]
    assert got["best_params"] == want["best_params"] == [{"learning_rate": 0.03,
                                                          "weight_decay": 0.0}] * 2
    for path in ("result/synthetic/nc/port.pkl", "result/synthetic/nc/ocl.pkl"):
        with open(path, "rb") as f:
            saved = pickle.load(f)
        assert set(saved) == {"seed", "time", "acc_array", "ram", "best_params"}
    np.testing.assert_array_equal(got["acc_array"], want["acc_array"])
    n_tasks = {"online": 3, "offline": 1, "train_val": 5}[mode]
    assert got["acc_array"].shape[:2] == (2, n_tasks) and got["seed"] == want["seed"] == 5


def test_tune_csv_matches_ocl_tpu(fake_agents):
    got = tune.multiple_run_tune(default_params(**BASE, device="cpu"), GRID, "port.csv")
    want = j_tune.multiple_run_tune(j_default_params(**BASE), GRID, "ocl.csv")
    assert fake_agents["port"] == fake_agents["ocl_tpu"]
    assert got == want
    ours = pd.read_csv("tables/synthetic/port.csv").drop(columns="Time")
    theirs = pd.read_csv("tables/synthetic/ocl.csv").drop(columns="Time")
    assert list(ours.columns) == ["Run", "learning_rate", "weight_decay", "Batch2", "Batch3",
                                  "Batch4", "Avg_End_Acc", "Avg_End_Fgt"]
    assert len(ours) == 3 and ours["Run"].tolist() == ["0", "1", "Final Result"]
    pd.testing.assert_frame_equal(ours, theirs)


def test_main_tune_runs_a_tiny_port_tune(tmp_path, monkeypatch, capsys):
    """config/general_1.yml cut to one run, one tuning task and one run a
    grid point, on three tasks of 20 images a class at nf 4."""
    from ocl_tpu_torch.main_tune import build_parser, main

    (tmp_path / "config").mkdir()
    shutil.copy(os.path.join(REPO, "config", "global.yml"), tmp_path / "config")
    with open(os.path.join(REPO, "config", "general_1.yml")) as f:
        general = f.read()
    cuts = {"num_runs: 5": "num_runs: 1", "num_val: 2": "num_val: 1",
            "num_runs_val: 3": "num_runs_val: 1"}
    for old, new in cuts.items():
        assert old in general
        general = general.replace(old, new)
    (tmp_path / "general.yml").write_text(general)
    (tmp_path / "data.yml").write_text(
        "parameters:\n  data: synthetic\n  cl_type: nc\n  num_tasks: 3\n  synthetic_size: 20\n")
    (tmp_path / "tune.yml").write_text("parameters:\n  learning_rate:\n  - 0.05\n  - 0.1\n")
    monkeypatch.chdir(tmp_path)
    random_state = random.getstate()   # main seeds the process's global generator
    try:
        result = main(build_parser().parse_args([
            "--general", "general.yml", "--data", "data.yml",
            "--default", os.path.join(REPO, "config", "agent", "er", "er_1k.yml"),
            "--tune", "tune.yml", "--device", "cpu", "--nf", "4"]))
    finally:
        random.setstate(random_state)
    with open("result/synthetic/nc/Naive_ER_1k_synthetic_0.pkl", "rb") as f:
        saved = pickle.load(f)
    assert saved["acc_array"].shape == (1, 2, 2)
    assert saved["best_params"][0]["learning_rate"] in (0.05, 0.1)
    np.testing.assert_array_equal(saved["acc_array"], result["acc_array"])
    assert "Tuning is done." in capsys.readouterr().out
