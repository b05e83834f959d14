"""The runner's modes in the port against ocl_tpu's runner, on the CPU:
offline mode (every task concatenated, one train_learner), --store's
pickle, --buffer_tracker's lines, the Throughput meter and check_ram_usage.

The offline comparison patches both runners' `_new_agent_and_state` with a
recording agent, so no step runs in either package."""

import contextlib
import io
import os
import pickle
import shutil
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import ocl_tpu.experiment.run as j_run
import ocl_tpu_torch.experiment.run as run_mod
from ocl_tpu.config import default_params as j_default_params
from ocl_tpu_torch.config import default_params
from ocl_tpu_torch.utils.io import check_ram_usage
from ocl_tpu_torch.utils.profiling import Throughput
from test_torch_buffer import make_buffers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(data="synthetic", num_tasks=2, synthetic_size=30, nf=4, mem_size=60, test_batch=32,
             verbose=False)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Every test on one torch thread: under the suite's parallel workers,
    torch's default of a thread a core oversubscribes the host, and a run
    of seconds takes minutes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    """A working directory with config/global.yml: --store writes under
    its result path, here and not in the repository."""
    (tmp_path / "config").mkdir()
    shutil.copy(os.path.join(REPO, "config", "global.yml"), tmp_path / "config")
    monkeypatch.chdir(tmp_path)
    return tmp_path


class Recorder:
    """An agent that records what train_learner is handed and trains
    nothing."""

    def __init__(self, calls):
        self.calls = calls

    def train_learner(self, state, x, y):
        self.calls.append((np.array(x), np.array(y)))
        return state

    def evaluate(self, state, test_loaders):
        return np.zeros(len(test_loaders))


def recorded_calls(module, monkeypatch, params):
    calls = []
    monkeypatch.setattr(module, "_new_agent_and_state",
                        lambda p, seed: (Recorder(calls), SimpleNamespace(params={})))
    module.multiple_run(params)
    return calls


@pytest.mark.parametrize("cl_type", ["nc", "ni"])
def test_offline_hands_train_learner_what_ocl_tpu_does(cl_type, monkeypatch):
    """Two runs offline: each run's tasks concatenated, one call a run."""
    kw = dict(SMALL, num_runs=2, online=False, cl_type=cl_type, seed=3,
              ns_factor=[0.0, 0.4, 0.8, 1.2, 1.6])
    got = recorded_calls(run_mod, monkeypatch, default_params(**kw, device="cpu"))
    want = recorded_calls(j_run, monkeypatch, j_default_params(**kw))
    assert len(got) == len(want) == 2
    for (x, y), (jx, jy) in zip(got, want):
        assert x.shape == (270 if cl_type == "ni" else 300, 32, 32, 3)
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)


def test_offline_mode():
    """Counterpart of tests/test_scenarios.py::test_offline_mode."""
    p = default_params(**SMALL, online=False, device="cpu")
    avg = run_mod.multiple_run(p)
    assert 0 <= avg <= 1


def test_offline_with_an_empty_buffer(capsys):
    """config/agent/er/offline.yml: mem_size 0 and eps_mem_batch 0, several
    epochs at batch 128 (here 3 epochs at batch 16 of the 300 images)."""
    p = default_params(**dict(SMALL, mem_size=0), eps_mem_batch=0, online=False, epoch=3,
                       batch=16, device="cpu")
    avg = run_mod.multiple_run(p)
    assert 0.5 < avg <= 1
    assert "avg_end_acc {}".format(avg) in capsys.readouterr().out


def test_store_pickle(workdir):
    """Counterpart of tests/test_scenarios.py::test_store_pickle."""
    p = default_params(**SMALL, model_name="ERT", data_name="syn", device="cpu")
    run_mod.multiple_run(p, store=True, save_path="t.pkl")
    with open("result/synthetic/t.pkl", "rb") as f:
        result = pickle.load(f)
    assert set(result) == {"time", "acc_array"} and result["acc_array"].shape == (1, 2, 2)
    run_mod.multiple_run(p, store=True)
    assert sorted(os.listdir("result/synthetic")) == ["ERT_syn.pkl", "t.pkl"]


def tracker_lines(fn, state):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(state)
    return out.getvalue().splitlines()


def test_buffer_tracker_prints_ocl_tpu_lines():
    """The same buffer in both packages: a consistent one prints the counts;
    one whose class counts drifted prints the MISMATCH line too."""
    jbuf, tbuf = make_buffers(50, 35, 60, seed=4)
    got = tracker_lines(run_mod._check_buffer_tracker, SimpleNamespace(buffer=tbuf))
    want = tracker_lines(j_run._check_buffer_tracker, SimpleNamespace(buffer=jbuf))
    assert got == want and len(got) == 1 and got[0].startswith("[buffer_tracker] total 35 ")

    tbuf.class_counts[2] += 1
    jbuf = jbuf.replace(class_counts=jbuf.class_counts.at[2].add(1))
    got = tracker_lines(run_mod._check_buffer_tracker, SimpleNamespace(buffer=tbuf))
    want = tracker_lines(j_run._check_buffer_tracker, SimpleNamespace(buffer=jbuf))
    assert got == want and len(got) == 2 and "MISMATCH" in got[1]
    assert tracker_lines(run_mod._check_buffer_tracker, SimpleNamespace(buffer=None)) == []


def test_buffer_tracker_in_a_run(capsys):
    p = default_params(**SMALL, buffer_tracker=True, device="cpu")
    run_mod.multiple_run(p)
    lines = [line for line in capsys.readouterr().out.splitlines() if "[buffer_tracker]" in line]
    assert [line.split()[2] for line in lines] == ["60", "60"]
    assert not any("MISMATCH" in line for line in lines)


def test_throughput():
    tput = Throughput()
    assert tput.images_per_sec() == 0.0
    with tput.measure(100, "cpu"):
        time.sleep(0.05)
    with tput.measure(50):
        pass
    assert tput.images == 150 and 0.05 <= tput.seconds < 1.0
    assert tput.images_per_sec() == pytest.approx(150 / tput.seconds)


def test_check_ram_usage_agrees_with_psutil():
    import psutil

    ballast = np.ones(64 * 2**20 // 8)   # 64 MB, resident once written
    got = check_ram_usage()
    want = psutil.Process(os.getpid()).memory_info().rss / (1024 * 1024)
    assert abs(got - want) <= 0.05 * want and got > 64
    del ballast
