"""The runner paths on the real datasets' trees (written in each dataset's
own on-disk format): the flag CLI end to end on CIFAR-10, CIFAR-100 (ER +
ASER), CORe50 and OpenLORIS; the tuner's streams over a two-run CORe50
tree against ocl_tpu's, with a recording agent; and --parallel_runs on that
tree, whose ni protocol has one test set for all its tasks (the loaders
themselves are tests/test_torch_datasets.py's)."""

import os
import pickle

import numpy as np
import pytest

from ocl_tpu_torch.data import datasets
from test_datasets import write_cifar10
from test_torch_datasets import both_params, write_cifar100_templates
from test_torch_run import torch_threads
from test_torch_tune import fake_agents  # noqa: F401  (a fixture)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one CPU thread: the same sums on every host, and no
    oversubscribed cores under pytest's workers."""
    with torch_threads(1):
        yield


def write_core50_ni(root, n_per_task=4, n_test=8, runs=1):
    """A CORe50 tree of the ni protocol's shape: `runs` runs of 8 tasks and
    a test set (each run another order of the same JPEGs), 4 classes."""
    from PIL import Image

    folder = os.path.join(root, "datasets", "core50")
    os.makedirs(os.path.join(folder, "imgs"))
    g = np.random.RandomState(18)
    n = 8 * n_per_task + n_test
    y = np.arange(n) % 4
    paths = []
    for i in range(n):
        paths.append(os.path.join("imgs", f"{i}.jpg"))
        Image.fromarray(g.randint(0, 256, (128, 128, 3), dtype=np.uint8)).save(
            os.path.join(folder, paths[-1]))
    lup = []
    for run in range(runs):
        order = np.roll(np.arange(n), 3 * run)
        idx = [order[t * n_per_task: (t + 1) * n_per_task].tolist() for t in range(8)]
        lup.append(idx + [order[8 * n_per_task:].tolist()])
    labels = [[y[i].tolist() for i in idx] for idx in lup]
    for name, obj in (("paths.pkl", paths), ("LUP.pkl", {"ni": lup}),
                      ("labels.pkl", {"ni": labels})):
        with open(os.path.join(folder, name), "wb") as f:
            pickle.dump(obj, f)


def write_openloris_factor(root, factor="occlusion"):
    """Every task of an OpenLORIS factor: two objects, two images each a
    split."""
    from PIL import Image

    from ocl_tpu_torch.data.openloris_objects import DATAPATH

    g = np.random.RandomState(19)
    for task in range(1, 10):
        for split in ("train", "test"):
            for obj in DATAPATH[:2]:
                d = os.path.join(root, "datasets", "openloris", factor, split, f"task{task}", obj)
                os.makedirs(d)
                for j in range(2):
                    Image.fromarray(g.randint(0, 256, (64, 64, 3), dtype=np.uint8)).save(
                        os.path.join(d, f"{j}.jpg"))


CLI_TREES = {
    # the SV paths sample n_smp_cls x 100 = 200 candidates: a buffer of 200
    # that the 500 images of write_cifar100_templates overflow
    "cifar100": (write_cifar100_templates, ["--num_tasks", "10", "--update", "ASER",
                                            "--retrieve", "ASER", "--mem_size", "200", "--k",
                                            "3"]),
    "cifar10": (write_cifar10, ["--num_tasks", "5", "--mem_size", "30"]),
    "core50": (write_core50_ni, ["--cl_type", "ni", "--mem_size", "20", "--val_size", "0.25",
                                 "--batch", "2"]),
    # --ns_type's choices (both packages') leave occlusion as the one
    # OpenLORIS factor the flag CLI can name; the YAML recipes name any
    "openloris": (write_openloris_factor, ["--cl_type", "ni", "--ns_type", "occlusion",
                                           "--mem_size", "10", "--val_size", "0.0",
                                           "--batch", "2"]),
}


@pytest.mark.parametrize("data", sorted(CLI_TREES))
def test_cli_runs_on_each_dataset(tmp_path, monkeypatch, capsys, data):
    """`python -m ocl_tpu_torch.general_main --device cpu --nf 4 --data ...`
    end to end on the dataset's tree in ./datasets (ER + ASER on CIFAR-100,
    plain ER on the others): every task trained and evaluated, and the
    Avg_End_Acc line. (Mini-ImageNet's loader needs its 1.27 GB tree and a
    run of it 5,000 steps a task; the chip's phase 22 runs it.)"""
    from ocl_tpu_torch.config import build_parser
    from ocl_tpu_torch.general_main import main

    writer, flags = CLI_TREES[data]
    monkeypatch.chdir(tmp_path)
    writer(str(tmp_path))
    main(build_parser().parse_args(["--device", "cpu", "--nf", "4", "--data", data, "--agent",
                                    "ER", "--num_runs", "1", "--test_batch", "16", *flags]))
    out = capsys.readouterr().out
    last = [line for line in out.splitlines() if line.startswith("----------- Avg_End_Acc")]
    assert len(last) == 1, out[-3000:]
    acc = float(last[0].split("Avg_End_Acc (")[1].split(",")[0])
    assert 0.0 <= acc <= 1.0
    n_tasks = {"cifar100": 10, "cifar10": 5, "core50": 8, "openloris": 9}[data]
    assert out.count("training batch") == n_tasks


def test_tuner_streams_core50_runs_as_ocl_tpu(fake_agents):
    """Both packages' tuners (multiple_run_tune_separate: a grid run on the
    first num_val tasks, then the whole stream, a run at a time) with
    tests/test_torch_tune.py's recording agent on a two-run CORe50 tree
    (val_size 0.25, so each task holds a quarter out): every agent sees the
    same (params, seed) and trains on the same images (digests of x and y)
    in the same order, run 1 on run 1's LUP entries. (ocl_tpu's own
    multiple_run reads its agent's state and takes no recording agent;
    the stacked test below holds the port's to the stacked runner.)"""
    from ocl_tpu.experiment import tune as j_tune
    from ocl_tpu_torch.experiment import tune

    write_core50_ni(".", runs=2)
    params, j_params = both_params(data="core50", cl_type="ni", agent="ER", num_runs=2,
                                   val_size=0.25, seed=3, num_val=2, num_runs_val=1,
                                   model_name="FAKE")
    grid = {"learning_rate": [0.01, 0.03]}
    got = tune.multiple_run_tune_separate(params, grid, "port.pkl")
    want = j_tune.multiple_run_tune_separate(j_params, grid, "ocl.pkl")
    assert fake_agents["port"] == fake_agents["ocl_tpu"]
    trained = [e for e in fake_agents["port"] if e[0] == "train"]
    # a run: 2 grid points x 2 tuning tasks, then the other 6; 3 of 4 images
    assert len(trained) == 2 * (2 * 2 + 6) and all(e[1] == 3 for e in trained)
    assert trained[:10] != trained[10:]
    assert got["best_params"] == want["best_params"] == [{"learning_rate": 0.03}] * 2
    np.testing.assert_array_equal(got["acc_array"], want["acc_array"])


def test_stacked_runs_stream_each_core50_run(tmp_path, monkeypatch):
    """--parallel_runs on a two-run CORe50 tree: the stacked runner loads
    every run's tasks with that run's cur_run, in the order the sequential
    runner does, and evaluates each task against the protocol's one test
    set, as the sequential runner does (an accuracy matrix [runs, 8, 1])."""
    from ocl_tpu_torch.experiment import parallel_run, run
    from ocl_tpu_torch.experiment.metrics import compute_performance

    monkeypatch.chdir(tmp_path)
    write_core50_ni(str(tmp_path), runs=2)
    calls = []
    new_task = datasets.CORE50.new_task

    def recorded(self, cur_task, **kwargs):
        x, y, labels = new_task(self, cur_task, **kwargs)
        calls.append((kwargs["cur_run"], cur_task, float(x.sum()), y.tolist()))
        return x, y, labels

    monkeypatch.setattr(datasets.CORE50, "new_task", recorded)
    params, _ = both_params(data="core50", cl_type="ni", agent="ER", nf=4, num_runs=2,
                            val_size=0.25, batch=3, mem_size=10, test_batch=8)
    matrices = []
    monkeypatch.setattr(parallel_run, "compute_performance",
                        lambda acc: matrices.append(acc) or compute_performance(acc))
    monkeypatch.setattr(run, "compute_performance",
                        lambda acc: matrices.append(acc) or compute_performance(acc))
    parallel_run.multiple_run_parallel(params)
    stacked, calls[:] = list(calls), []
    params, _ = both_params(data="core50", cl_type="ni", agent="ER", nf=4, num_runs=2,
                            val_size=0.25, batch=3, mem_size=10, test_batch=8)
    run.multiple_run(params)
    assert stacked == calls
    assert [np.asarray(m).shape for m in matrices] == [(2, 8, 1), (2, 8, 1)]
    assert [c[:2] for c in calls] == [(r, t) for r in (0, 1) for t in range(8)]
