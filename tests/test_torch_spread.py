"""tools/spread.py on the CPU at nf 4: a repeated run reports every run's
own-task accuracy, finite tensors and no mislabelled slot, stacked and one
at a time; a slot whose label is not its image's class is counted; and
the hooks leave the agents as they were."""

import numpy as np
import pytest
import torch

from ocl_tpu_torch.config import build_parser
from ocl_tpu_torch.tools import spread

@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread: the test shares the CPU with the suite's workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


FLAGS = ["--device", "cpu", "--data", "synthetic", "--agent", "ER", "--nf", "4", "--num_tasks",
         "2", "--synthetic_size", "20", "--mem_size", "30", "--num_runs", "2", "--verbose",
         "False"]


@pytest.mark.parametrize("stacked", [True, False])
def test_spread_reports_every_run_and_task(tmp_path, monkeypatch, stacked):
    monkeypatch.chdir(tmp_path)
    flags = FLAGS + (["--parallel_runs", "True"] if stacked else [])
    figures = spread.main(["--repeats", "2", "--seed_step", "2", "--json",
                           str(tmp_path / "s.json"), "--"] + flags)
    assert [r["seed"] for r in figures["repeats"]] == [0, 2]
    for rep in figures["repeats"]:
        assert len(rep["runs"]) == 2
        for lanes in rep["runs"]:
            assert len(lanes) == 2
            for lane in lanes:
                assert 0.0 <= lane["own"] <= 1.0 and 0.0 <= lane["batch_stats_own"] <= 1.0
                assert lane["finite"] and lane["mislabelled"] == 0
                assert len(lane["last5"]) == 5 and lane["max"] >= lane["max_last10"]
    assert (tmp_path / "s.json").exists()


def test_repeat_matches_the_runner_and_restores_it(tmp_path, monkeypatch):
    """The accuracy array the tool reads is the run's own, and afterwards the
    registry and the runners' metric function are the originals."""
    import ocl_tpu_torch.experiment.run as run_mod
    from ocl_tpu_torch.general_main import main
    from ocl_tpu_torch.registry import agents

    monkeypatch.chdir(tmp_path)
    build, compute = agents["ER"], run_mod.compute_performance
    acc, rec = spread.repeat_once(build_parser().parse_args(FLAGS))
    assert agents["ER"] is build and run_mod.compute_performance is compute
    want = []
    monkeypatch.setattr(run_mod, "compute_performance",
                        lambda a: want.append(np.array(a)) or compute(a))
    main(build_parser().parse_args(FLAGS))
    np.testing.assert_array_equal(acc, want[0])
    assert len(rec["tasks"]) == 4 and rec["tasks"][-1]["end"] == len(rec["loss"])


def test_deterministic_repeats_agree(tmp_path, monkeypatch):
    """--deterministic runs each repeat under deterministic algorithms and
    says so in the JSON; the repeats of one seed read alike."""
    monkeypatch.chdir(tmp_path)
    figures = spread.main(["--repeats", "2", "--deterministic", "--"] + FLAGS)
    assert figures["deterministic"]
    first, second = figures["repeats"]
    assert first["runs"] == second["runs"]
    assert not torch.are_deterministic_algorithms_enabled()


def test_a_task_with_no_step_is_not_read_low():
    lane = {"own": 0.0, "max": 1.0}
    runs = [[lane, dict(lane, max=None), dict(lane, own=0.9)], [dict(lane, own=0.5)]]
    assert spread.reads_low(runs) == [(0, 0), (1, 0)]


def test_mislabelled_counts_slots_off_their_class():
    params = build_parser().parse_args(FLAGS)
    centres = spread.synthetic_classes(params)
    imgs = centres.reshape(1, 10, 32, 32, 3).clone()
    labels = torch.arange(10)[None]
    assert spread.mislabelled(imgs, labels, centres) == [0]
    labels[0, 3], labels[0, 7] = 4, 0
    assert spread.mislabelled(imgs, labels, centres) == [2]
    assert spread.mislabelled(imgs, labels, None) == [0]
