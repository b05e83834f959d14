"""The NI scenario of the port against ocl_tpu's, exactly: each distortion
(noise, blur, occlusion) from the same `np.random` and `random` seeds, the
NI split, the synthetic NI stream's tasks and test sets, and
--plot_sample's grids."""

import random

import numpy as np
import pytest

from ocl_tpu.config import default_params as j_default_params
from ocl_tpu.data import continuum as j_continuum
from ocl_tpu.data import non_stationary as j_ns
from ocl_tpu.data.task_compose import train_val_test_split_ni as j_split
from ocl_tpu_torch.config import default_params
from ocl_tpu_torch.data import continuum
from ocl_tpu_torch.data import non_stationary as ns
from ocl_tpu_torch.data.task_compose import train_val_test_split_ni

FACTORS = {"noise": [0.0, 0.4, 0.8, 1.2, 1.6], "blur": [0.0, 0.4, 0.8, 1.2, 1.6],
           "occlusion": [0.0, 0.1, 0.2, 0.3, 0.4]}


def seeded(fn, seed):
    """fn() with both global generators seeded; the process's `random`
    state is put back afterwards."""
    saved = random.getstate()
    np.random.seed(seed)
    random.seed(seed)
    try:
        return fn()
    finally:
        random.setstate(saved)


@pytest.mark.parametrize("ns_type", ["noise", "blur", "occlusion"])
@pytest.mark.parametrize("factor", [0.0, 0.3, 1.6])
def test_make_ns_matches_ocl_tpu(ns_type, factor):
    g = np.random.RandomState(5)
    x = g.randint(0, 256, (7, 32, 32, 3)).astype(np.uint8)
    y = g.randint(0, 10, 7)
    got = seeded(lambda: ns.make_ns(x, y, ns_type, factor), 11)
    want = seeded(lambda: j_ns.make_ns(x, y, ns_type, factor), 11)
    assert got[0].dtype == want[0].dtype == np.float32
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    if factor and ns_type == "occlusion":
        assert (got[0] == 1).sum() > (x == 255).sum()   # a square of ones


def test_train_val_test_split_ni_matches_ocl_tpu():
    g = np.random.RandomState(6)
    args = (g.randint(0, 256, (100, 32, 32, 3)).astype(np.uint8), g.randint(0, 10, 100),
            g.randint(0, 256, (40, 32, 32, 3)).astype(np.uint8), g.randint(0, 10, 40), 4, 32, 0.2)
    got = seeded(lambda: train_val_test_split_ni(*args), 12)
    want = seeded(lambda: j_split(*args), 12)
    assert [a.shape for a in got] == [(4, 20, 32, 32, 3), (4, 20), (4, 5, 32, 32, 3), (4, 5),
                                      (4, 10, 32, 32, 3), (4, 10)]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("ns_type", ["noise", "blur", "occlusion"])
def test_ni_stream_matches_ocl_tpu(ns_type):
    """Two runs of the synthetic NI stream: one task per factor, each task a
    random split of all classes; val_size 0.1 holds out a tenth."""
    kw = dict(data="synthetic", cl_type="ni", ns_type=ns_type, ns_factor=FACTORS[ns_type],
              synthetic_size=30, val_size=0.1, num_runs=2, verbose=False)

    def stream(make, params):
        s = make("synthetic", "ni", params)
        runs = []
        for _ in range(2):
            s.new_run()
            runs.append((list(s), s.test_data(), s.data_object.val_set))
        return runs

    got = seeded(lambda: stream(continuum, default_params(**kw, device="cpu")), 13)
    want = seeded(lambda: stream(j_continuum, j_default_params(**kw)), 13)
    for (tasks, tests, vals), (j_tasks, j_tests, j_vals) in zip(got, want):
        assert len(tasks) == len(j_tasks) == 5
        for (x, y, labels), (jx, jy, j_labels) in zip(tasks, j_tasks):
            assert x.shape == (54, 32, 32, 3) and labels == j_labels
            np.testing.assert_array_equal(x, jx)
            np.testing.assert_array_equal(y, jy)
        for (x, y), (jx, jy) in zip(tests + vals, j_tests + j_vals):
            np.testing.assert_array_equal(x, jx)
            np.testing.assert_array_equal(y, jy)
    assert not np.array_equal(got[0][0][1][0], got[1][0][1][0])   # runs reshuffle


def test_plot_sample_is_not_ported(tmp_path, monkeypatch):
    """--plot_sample, once refused, now writes ocl_tpu's grids: one PNG of
    the first 10 training images a task under result/plots/, pixel-equal to
    ocl_tpu's from the same draws."""
    from PIL import Image

    monkeypatch.chdir(tmp_path)
    kw = dict(data="synthetic", cl_type="ni", synthetic_size=30, verbose=False,
              plot_sample=True, ns_type="noise", ns_factor=FACTORS["noise"])

    def pngs(make, params):
        make("synthetic", "ni", params).new_run()
        folder = tmp_path / "result" / "plots"
        out = {p.name: np.array(Image.open(p)) for p in sorted(folder.iterdir())}
        for p in folder.iterdir():
            p.unlink()
        return out

    got = seeded(lambda: pngs(continuum, default_params(**kw, device="cpu")), 14)
    want = seeded(lambda: pngs(j_continuum, j_default_params(**kw)), 14)
    assert list(got) == list(want) == ["ns_noise_task{}_factor{}.png".format(i, f)
                                       for i, f in enumerate(FACTORS["noise"])]
    for name, img in got.items():
        assert img.shape == (32, 10 * 34 - 2, 3)
        np.testing.assert_array_equal(img, want[name])
