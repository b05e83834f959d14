"""The port's dataset loaders against ocl_tpu's, exactly, on fixture trees in
each dataset's own on-disk format: CIFAR-10/100's pickle batches, the
Mini-ImageNet kaggle cache pickles at full size (60,000 images at 84 px,
written once for the module), CORe50's paths/LUP/labels pickles and JPEG
tree, and OpenLORIS's per-factor JPEG tree (tests/test_datasets.py's
writers, and a CORe50 tree with two runs of both protocols).

Equal means equal: the loaded train and test arrays and labels, every
`new_task`, the NC and NI task compositions over two runs, CORe50's and
OpenLORIS's val sets, CORe50's `cur_run`, `--plot_sample`'s PNGs. Both
packages draw from the global `np.random` (and `random`) in the same order,
so each is seeded the same before it loads and streams. A CORe50 bin cache
written by either package serves the other, byte for byte.

The slice as a whole: on a CIFAR-100 tree both continuums stream the same
tasks, and one ER + ASER step on those tasks (weights, buffer, batch and
draws shared, as tests/test_torch_er_step.py does) equals ocl_tpu's.

OpenLORIS labels an image by its object's index in the 121 names of
`DATAPATH`, past the 69 classes of the head: what each package does with
such a label is shown at the loss.
"""

import os
import pickle
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocl_tpu.config import default_params as j_default_params
from ocl_tpu.data import continuum as j_continuum
from ocl_tpu.data import datasets as j_datasets
from ocl_tpu_torch.config import default_params
from ocl_tpu_torch.data import continuum
from ocl_tpu_torch.data import datasets
from test_datasets import (
    write_cifar10,
    write_cifar100,
    write_core50,
    write_mini_imagenet,
    write_openloris,
)
from test_torch_ni import seeded
from test_torch_run import torch_threads

WRITERS = {"cifar10": write_cifar10, "cifar100": write_cifar100}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one CPU thread: the same sums on every host, and no
    oversubscribed cores under pytest's workers."""
    with torch_threads(1):
        yield

def both_params(**kw):
    """(port params on the CPU, ocl_tpu params) from the same flags."""
    kw.setdefault("verbose", False)
    return default_params(device="cpu", **kw), j_default_params(**kw)


def assert_equal_pairs(got, want):
    """Lists of (x, y) pairs, exactly equal."""
    assert len(got) == len(want)
    for (x, y), (jx, jy) in zip(got, want):
        assert np.asarray(x).dtype == np.asarray(jx).dtype
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)


def stream_runs(make, data, scenario, params, runs=2):
    """Every run's (tasks, test sets, val sets) of a continuum."""
    s = make(data, scenario, params)
    out = []
    for _ in range(runs):
        s.new_run()
        tasks = list(s)
        out.append((tasks, s.test_data(), list(s.data_object.val_set)))
    return out


def assert_streams_equal(got, want):
    for (tasks, tests, vals), (j_tasks, j_tests, j_vals) in zip(got, want):
        assert len(tasks) == len(j_tasks) > 0
        for (x, y, labels), (jx, jy, j_labels) in zip(tasks, j_tasks):
            assert x.dtype == jx.dtype == np.float32
            assert [int(v) for v in labels] == [int(v) for v in j_labels]
            np.testing.assert_array_equal(x, jx)
            np.testing.assert_array_equal(y, jy)
        assert_equal_pairs(tests, j_tests)
        assert_equal_pairs(vals, j_vals)


# ------------------------------------------------------------------ CIFAR

@pytest.mark.parametrize("data", ["cifar10", "cifar100"])
@pytest.mark.parametrize("scenario", ["nc", "ni"])
def test_cifar_streams_match_ocl_tpu(tmp_path, monkeypatch, data, scenario):
    """Loaded arrays, then two runs of the stream: NC with a shuffled class
    order; NI with two noise factors and a tenth held out for validation."""
    monkeypatch.chdir(tmp_path)
    WRITERS[data](str(tmp_path))
    kw = dict(data=data, cl_type=scenario, num_runs=2, val_size=0.1,
              num_tasks=5 if data == "cifar10" else 10, ns_type="noise", ns_factor=[0.0, 0.4])
    params, j_params = both_params(**kw)
    cls = {"cifar10": (datasets.CIFAR10, j_datasets.CIFAR10),
           "cifar100": (datasets.CIFAR100, j_datasets.CIFAR100)}[data]
    ds, jds = cls[0](scenario, params), cls[1](scenario, j_params)
    for name in ("train_data", "train_label", "test_data", "test_label"):
        np.testing.assert_array_equal(getattr(ds, name), getattr(jds, name))
    assert ds.train_data.dtype == np.uint8 and ds.train_data.shape[1:] == (32, 32, 3)
    got = seeded(lambda: stream_runs(continuum, data, scenario, params), 5)
    want = seeded(lambda: stream_runs(j_continuum, data, scenario, j_params), 5)
    assert_streams_equal(got, want)
    if scenario == "nc":   # the class order is shuffled, and reshuffled a run
        assert got[0][0][0][2] != got[1][0][0][2]


def write_cifar100_templates(root, train_per_class=5, test_per_class=2, seed=17):
    """A CIFAR-100 tree whose images are a class template plus noise (the
    synthetic stream's recipe), so that nearest-neighbour orders follow the
    classes: `train_per_class` and `test_per_class` images a class."""
    folder = os.path.join(root, "datasets", "cifar100", "cifar-100-python")
    os.makedirs(folder)
    g = np.random.RandomState(seed)
    templates = g.rand(100, 32, 32, 3)
    for name, n in (("train", train_per_class), ("test", test_per_class)):
        y = np.repeat(np.arange(100), n)
        x = np.clip(0.5 + 0.8 * (templates[y] - 0.5) + g.normal(0, 0.1, (len(y), 32, 32, 3)), 0, 1)
        rows = (x * 255).astype(np.uint8).transpose(0, 3, 1, 2).reshape(len(y), 3072)
        with open(os.path.join(folder, name), "wb") as f:
            pickle.dump({b"data": rows, b"fine_labels": y.tolist()}, f)


def png_arrays(folder):
    from PIL import Image

    return {name: np.array(Image.open(os.path.join(folder, name)))
            for name in sorted(os.listdir(folder))}


def test_plot_sample_pngs_match_ocl_tpu(tmp_path, monkeypatch):
    """--plot_sample on a CIFAR-10 NI stream: one grid of the first 10
    training images a task, under result/plots/, pixel-equal to ocl_tpu's."""
    monkeypatch.chdir(tmp_path)
    write_cifar10(str(tmp_path))
    kw = dict(data="cifar10", cl_type="ni", num_runs=1, val_size=0.1, ns_type="blur",
              ns_factor=[0.0, 1.2], plot_sample=True)
    params, j_params = both_params(**kw)
    seeded(lambda: stream_runs(continuum, "cifar10", "ni", params, runs=1), 6)
    shutil.move("result", "port")
    seeded(lambda: stream_runs(j_continuum, "cifar10", "ni", j_params, runs=1), 6)
    got, want = png_arrays("port/plots"), png_arrays("result/plots")
    assert list(got) == list(want) == ["ns_blur_task0_factor0.0.png",
                                       "ns_blur_task1_factor1.2.png"]
    for name in got:
        assert got[name].shape == (32, 10 * 34 - 2, 3)
        np.testing.assert_array_equal(got[name], want[name])


# ---------------------------------------------------------- Mini-ImageNet

@pytest.fixture(scope="module")
def mini_imagenet_root(tmp_path_factory):
    """The kaggle cache pickles at full size (the loader reshapes each to
    [n_cls, 600, 84, 84, 3]): 60,000 images, 1.27 GB, written once."""
    root = tmp_path_factory.mktemp("mini")
    write_mini_imagenet(str(root))
    yield root
    shutil.rmtree(root / "datasets")


def test_mini_imagenet_matches_ocl_tpu(mini_imagenet_root, monkeypatch):
    """The 5/6 : 1/6 re-split (100 per-class shuffles from np.random, before
    any task is composed), then the NC stream's first two tasks, the test
    sets and the next run's class order."""
    monkeypatch.chdir(mini_imagenet_root)
    params, j_params = both_params(data="mini_imagenet", cl_type="nc", num_tasks=10,
                                   num_runs=2)

    def load_and_stream(cls, p):
        ds = cls("nc", p)
        ds.new_run()
        tasks = [ds.new_task(i) for i in (0, 1)]
        return ds, tasks, ds.test_set[:2]

    ds, tasks, tests = seeded(lambda: load_and_stream(datasets.Mini_ImageNet, params), 7)
    assert ds.train_data.shape == (50000, 84, 84, 3) and ds.test_data.shape == (10000, 84, 84, 3)
    jds, j_tasks, j_tests = seeded(lambda: load_and_stream(j_datasets.Mini_ImageNet, j_params),
                                   7)
    for name in ("train_data", "train_label", "test_data", "test_label"):
        got, want = getattr(ds, name), getattr(jds, name)
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    del jds
    for (x, y, labels), (jx, jy, j_labels) in zip(tasks, j_tasks):
        assert x.shape == (5000, 84, 84, 3) and labels == j_labels
        assert np.array_equal(x, jx) and np.array_equal(y, jy)
    assert_equal_pairs(tests, j_tests)


# ------------------------------------------------------------------ CORe50

def write_core50_runs(root, n_imgs=30):
    """A CORe50 tree with two runs of both protocols: `ni`, two tasks of
    every class and a test set; `nc`, three tasks of two classes each and a
    test set; each run names other images."""
    from PIL import Image

    folder = os.path.join(root, "datasets", "core50")
    os.makedirs(os.path.join(folder, "imgs"))
    rng = np.random.RandomState(8)
    paths = []
    for i in range(n_imgs):
        rel = os.path.join("imgs", f"im_{i}.jpg")
        Image.fromarray(rng.randint(0, 256, (128, 128, 3), dtype=np.uint8)).save(
            os.path.join(folder, rel), quality=90)
        paths.append(rel)
    cls = rng.randint(0, 6, n_imgs)
    lup, labels = {"ni": [], "nc": []}, {"ni": [], "nc": []}
    for run in range(2):
        order = rng.permutation(n_imgs)
        ni = [order[:10], order[10:20], order[20:]]
        lup["ni"].append([list(map(int, t)) for t in ni])
        labels["ni"].append([[int(cls[i]) for i in t] for t in ni])
        nc = [[int(i) for i in order if cls[i] in (2 * t, 2 * t + 1)] for t in range(3)]
        test = [int(i) for i in order[::3]]
        lup["nc"].append(nc + [test])
        labels["nc"].append([[int(cls[i]) for i in t] for t in nc + [test]])
    for name, obj in (("paths.pkl", paths), ("LUP.pkl", lup), ("labels.pkl", labels)):
        with open(os.path.join(folder, name), "wb") as f:
            pickle.dump(obj, f)


def core50_runs(cls, params, scenario, n_tasks):
    """Two runs of a CORe50 object, as the continuum drives it (new_run,
    then new_task with cur_run): each run's test sets, tasks and val sets."""
    ds = cls(scenario, params)
    out = []
    for run in range(2):
        ds.new_run(cur_run=run)
        tasks = [ds.new_task(t, cur_run=run) for t in range(n_tasks)]
        out.append((tasks, ds.get_test_set(), list(ds.val_set)))
    return out


@pytest.mark.parametrize("scenario,n_tasks", [("ni", 2), ("nc", 3)])
def test_core50_matches_ocl_tpu(tmp_path, monkeypatch, scenario, n_tasks):
    """Decoded from the JPEGs (no cache): each run's test set, its tasks
    shuffled with a fifth held out for validation, and cur_run choosing the
    run's own LUP entries."""
    monkeypatch.chdir(tmp_path)
    write_core50_runs(str(tmp_path))
    params, j_params = both_params(data="core50", cl_type=scenario, num_runs=2, val_size=0.2,
                                   core50_cache=False)
    got = seeded(lambda: core50_runs(datasets.CORE50, params, scenario, n_tasks), 9)
    want = seeded(lambda: core50_runs(j_datasets.CORE50, j_params, scenario, n_tasks), 9)
    assert_streams_equal(got, want)
    assert not os.path.exists("datasets/core50/bin_cache")
    (x0, _, _), (x1, _, _) = got[0][0][0], got[1][0][0]
    assert x0.shape[1:] == (128, 128, 3) and not np.array_equal(x0[:4], x1[:4])
    assert all(len(v[0]) == int(0.2 * (len(v[0]) + len(t[1]))) for v, t in
               zip(got[0][2], got[0][0]))


def test_core50_continuum_matches_ocl_tpu(tmp_path, monkeypatch):
    """tests/test_datasets.py's CORe50 tree (one ni run of two tasks) through
    both continuums, with the bin cache on."""
    def stream(make, params, root):
        monkeypatch.chdir(root)
        s = make("core50", "ni", params)
        s.task_nums = s.data_object.task_nums = 2
        s.new_run()
        return [(list(s), s.test_data(), list(s.data_object.val_set))]

    for side in ("port", "ocl"):
        write_core50(str(tmp_path / side))
    params, j_params = both_params(data="core50", cl_type="ni", num_runs=1, val_size=0.25)
    got = seeded(lambda: stream(continuum, params, tmp_path / "port"), 10)
    want = seeded(lambda: stream(j_continuum, j_params, tmp_path / "ocl"), 10)
    assert_streams_equal(got, want)
    assert got[0][0][0][0].shape == (3, 128, 128, 3) and len(got[0][2][0][1]) == 1


def cache_files(root):
    folder = os.path.join(root, "datasets", "core50", "bin_cache")
    return {name: open(os.path.join(folder, name), "rb").read()
            for name in sorted(os.listdir(folder))}


def test_core50_bin_cache_serves_both_packages(tmp_path, monkeypatch, capsys):
    """Each package writes the md5-keyed cache from the same tree; the files
    are byte-identical, and with the JPEGs gone each package loads the
    other's cache into the arrays it decoded."""
    params, j_params = both_params(data="core50", cl_type="ni", num_runs=2, val_size=0.2)
    runs = {}
    for side, cls, p in (("port", datasets.CORE50, params), ("ocl", j_datasets.CORE50, j_params)):
        root = tmp_path / side
        write_core50_runs(str(root))
        monkeypatch.chdir(root)
        runs[side] = seeded(lambda: core50_runs(cls, p, "ni", 2), 11)
    files = cache_files(tmp_path / "port")
    assert len(files) == 6 and files == cache_files(tmp_path / "ocl")
    for side in ("port", "ocl"):
        shutil.rmtree(tmp_path / side / "datasets" / "core50" / "imgs")
    capsys.readouterr()
    for side, cls, p in (("ocl", datasets.CORE50, params), ("port", j_datasets.CORE50, j_params)):
        monkeypatch.chdir(tmp_path / side)   # the other package's cache
        assert_streams_equal(seeded(lambda: core50_runs(cls, p, "ni", 2), 11), runs[side])
    assert capsys.readouterr().out == "[core50] images from the bin cache\n"


def test_core50_run_cap():
    params, j_params = both_params(data="core50", num_runs=11)
    with pytest.raises(Exception, match="max number of runs for CORE50 is 10"):
        datasets.CORE50("ni", params)
    with pytest.raises(Exception, match="max number of runs for CORE50 is 10"):
        j_datasets.CORE50("ni", j_params)


# --------------------------------------------------------------- OpenLORIS

def test_openloris_matches_ocl_tpu(tmp_path, monkeypatch):
    """The factor's nine tasks (two on disk, the rest empty), resized to
    50x50 by PIL; each task shuffled with a third held out for validation."""
    monkeypatch.chdir(tmp_path)
    write_openloris(str(tmp_path))
    params, j_params = both_params(data="openloris", cl_type="ni", ns_type="illumination",
                                   val_size=0.34)

    def load(cls, p):
        ds = cls("ni", p)
        tasks = [ds.new_task(t) for t in (0, 1)]
        return ds, tasks

    ds, tasks = seeded(lambda: load(datasets.OpenLORIS, params), 12)
    jds, j_tasks = seeded(lambda: load(j_datasets.OpenLORIS, j_params), 12)
    assert ds.task_nums == jds.task_nums == 9
    assert_equal_pairs(ds.train_set, jds.train_set)
    assert_equal_pairs(ds.test_set, jds.test_set)
    assert_equal_pairs(ds.val_set, jds.val_set)
    for (x, y, labels), (jx, jy, j_labels) in zip(tasks, j_tasks):
        assert x.shape == (4, 50, 50, 3) and labels == j_labels
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
    assert [len(v[0]) for v in ds.val_set] == [2, 2]


def test_openloris_label_beyond_the_head(tmp_path, monkeypatch):
    """An image of DATAPATH's object 100 is labelled 100, past the 69 classes
    that both packages give OpenLORIS's head (n_classes_match). At the loss,
    ocl_tpu's cross entropy reads the label out of bounds as NaN (a filled
    gather): its loss is NaN and the row's gradient zero, and training goes
    on. The port's gather raises on the CPU (on the card the same gather
    runs in CUDA; not tried). Neither package remedies it (ROADMAP.md
    §3)."""
    from PIL import Image

    from ocl_tpu.ops.losses import cross_entropy as j_cross_entropy
    from ocl_tpu_torch.config import n_classes_match
    from ocl_tpu_torch.data.openloris_objects import DATAPATH
    from ocl_tpu_torch.ops.losses import cross_entropy

    monkeypatch.chdir(tmp_path)
    for task in (1, 2):
        for split in ("train", "test"):
            d = tmp_path / "datasets" / "openloris" / "clutter" / split / f"task{task}" / \
                DATAPATH[100]
            d.mkdir(parents=True)
            Image.fromarray(np.full((60, 60, 3), 90, np.uint8)).save(d / "0.jpg")
    params, _ = both_params(data="openloris", cl_type="ni", ns_type="clutter", val_size=0.0)
    x, y, labels = datasets.OpenLORIS("ni", params).new_task(0)
    n_cls = n_classes_match["openloris"]
    assert labels == {100} and n_cls == 69

    logits = np.random.RandomState(13).randn(2, n_cls).astype(np.float32)
    y2 = np.array([3, 100])
    loss, grad = jax.value_and_grad(j_cross_entropy)(jnp.asarray(logits), jnp.asarray(y2))
    assert np.isnan(float(loss))
    grad = np.asarray(grad)
    assert (grad[1] == 0).all() and np.isfinite(grad).all() and np.abs(grad[0]).sum() > 0
    with pytest.raises(RuntimeError, match="index 100 is out of bounds"):
        cross_entropy(torch.from_numpy(logits), torch.from_numpy(y2))


# ------------------------------------------------------- the slice as a whole

def test_cifar100_slice_er_aser_step_matches_ocl_tpu(tmp_path, monkeypatch):
    """A CIFAR-100 tree through both continuums (one run, 10 tasks of 10
    classes); then one ER + ASER step at the CIFAR-100 shapes (100 classes;
    a full 300-slot buffer of tasks 0-5, five images a class, so that the
    SV update finds candidates beyond its class-balanced eval set of two a
    class; a batch of task 6; SV update and retrieval) from the same
    weights, buffer, batch and draws: parameters and BN statistics within
    rtol 1e-3 / atol 1e-4, the buffer exactly."""
    from ocl_tpu.agents.base import TrainState as JTrainState
    from ocl_tpu.agents.er import ExperienceReplay as JExperienceReplay
    from ocl_tpu.buffer.state import init_buffer as j_init_buffer
    from ocl_tpu_torch import interop
    from ocl_tpu_torch.agents.base import TrainState
    from ocl_tpu_torch.agents.er import ExperienceReplay
    from ocl_tpu_torch.buffer.state import init_buffer
    from ocl_tpu_torch.models.resnet import Reduced_ResNet18
    from ocl_tpu_torch.optim import setup_opt
    from test_torch_aser import xla_summation_order
    from test_torch_model import random_weights

    monkeypatch.chdir(tmp_path)
    write_cifar100_templates(str(tmp_path))
    mem, n_cls, nf = 300, 100, 4
    hp = dict(data="cifar100", cl_type="nc", num_tasks=10, num_runs=1, agent="ER",
              update="ASER", retrieve="ASER", aser_type="asvm", k=3, n_smp_cls=2.0,
              mem_size=mem, eps_mem_batch=10, batch=10, learning_rate=0.01, nf=nf)
    params, j_params = both_params(**hp)
    got = seeded(lambda: stream_runs(continuum, "cifar100", "nc", params, runs=1), 14)
    want = seeded(lambda: stream_runs(j_continuum, "cifar100", "nc", j_params, runs=1), 14)
    assert_streams_equal(got, want)
    tasks = got[0][0]
    assert [len(t[1]) for t in tasks] == [50] * 10

    xla_summation_order(monkeypatch)
    weights, stats = random_weights(15, model=Reduced_ResNet18(n_cls, nf=nf))
    imgs = np.concatenate([t[0] for t in tasks[:6]])
    labels = np.concatenate([t[1] for t in tasks[:6]]).astype(np.int64)
    counts = np.bincount(labels, minlength=n_cls)
    x, y = tasks[6][0][:10], tasks[6][1][:10]
    key = jax.random.PRNGKey(16)

    j_agent = JExperienceReplay(j_params)
    jbuf = j_init_buffer(mem, "cifar100").replace(
        imgs=jnp.asarray(imgs), labels=jnp.asarray(labels, jnp.int32),
        current_index=jnp.asarray(mem, jnp.int32), n_seen_so_far=jnp.asarray(600, jnp.int32),
        class_counts=jnp.asarray(counts, jnp.int32))
    jw, js = (jax.tree_util.tree_map(jnp.asarray, t) for t in (weights, stats))
    state = JTrainState(params=jw, batch_stats=js, opt_state=j_agent.tx.init(jw), buffer=jbuf,
                        agent=None, rng=key)
    state, _ = jax.jit(j_agent._build_train_task_fn())(
        state, j_agent.before_train(y), jnp.asarray(x)[None], jnp.asarray(y, jnp.int32)[None])

    # ocl_tpu's draws from `key` (er.py:97 and :133, aser.py:130 and :44)
    rng, r_ret, _ = jax.random.split(key, 3)
    _, r_upd = jax.random.split(rng)
    r_rand, r_cand, r_coop = jax.random.split(r_ret, 3)
    r_thr, r_eval, r_ucand, _ = jax.random.split(r_upd, 4)

    def t(a):
        return torch.tensor(np.asarray(a))

    draws = {"retrieve": [{"rand": t(jax.random.gumbel(r_rand, (mem,))),
                           "cand": t(jax.random.gumbel(r_cand, (n_cls, mem))),
                           "coop": t(jax.random.gumbel(r_coop, (n_cls, mem)))}],
             "update": {"thr": t(jax.random.uniform(r_thr, ())),
                        "eval": t(jax.random.gumbel(r_eval, (n_cls, mem))),
                        "cand": t(jax.random.gumbel(r_ucand, (mem,)))}}
    agent = ExperienceReplay(params)
    model = Reduced_ResNet18(n_cls, nf=nf)
    model.load_state_dict(interop.from_jax(weights, stats), strict=True)
    tbuf = init_buffer(mem, "cifar100", "cpu")
    tbuf.imgs.copy_(torch.from_numpy(imgs))
    tbuf.labels.copy_(torch.from_numpy(labels))
    tbuf.class_counts.copy_(torch.from_numpy(counts))
    tbuf.current_index, tbuf.n_seen_so_far = mem, 600
    before = tbuf.imgs.clone()
    tstate = TrainState(model=model, optimizer=setup_opt("SGD", model.parameters(), 0.01),
                        buffer=tbuf, generator=torch.Generator())
    agent.step(tstate, agent.before_train(y), torch.from_numpy(x), torch.from_numpy(y),
               draws=draws)

    got_w = interop.to_jax(model.state_dict())
    want_w = jax.tree_util.tree_map(np.asarray, (state.params, state.batch_stats))
    for a, b in zip(jax.tree_util.tree_leaves(got_w), jax.tree_util.tree_leaves(want_w)):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4)
    for name in ("imgs", "labels", "class_counts"):
        np.testing.assert_array_equal(getattr(tbuf, name).numpy(),
                                      np.asarray(getattr(state.buffer, name)))
    assert tbuf.n_seen_so_far == int(state.buffer.n_seen_so_far) == 610
    assert not torch.equal(tbuf.imgs, before)   # the SV update replaced slots
