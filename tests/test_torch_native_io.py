"""The port's JPEG batch decoder (ocl_tpu_torch/csrc/dataio.cpp through
data/native_io.py) against ocl_tpu's and PIL's, pixel for pixel (the same
libjpeg decodes for all three), with ocl_tpu's contract for a file of
another geometry or a missing one: None, so the caller decodes with PIL.
Then CORe50's order of sources (bin cache, native decoder, PIL), each
reported once, and the error that names both decoders when neither is
there."""

import os
import pickle
import sys

import numpy as np
import pytest

from ocl_tpu.data import native_io as j_native_io
from ocl_tpu_torch.config import default_params
from ocl_tpu_torch.data import datasets, native_io
from test_datasets import write_core50


@pytest.fixture(scope="module")
def built():
    """The port's library (built if its source changed); skips where the
    machine has no g++ or libjpeg headers, as tests/test_native_io.py
    does."""
    lib, why = native_io.load_library()
    if lib is None:
        pytest.skip("native toolchain unavailable: {}".format(why))
    return lib


def jpegs(folder, n=6, size=128, seed=0):
    from PIL import Image

    g = np.random.RandomState(seed)
    paths = []
    for i in range(n):
        p = os.path.join(folder, f"im{i}.jpg")
        Image.fromarray(g.randint(0, 255, (size, size, 3), np.uint8)).save(p, quality=90)
        paths.append(p)
    return paths


def test_decode_matches_ocl_tpu_and_pil(built, tmp_path):
    from PIL import Image

    paths = jpegs(str(tmp_path))
    got = native_io.decode_jpeg_batch(paths, 128, 128, n_threads=4)
    assert got is not None and got.shape == (6, 128, 128, 3) and got.dtype == np.uint8
    if j_native_io.build_library() is not None:
        np.testing.assert_array_equal(got, j_native_io.decode_jpeg_batch(paths, 128, 128))
    for i, p in enumerate(paths):
        np.testing.assert_array_equal(got[i], np.array(Image.open(p).convert("RGB")))


def test_decode_geometry_mismatch_returns_none(built, tmp_path):
    paths = jpegs(str(tmp_path), n=2, size=64)
    assert native_io.decode_jpeg_batch(paths, 128, 128) is None


def test_decode_missing_file_returns_none(built, tmp_path):
    paths = jpegs(str(tmp_path), n=2) + [os.path.join(str(tmp_path), "absent.jpg")]
    assert native_io.decode_jpeg_batch(paths, 128, 128) is None


def test_library_keyed_by_its_source(built, tmp_path, monkeypatch):
    """The library sits in build/ocl_tpu_torch/ under a hash of its source:
    an edited source names another library."""
    path = native_io.library_path()
    assert path.exists() and path.parent.name == "ocl_tpu_torch"
    assert path.parent.parent.name == "build" and path.name.startswith("libdataio_")
    edited = tmp_path / "dataio.cpp"
    edited.write_bytes(native_io.SOURCE.read_bytes() + b"// edited\n")
    monkeypatch.setattr(native_io, "SOURCE", edited)
    assert native_io.library_path() != path


def test_library_that_will_not_load_leaves_the_decode_to_pil(tmp_path, monkeypatch):
    """A library built on another machine whose libjpeg this one lacks
    fails to load: that reads as no native decoder (the caller takes PIL),
    with the loader's reason, as a failed build does."""
    junk = tmp_path / "libdataio_junk.so"
    junk.write_bytes(b"not a shared object")
    monkeypatch.setattr(native_io, "build_library", lambda: junk)
    lib, why = native_io.load_library.__wrapped__()
    assert lib is None and "libdataio_junk.so" in why


def core50(tmp_path, monkeypatch, **kw):
    """tests/test_datasets.py's CORe50 tree, run 0 loaded and both tasks
    streamed; returns (the dataset, its test data, the tasks)."""
    tmp_path.mkdir(parents=True, exist_ok=True)
    monkeypatch.chdir(tmp_path)
    if not os.path.exists("datasets"):
        write_core50(str(tmp_path))
    ds = datasets.CORE50("ni", default_params(device="cpu", data="core50", num_runs=1,
                                              val_size=0.0, verbose=False, **kw))
    ds.new_run(cur_run=0)
    np.random.seed(0)
    return ds, ds.test_data, [ds.new_task(t, cur_run=0)[0] for t in (0, 1)]


def test_core50_reports_each_source_once(built, tmp_path, monkeypatch, capsys):
    """Three loads a run: decoded natively the first time (and cached), read
    from the cache the next; one line for each source."""
    _, test_x, tasks = core50(tmp_path, monkeypatch)
    assert capsys.readouterr().out == "[core50] images from the native decoder (libjpeg)\n"
    _, cached_x, cached = core50(tmp_path, monkeypatch)
    assert capsys.readouterr().out == "[core50] images from the bin cache\n"
    np.testing.assert_array_equal(cached_x, test_x)
    for a, b in zip(cached, tasks):
        np.testing.assert_array_equal(a, b)


def test_core50_pil_serves_when_the_library_is_missing(built, tmp_path, monkeypatch, capsys):
    _, want_x, _ = core50(tmp_path / "native", monkeypatch, core50_cache=False)
    monkeypatch.setattr(native_io, "load_library", lambda: (None, "g++ failed"))
    _, got_x, _ = core50(tmp_path / "pil", monkeypatch, core50_cache=False)
    out = capsys.readouterr().out.splitlines()
    assert out == ["[core50] images from the native decoder (libjpeg)", "[core50] images from PIL"]
    np.testing.assert_array_equal(got_x, want_x)


@pytest.mark.parametrize("native", ["missing", "fails"])
def test_core50_without_any_decoder_raises(tmp_path, monkeypatch, native):
    """No PIL, and a native decoder that could not be built or that failed on
    a file: the error names both, and nothing is cached."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    if native == "missing":
        monkeypatch.setattr(native_io, "load_library", lambda: (None, "g++ failed"))
        match = r"native decoder could not be built \(g\+\+ failed\) and PIL is not installed"
    else:
        monkeypatch.setattr(native_io, "decode_jpeg_batch", lambda paths, h, w: None)
        monkeypatch.setattr(native_io, "load_library", lambda: (object(), None))
        match = r"native decoder failed on a file .* and PIL is not installed"
    monkeypatch.chdir(tmp_path)
    os.makedirs("datasets/core50")
    for name, obj in (("paths.pkl", ["imgs/a.jpg"]), ("LUP.pkl", {"ni": [[[0], [0]]]}),
                      ("labels.pkl", {"ni": [[[0], [0]]]})):
        with open(os.path.join("datasets/core50", name), "wb") as f:
            pickle.dump(obj, f)
    ds = datasets.CORE50("ni", default_params(device="cpu", data="core50", num_runs=1,
                                              verbose=False))
    with pytest.raises(RuntimeError, match=match):
        ds.new_run(cur_run=0)
    assert not os.path.exists("datasets/core50/bin_cache")
