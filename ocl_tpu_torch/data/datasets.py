"""Dataset objects (counterpart of ocl_tpu/data/datasets.py).

The loaders read each dataset's own files under `./datasets/<name>/`: CIFAR
its python-pickle batches, Mini-ImageNet its kaggle cache pickles, CORe50
its paths/LUP/labels pickles and JPEG tree (through a bin cache of decoded
images), OpenLORIS its per-factor JPEG tree. `Synthetic` needs no files.
`new_task` returns (x float32 NHWC in [0,1], y int array, labels), exactly
as the JAX package does, from the same numpy (and, for occlusion, Python
`random`) draws in the same order.
"""

from __future__ import annotations

import glob
import os
import pickle
from abc import ABC, abstractmethod
from hashlib import md5

import numpy as np

from ocl_tpu_torch.data import native_io
from ocl_tpu_torch.data.non_stationary import construct_ns_multiple_wrapper
from ocl_tpu_torch.data.task_compose import (
    create_task_composition,
    load_task_with_labels,
    shuffle_data,
)


def _to_float(x):
    x = np.asarray(x)
    if x.dtype == np.uint8:
        return x.astype(np.float32) / 255.0
    return x.astype(np.float32)


class DatasetBase(ABC):
    """Reference continuum/dataset_scripts/dataset_base.py:4-47."""

    def __init__(self, dataset, scenario, task_nums, params):
        self.params = params
        self.scenario = scenario
        self.dataset = dataset
        self.task_nums = task_nums
        self.root = os.path.join("./datasets", self.dataset)
        self.test_set = []
        self.val_set = []
        self.download_load()

    @abstractmethod
    def download_load(self):
        ...

    @abstractmethod
    def setup(self, **kwargs):
        ...

    @abstractmethod
    def new_task(self, cur_task, **kwargs):
        ...

    @abstractmethod
    def new_run(self, **kwargs):
        ...

    def get_test_set(self):
        return [(_to_float(x), np.asarray(y)) for x, y in self.test_set]

    def clean_mem_test_set(self):
        self.test_set = None
        self.test_data = None
        self.test_label = None


class _SplitClassDataset(DatasetBase):
    """Shared NC/NI logic for cifar10/cifar100/mini_imagenet-style datasets.
    NI: one task per `ns_factor`, each an equal random split of the whole
    train and test sets distorted by its factor (data/non_stationary.py)."""

    n_classes = 0
    img_size = 32

    def __init__(self, name, scenario, params):
        if scenario == "ni":
            num_tasks = len(params.ns_factor)
        else:
            num_tasks = params.num_tasks
        super().__init__(name, scenario, num_tasks, params)

    def setup(self):
        if self.scenario == "ni":
            self.train_set, self.val_set, self.test_set = construct_ns_multiple_wrapper(
                self.train_data, self.train_label, self.test_data, self.test_label,
                self.task_nums, self.img_size, self.params.val_size,
                self.params.ns_type, self.params.ns_factor,
                plot=bool(getattr(self.params, "plot_sample", False)))
        elif self.scenario == "nc":
            self.task_labels = create_task_composition(
                class_nums=self.n_classes, num_tasks=self.task_nums,
                fixed_order=self.params.fix_order, verbose=self.params.verbose)
            self.test_set = []
            for labels in self.task_labels:
                x_test, y_test = load_task_with_labels(self.test_data, self.test_label, labels)
                self.test_set.append((x_test, y_test))
        else:
            raise ValueError("wrong scenario {!r}".format(self.scenario))

    def new_task(self, cur_task, **kwargs):
        if self.scenario == "ni":
            x_train, y_train = self.train_set[cur_task]
            labels = set(np.asarray(y_train).tolist())
        else:
            labels = self.task_labels[cur_task]
            x_train, y_train = load_task_with_labels(self.train_data, self.train_label, labels)
        return _to_float(x_train), np.asarray(y_train), labels

    def new_run(self, **kwargs):
        self.setup()
        return self.test_set


class CIFAR10(_SplitClassDataset):
    n_classes = 10
    img_size = 32

    def __init__(self, scenario, params):
        super().__init__("cifar10", scenario, params)

    def download_load(self):
        folder = os.path.join(self.root, "cifar-10-batches-py")
        xs, ys = [], []
        for i in range(1, 6):
            with open(os.path.join(folder, f"data_batch_{i}"), "rb") as f:
                d = pickle.load(f, encoding="bytes")
            xs.append(d[b"data"])
            ys.extend(d[b"labels"])
        self.train_data = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        self.train_label = np.asarray(ys)
        with open(os.path.join(folder, "test_batch"), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        self.test_data = np.asarray(d[b"data"]).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        self.test_label = np.asarray(d[b"labels"])


class CIFAR100(_SplitClassDataset):
    n_classes = 100
    img_size = 32

    def __init__(self, scenario, params):
        super().__init__("cifar100", scenario, params)

    def download_load(self):
        folder = os.path.join(self.root, "cifar-100-python")
        with open(os.path.join(folder, "train"), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        self.train_data = np.asarray(d[b"data"]).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        self.train_label = np.asarray(d[b"fine_labels"])
        with open(os.path.join(folder, "test"), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        self.test_data = np.asarray(d[b"data"]).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        self.test_label = np.asarray(d[b"fine_labels"])


class Mini_ImageNet(_SplitClassDataset):
    """Reference continuum/dataset_scripts/mini_imagenet.py: the 3 kaggle
    cache pickles' 100 classes x 600 images, each class shuffled and split
    5/6 train, 1/6 test."""

    n_classes = 100
    img_size = 84
    TEST_SPLIT = 1 / 6

    def __init__(self, scenario, params):
        super().__init__("mini_imagenet", scenario, params)

    def download_load(self):
        parts = []
        for split, n_cls in (("train", 64), ("val", 16), ("test", 20)):
            with open(os.path.join(self.root, f"mini-imagenet-cache-{split}.pkl"), "rb") as f:
                d = pickle.load(f)
            parts.append(d["image_data"].reshape([n_cls, 600, 84, 84, 3]))
        all_data = np.vstack(parts)
        del parts
        tr_x, tr_y, te_x, te_y = [], [], [], []
        n_test = int(600 * self.TEST_SPLIT)
        for i in range(len(all_data)):
            rx, ry = shuffle_data(all_data[i], np.ones((600,)) * i)
            te_x.append(rx[:n_test])
            te_y.append(ry[:n_test])
            tr_x.append(rx[n_test:])
            tr_y.append(ry[n_test:])
        self.train_data = np.concatenate(tr_x)
        self.train_label = np.concatenate(tr_y).astype(np.int64)
        self.test_data = np.concatenate(te_x)
        self.test_label = np.concatenate(te_y).astype(np.int64)


CORE50_NTASK = {"ni": 8, "nc": 9, "nic": 79, "nicv2_79": 79,
                "nicv2_196": 196, "nicv2_391": 391}
CORE50_SIZE = 128


def _pil_decode(paths, size, native_failed):
    """uint8 [n, size, size, 3]: each file through PIL, converted to RGB and
    resized to size x size. Raises, naming both decoders, where PIL is not
    installed."""
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(
            "no JPEG decoder for {} CORe50 images: the native decoder {} and PIL is not "
            "installed".format(len(paths), native_failed)) from e
    x = np.zeros((len(paths), size, size, 3), dtype=np.uint8)
    for i, p in enumerate(paths):
        x[i] = np.array(Image.open(p).convert("RGB").resize((size, size)))
    return x


class CORE50(DatasetBase):
    """Reference continuum/dataset_scripts/core50.py: paths.pkl/LUP.pkl/
    labels.pkl protocol, per-task on-demand JPEG decode, <= 10 runs. A run's
    test set is the last entry of its LUP; each task's train set is shuffled
    and its first val_size held out for validation."""

    def __init__(self, scenario, params):
        if isinstance(params.num_runs, int) and params.num_runs > 10:
            raise Exception("the max number of runs for CORE50 is 10")
        self._served = set()
        super().__init__("core50", scenario, CORE50_NTASK[scenario], params)

    def download_load(self):
        with open(os.path.join(self.root, "paths.pkl"), "rb") as f:
            self.paths = pickle.load(f)
        with open(os.path.join(self.root, "LUP.pkl"), "rb") as f:
            self.LUP = pickle.load(f)
        with open(os.path.join(self.root, "labels.pkl"), "rb") as f:
            self.labels = pickle.load(f)

    def _report(self, source):
        """Print, once per source, where this dataset's images came from."""
        if source not in self._served:
            self._served.add(source)
            print("[core50] images from {}".format(source))

    def _load_imgs(self, idx_list):
        """uint8 [n, 128, 128, 3] of the images `idx_list` names: from the
        md5-keyed bin cache if it holds them (--core50_cache, on by default;
        the file format is ocl_tpu's, so either package's cache serves the
        other), else decoded by the native decoder, else by PIL; a decode is
        written to the cache."""
        rel_paths = [self.paths[idx] for idx in idx_list]
        cache_file = None
        if getattr(self.params, "core50_cache", True):
            digest = md5("".join(rel_paths).encode("utf-8")).hexdigest()
            cache_file = os.path.join(self.root, "bin_cache", digest + "_x.bin")
            if os.path.exists(cache_file):
                self._report("the bin cache")
                return np.fromfile(cache_file, dtype=np.uint8).reshape(
                    len(rel_paths), CORE50_SIZE, CORE50_SIZE, 3)
        paths = [os.path.join(self.root, p) for p in rel_paths]
        x = native_io.decode_jpeg_batch(paths, CORE50_SIZE, CORE50_SIZE)
        if x is not None:
            self._report("the native decoder (libjpeg)")
        else:
            lib, why = native_io.load_library()
            x = _pil_decode(paths, CORE50_SIZE, "could not be built ({})".format(why)
                            if lib is None else "failed on a file (missing, corrupt or not "
                            "{0}x{0})".format(CORE50_SIZE))
            self._report("PIL")
        if cache_file is not None:
            os.makedirs(os.path.dirname(cache_file), exist_ok=True)
            x.tofile(cache_file)
        return x

    def setup(self, cur_run):
        self.val_set, self.test_set = [], []
        test_idx = self.LUP[self.scenario][cur_run][-1]
        self.test_data = self._load_imgs(test_idx)
        self.test_label = np.asarray(self.labels[self.scenario][cur_run][-1])
        if self.scenario == "nc":
            self.task_labels = self.labels[self.scenario][cur_run][:-1]
            for labels in self.task_labels:
                labels = list(set(labels))
                self.test_set.append(load_task_with_labels(self.test_data, self.test_label, labels))
        else:
            self.test_set = [(self.test_data, self.test_label)]

    def new_task(self, cur_task, **kwargs):
        cur_run = kwargs["cur_run"]
        train_idx = self.LUP[self.scenario][cur_run][cur_task]
        train_x = self._load_imgs(train_idx)
        train_y = np.asarray(self.labels[self.scenario][cur_run][cur_task])
        train_x, train_y = shuffle_data(train_x, train_y)
        n_val = int(len(train_x) * self.params.val_size)
        self.val_set.append((train_x[:n_val], train_y[:n_val]))
        x, y = train_x[n_val:], train_y[n_val:]
        return _to_float(x), y, set(y.tolist())

    def new_run(self, **kwargs):
        self.setup(kwargs["cur_run"])


OPENLORIS_NTASK = {"illumination": 9, "occlusion": 9, "pixel": 9,
                   "clutter": 9, "sequence": 12}


class OpenLORIS(DatasetBase):
    """Reference continuum/dataset_scripts/openloris.py: the per-factor JPEG
    tree `datasets/openloris/<factor>/<split>/task<i>/<object>/*.jpg`,
    resized to 50x50 by PIL. An image's label is its object's index in
    `openloris_objects.DATAPATH` (121 names), which can exceed the 69
    classes of the model's head (ROADMAP.md §3)."""

    def __init__(self, scenario, params):
        self.ns_type = params.ns_type
        super().__init__("openloris", scenario, OPENLORIS_NTASK[params.ns_type], params)

    def download_load(self):
        from PIL import Image

        from ocl_tpu_torch.data.openloris_objects import DATAPATH

        self.train_set = []
        for batch_num in range(1, self.task_nums + 1):
            train_x, train_y, test_x, test_y = [], [], [], []
            for i, obj in enumerate(DATAPATH):
                for split, xs, ys in (("train", train_x, train_y), ("test", test_x, test_y)):
                    files = glob.glob(os.path.join(
                        "datasets/openloris", self.ns_type, split,
                        f"task{batch_num}", obj, "*.jpg"))
                    xs.extend(np.array(Image.open(p).convert("RGB").resize((50, 50)))
                              for p in files)
                    ys.extend([i] * len(files))
            self.train_set.append((np.array(train_x), np.array(train_y)))
            self.test_set.append((np.array(test_x), np.array(test_y)))

    def new_task(self, cur_task, **kwargs):
        train_x, train_y = self.train_set[cur_task]
        train_x, train_y = shuffle_data(train_x, train_y)
        n_val = int(len(train_x) * self.params.val_size)
        self.val_set.append((train_x[:n_val], train_y[:n_val]))
        x, y = train_x[n_val:], train_y[n_val:]
        return _to_float(x), y, set(y.tolist())

    def new_run(self, **kwargs):
        pass

    def setup(self, **kwargs):
        pass


class Synthetic(_SplitClassDataset):
    """Deterministic class-clustered Gaussian image stream (no files needed).

    Each class c has a fixed random template image; samples are
    0.5 + scale*(template-0.5) + N(0, noise). `synthetic_difficulty` (0..1,
    default 0) shrinks class separation and raises noise.
    """

    n_classes = 10
    img_size = 32

    def __init__(self, scenario, params):
        self.n_classes = getattr(params, "synthetic_classes", 10)
        self.per_class = getattr(params, "synthetic_size", 2000)
        self.difficulty = float(getattr(params, "synthetic_difficulty", 0.0))
        super().__init__("synthetic", scenario, params)

    def download_load(self):
        gen = np.random.RandomState(1234)
        templates = gen.rand(self.n_classes, self.img_size, self.img_size, 3)
        scale = 1.0 - 0.85 * self.difficulty    # class separation
        noise = 0.15 + 0.25 * self.difficulty   # per-sample noise

        def make(n_per_class, seed):
            g = np.random.RandomState(seed)
            xs, ys = [], []
            for c in range(self.n_classes):
                base = 0.5 + scale * (templates[c] - 0.5)
                x = base + g.normal(0, noise,
                                    (n_per_class, self.img_size, self.img_size, 3))
                xs.append(np.clip(x, 0, 1))
                ys.append(np.full(n_per_class, c))
            x = np.concatenate(xs).astype(np.float32)
            return (np.clip(x * 255, 0, 255)).astype(np.uint8), np.concatenate(ys)

        self.train_data, self.train_label = make(self.per_class, 1)
        self.test_data, self.test_label = make(max(self.per_class // 5, 50), 2)
