"""Dataset objects (counterpart of ocl_tpu/data/datasets.py).

Only the synthetic stream is ported so far, under the NC and NI protocols:
no dataset is on disk. `new_task` returns (x float32 NHWC in [0,1], y int
array, labels), exactly as the JAX package does, from the same numpy (and,
for occlusion, Python `random`) draws.
"""

from __future__ import annotations

import os
from abc import ABC, abstractmethod

import numpy as np

from ocl_tpu_torch.data.non_stationary import construct_ns_multiple_wrapper
from ocl_tpu_torch.data.task_compose import create_task_composition, load_task_with_labels


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
            if getattr(self.params, "plot_sample", False):
                raise NotImplementedError("--plot_sample is not ported yet")
            self.train_set, self.val_set, self.test_set = construct_ns_multiple_wrapper(
                self.train_data, self.train_label, self.test_data, self.test_label,
                self.task_nums, self.img_size, self.params.val_size,
                self.params.ns_type, self.params.ns_factor)
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
