"""Task composition helpers (counterpart of ocl_tpu/data/task_compose.py).

They draw from the global ``np.random`` stream in the same order as the JAX
package, so a seeded stream composes the same tasks in both packages.
"""

from __future__ import annotations

import numpy as np


def create_task_composition(class_nums, num_tasks, fixed_order=False, verbose=True):
    """Shuffle classes and chunk into tasks (reference data_utils.py:6-18)."""
    classes_per_task = class_nums // num_tasks
    total_classes = classes_per_task * num_tasks
    label_array = np.arange(0, total_classes)
    if not fixed_order:
        np.random.shuffle(label_array)
    task_labels = []
    for tt in range(num_tasks):
        off = tt * classes_per_task
        task_labels.append(list(label_array[off: off + classes_per_task]))
        if verbose:
            print("Task: {}, Labels:{}".format(tt, task_labels[tt]))
    return task_labels


def load_task_with_labels(x, y, labels):
    """Gather all samples whose label is in `labels` (reference data_utils.py:29-34)."""
    tmp = [np.where(y == i)[0] for i in labels]
    idx = np.concatenate(tmp, axis=None)
    return x[idx], y[idx]


def shuffle_data(x, y):
    perm = np.random.permutation(x.shape[0])
    return x[perm], y[perm]
