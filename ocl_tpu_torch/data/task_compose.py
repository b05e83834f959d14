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


def train_val_test_split_ni(train_data, train_label, test_data, test_label,
                            task_nums, img_size, val_size=0.1):
    """Shuffled, equal task splits for the NI scenario, the first
    `val_size` of the shuffled train set held out for validation
    (reference data_utils.py:75-87)."""
    train_x, train_y = shuffle_data(train_data, train_label)
    n_val = int(len(train_x) * val_size)
    val_x, val_y = train_x[:n_val], train_y[:n_val]
    train_x, train_y = train_x[n_val:], train_y[n_val:]
    test_x, test_y = shuffle_data(test_data, test_label)

    def split(x, y):
        return (x.reshape(task_nums, -1, img_size, img_size, 3),
                y.reshape(task_nums, -1))

    return (*split(train_x, train_y), *split(val_x, val_y), *split(test_x, test_y))
