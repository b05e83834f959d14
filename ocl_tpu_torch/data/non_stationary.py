"""Non-stationary (NI) task generators: noise, occlusion and blur
(counterpart of ocl_tpu/data/non_stationary.py; reference
continuum/non_stationary.py:64-220).

Images enter as uint8 HWC and leave as float32 in [0, 1] with the distortion
applied, from the same draws as ocl_tpu: noise from the global `np.random`,
the occluding square's corner from Python's global `random`. Blur is
ocl_tpu's per-image separable Gaussian (its documented deviation from the
reference, which also blurs across the batch axis). With `--plot_sample`,
each task's first 10 training images are saved as a PNG grid under
`result/plots/` (`plot_ns_samples`).
"""

from __future__ import annotations

import os
import random

import numpy as np


def _gaussian_kernel1d(sigma):
    # skimage's default: truncate=4.0
    radius = int(4.0 * sigma + 0.5)
    xs = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (xs / sigma) ** 2)
    return k / k.sum()


def apply_noise(x, factor, sig=0.1):
    """Additive Gaussian noise (reference non_stationary.py:64-79)."""
    out = x + factor * np.random.normal(0.0, sig, size=x.shape)
    return np.clip(out, 0.0, 1.0)


def apply_blur(x, factor):
    """Per-image separable Gaussian blur, edge-padded, along H then W
    (reference non_stationary.py:82-97)."""
    if factor <= 0:
        return x
    k = _gaussian_kernel1d(factor)
    pad = len(k) // 2
    src = np.asarray(x, np.float64)
    padded = np.pad(src, ((0, 0), (pad, pad), (0, 0), (0, 0)), mode="edge")
    out = np.zeros_like(src)
    for i, kv in enumerate(k):
        out += kv * padded[:, i: i + x.shape[1], :, :]
    padded = np.pad(out, ((0, 0), (0, 0), (pad, pad), (0, 0)), mode="edge")
    out = np.zeros_like(src)
    for i, kv in enumerate(k):
        out += kv * padded[:, :, i: i + x.shape[2], :]
    return np.clip(out, 0.0, 1.0)


def apply_occlusion(x, factor):
    """One square of ones, a `factor` of the side, at the same place in
    every image of the split (reference non_stationary.py:100-124)."""
    out = np.array(x)
    size = out.shape[1]
    half = int(factor * size) // 2
    cx = random.randint(min(half, size - half), max(half, size - half))
    cy = random.randint(min(half, size - half), max(half, size - half))
    out[:, max(cx - half, 0): min(cx + half, size),
        max(cy - half, 0): min(cy + half, size)] = 1
    return np.clip(out, 0.0, 1.0)


NS_MATCH = {"noise": apply_noise, "occlusion": apply_occlusion, "blur": apply_blur}


def make_ns(x_uint8, y, ns_type, factor):
    """(x float32 [0,1] distorted, y) for one task split."""
    x = np.asarray(x_uint8, np.float64) / 255.0
    if factor != 0:
        x = NS_MATCH[ns_type](x, factor)
    return x.astype(np.float32), y


def plot_ns_samples(train_set, ns_type, ns_factor, plot_dir="result/plots"):
    """Save a grid of the first 10 images of each task's train split
    (reference test_ns / show_sample, non_stationary.py:127-132); returns
    the PNGs' paths."""
    from ocl_tpu_torch.utils.plot import save_sample_grid

    paths = []
    for i, (x, _y) in enumerate(train_set):
        name = "ns_{}_task{}_factor{}.png".format(ns_type, i, ns_factor[i])
        paths.append(save_sample_grid(x[:10], os.path.join(plot_dir, name)))
    return paths


def construct_ns_multiple_wrapper(train_data, train_label, test_data, test_label,
                                  task_nums, img_size, val_size, ns_type, ns_factor,
                                  plot=False, plot_dir="result/plots"):
    """One (train, val, test) triple a task, task i distorted by
    ns_factor[i] (reference :182-220); with `plot`, the tasks' sample
    grids (`plot_ns_samples`)."""
    from ocl_tpu_torch.data.task_compose import train_val_test_split_ni

    (tr_x, tr_y, va_x, va_y, te_x, te_y) = train_val_test_split_ni(
        train_data, train_label, test_data, test_label, task_nums, img_size, val_size)
    train_set, val_set, test_set = [], [], []
    for i, factor in enumerate(ns_factor):
        train_set.append(make_ns(tr_x[i], tr_y[i], ns_type, factor))
        val_set.append(make_ns(va_x[i], va_y[i], ns_type, factor))
        test_set.append(make_ns(te_x[i], te_y[i], ns_type, factor))
    if plot:
        plot_ns_samples(train_set, ns_type, ns_factor, plot_dir)
    return train_set, val_set, test_set
