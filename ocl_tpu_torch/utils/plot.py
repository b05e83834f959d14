"""Sample-grid PNGs for --plot_sample (counterpart of ocl_tpu/utils/plot.py;
reference non_stationary.py:127-132, which opens a matplotlib window: the
port, like ocl_tpu, saves one PNG grid a task instead). numpy and PIL, the
latter imported where a grid is saved."""

from __future__ import annotations

import os

import numpy as np


def save_sample_grid(images, path, ncols=10, pad=2):
    """Tile float [0,1] (or uint8) NHWC images into one PNG at `path`, rows
    of `ncols` separated by `pad` black pixels; returns `path`."""
    from PIL import Image

    x = np.asarray(images)
    if x.dtype != np.uint8:
        x = (np.clip(x, 0.0, 1.0) * 255.0).astype(np.uint8)
    n, h, w, c = x.shape
    ncols = max(1, min(ncols, n))
    nrows = -(-n // ncols)
    grid = np.zeros((nrows * (h + pad) - pad, ncols * (w + pad) - pad, c), np.uint8)
    for i in range(n):
        r, col = divmod(i, ncols)
        grid[r * (h + pad): r * (h + pad) + h,
             col * (w + pad): col * (w + pad) + w] = x[i]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(grid.squeeze()).save(path)
    return path
