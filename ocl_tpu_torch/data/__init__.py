"""Data streaming: continuum, datasets, test-set device preparation."""

from __future__ import annotations

import numpy as np
import torch

from ocl_tpu_torch.data.continuum import continuum  # noqa: F401


def prepare_test_loaders(test_data, params, device):
    """Pad each task's test set to [n_batches, test_batch, H, W, C] tensors on
    `device`, with int64 labels [n_batches, test_batch] and a bool mask of the
    real rows (counterpart of ocl_tpu/data/__init__.py:prepare_test_loaders).
    Built once per run; evaluation after every task re-reads them."""
    loaders = []
    bs = params.test_batch
    for x, y in test_data:
        x = np.asarray(x, np.float32)
        y = np.asarray(y, np.int64)
        n = x.shape[0]
        nb = max(1, -(-n // bs))
        pad = nb * bs - n
        mask = np.ones(n, bool)
        if pad:
            x = np.concatenate([x, np.zeros((pad,) + x.shape[1:], np.float32)])
            y = np.concatenate([y, np.zeros(pad, np.int64)])
            mask = np.concatenate([mask, np.zeros(pad, bool)])
        loaders.append((torch.from_numpy(x.reshape(nb, bs, *x.shape[1:])).to(device),
                        torch.from_numpy(y.reshape(nb, bs)).to(device),
                        torch.from_numpy(mask.reshape(nb, bs)).to(device)))
    return loaders
