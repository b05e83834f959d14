"""Optimizer construction (counterpart of ocl_tpu/optim.py).

Reference utils/setup_elements.py:71-82: SGD(lr, weight_decay) and
Adam(lr, weight_decay). torch.optim couples weight decay into the gradient
(grad += wd * p) before the optimizer math, which is what ocl_tpu chains with
optax.add_decayed_weights ahead of optax.sgd / optax.scale_by_adam.
"""

from __future__ import annotations

import torch


def setup_opt(optimizer: str, parameters, lr: float, wd: float = 0.0) -> torch.optim.Optimizer:
    if optimizer == "SGD":
        return torch.optim.SGD(parameters, lr=lr, weight_decay=wd)
    if optimizer == "Adam":
        return torch.optim.Adam(parameters, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=wd)
    raise ValueError("wrong optimizer name: {!r}".format(optimizer))
