"""Optimizer construction (counterpart of ocl_tpu/optim.py).

Reference utils/setup_elements.py:71-82: SGD(lr, weight_decay). torch.optim.SGD
couples weight decay into the gradient (grad += wd * p) before the step, which
is what ocl_tpu chains with optax.add_decayed_weights. Adam comes later.
"""

from __future__ import annotations

import torch


def setup_opt(optimizer: str, parameters, lr: float, wd: float = 0.0) -> torch.optim.Optimizer:
    if optimizer == "SGD":
        return torch.optim.SGD(parameters, lr=lr, weight_decay=wd)
    if optimizer == "Adam":
        raise NotImplementedError("Adam is not ported yet; use --optimizer SGD")
    raise ValueError("wrong optimizer name: {!r}".format(optimizer))
