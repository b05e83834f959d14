"""Shared layers: masked torch-semantics BatchNorm, convs, pooling, init.

Counterpart of ocl_tpu/models/layers.py. Modules take NCHW tensors (the
ResNet permutes its NHWC input once, which leaves them in channels_last
memory). `PatchConv`, a TPU lowering no path uses, is not ported.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ocl_tpu_torch.parallel import dp


class BatchNorm(nn.Module):
    """BatchNorm2d semantics that can leave masked rows out of the statistics.

    As in torch: normalisation uses the biased batch variance, the running
    variance takes the unbiased n/(n-1) one, new = (1 - m) * old + m * batch
    with m = 0.1, eps 1e-5. `w` [B] weights rows in the batch statistics
    (fixed-shape memory batches carry validity masks), so n = sum(w) * H * W.
    Statistics are computed in fp32. nn.BatchNorm2d cannot drop masked rows,
    hence plain tensor code.

    A batch whose `w` is all zero stands for no batch at all (ocl_tpu skips
    such a pass with `lax.cond`): it folds nothing into the running
    statistics and normalises with them, so its outputs stay finite and a
    masked loss over them has zero gradients. The test is a `torch.where`,
    not a host branch. `fold=False` normalises with the batch's statistics
    but leaves the running ones alone (a distillation teacher, MIR's scoring
    forward on virtual weights).

    Inside a data-parallel step (parallel/dp.py) the rows are this rank's
    share of the global batch, and the count, Σw·x and Σw·(x - mean)² are
    summed over the ranks: the global batch's statistics, as ocl_tpu's SPMD
    program computes them.
    """

    def __init__(self, features: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x, train: bool, w=None, fold: bool = True):
        xf = x.float()
        if train:
            dims = (0, 2, 3)
            empty = None
            if w is None and dp.active() is None:
                n = float(x.numel() // x.shape[1])
                mean = xf.mean(dims)
                var = (xf - mean[:, None, None]).square().mean(dims)
            else:
                # weighted rows; in a data-parallel step the count, Σw·x and
                # Σw·(x - mean)² are summed over the ranks (dp.batch_sum,
                # differentiable; the identity outside one)
                spatial = x.shape[2] * x.shape[3]
                wf = (torch.ones(x.shape[0], device=x.device) if w is None
                      else w.float()).reshape(-1, 1, 1, 1)
                tot = dp.batch_sum(torch.cat([(wf.sum() * spatial).reshape(1),
                                              (xf * wf).sum(dims)]))
                empty = tot[0] == 0
                n = torch.clamp(tot[0], min=1.0)
                mean = tot[1:] / n
                var = dp.batch_sum(((xf - mean[:, None, None]).square() * wf).sum(dims)) / n
            if fold:
                with torch.no_grad():
                    if isinstance(n, float):
                        unbiased = var * (n / max(n - 1.0, 1.0))
                    else:
                        unbiased = var * (n / torch.clamp(n - 1.0, min=1.0))
                    m = self.momentum
                    new_mean = (1.0 - m) * self.running_mean + m * mean
                    new_var = (1.0 - m) * self.running_var + m * unbiased
                    if empty is not None:
                        new_mean = torch.where(empty, self.running_mean, new_mean)
                        new_var = torch.where(empty, self.running_var, new_var)
                    self.running_mean.copy_(new_mean)
                    self.running_var.copy_(new_var)
            if empty is not None:
                mean = torch.where(empty, self.running_mean, mean)
                var = torch.where(empty, self.running_var, var)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps) * self.weight.float()
        out = (xf - mean[:, None, None]) * inv[:, None, None] + self.bias.float()[:, None, None]
        return out.to(x.dtype)


def _autocast_dtype(x):
    """The dtype autocast computes x's device's convolutions and matmuls in,
    or None outside autocast."""
    device = x.device.type
    return torch.get_autocast_dtype(device) if torch.is_autocast_enabled(device) else None


class Conv2d(nn.Conv2d):
    """nn.Conv2d that honours autocast under torch.func.vmap too: there
    functorch's batching rule dispatches the convolution below autocast,
    which would leave it in fp32, so the layer casts its input and weight
    itself, as autocast does."""

    def forward(self, x):
        dtype = _autocast_dtype(x)
        if dtype is None:
            return super().forward(x)
        bias = None if self.bias is None else self.bias.to(dtype)
        return self._conv_forward(x.to(dtype), self.weight.to(dtype), bias)


class TorchLinear(nn.Linear):
    """nn.Linear that honours autocast under torch.func.vmap, as Conv2d."""

    def forward(self, x):
        dtype = _autocast_dtype(x)
        if dtype is None:
            return super().forward(x)
        bias = None if self.bias is None else self.bias.to(dtype)
        return F.linear(x.to(dtype), self.weight.to(dtype), bias)


def Conv3x3(in_planes: int, planes: int, stride: int = 1) -> Conv2d:
    return Conv2d(in_planes, planes, 3, stride=stride, padding=1, bias=False)


def Conv1x1(in_planes: int, planes: int, stride: int = 1) -> Conv2d:
    return Conv2d(in_planes, planes, 1, stride=stride, padding=0, bias=False)


def torch_init_(module: nn.Module, generator: torch.Generator) -> None:
    """Redraw every Conv2d/Linear parameter from torch's default distribution,
    U(-1/sqrt(fan_in), +1/sqrt(fan_in)) (kaiming_uniform with a=sqrt(5) for
    weights, the same bound for biases), from an explicit generator."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                bound = 1.0 / math.sqrt(fan_in)
                m.weight.uniform_(-bound, bound, generator=generator)
                if m.bias is not None:
                    m.bias.uniform_(-bound, bound, generator=generator)


def avg_pool(x, window: int):
    """torch avg_pool2d(x, k) on NCHW: kernel k, stride k, floor mode."""
    return F.avg_pool2d(x, window)
