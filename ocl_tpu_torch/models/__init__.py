"""Model construction and apply helpers (counterpart of ocl_tpu/models/__init__.py).

`setup_architecture` builds the Reduced ResNet-18 per dataset,
SupConResNet for SCR, and CN-DPM's expert mixture (`models/ndpm.py`). The JAX
package's pure `forward_train(module, params, stats, x, w)` becomes
`forward_train(model, x, w)`: the model holds its parameters, and the
train-mode forward folds the batch's BN statistics into the model's running
buffers in place. A distillation teacher is a frozen copy of the model
(`snapshot`), and `functional_forward` runs the model on other tensors
(MIR's virtual step, GSS's per-sample gradients through `torch.func`).

The compute policy (ocl_tpu's `_policy_in` / `_policy_out`): every helper
runs a model whose `compute_dtype` is "bf16" under `torch.autocast` to
bfloat16 on its input's device, so convolutions and matmuls compute in
bf16, and returns fp32 outputs. Master parameters, their gradients, the BN
statistics (layers.BatchNorm reduces in fp32) and running buffers, losses
and optimizer state stay fp32. CN-DPM's mixture has no policy and computes
in fp32, as in ocl_tpu.

Stacked models (the stacked runs and tuner, experiment/parallel_run.py):
`Stacked` holds P models of one architecture as [P, ...] tensors, and
`bind` runs a model's own code on one point's tensors under
`torch.func.vmap`, so the forwards above serve every point in one launch
sequence, the train-mode BN folding each point's statistics into that
point's running buffers.
"""

from __future__ import annotations

import contextlib
import copy
from dataclasses import dataclass

import torch
from torch.nn.utils.stateless import _reparametrize_module

from ocl_tpu_torch.config import input_size_match, n_classes_match
from ocl_tpu_torch.models.layers import BatchNorm, torch_init_
from ocl_tpu_torch.models.ndpm import NDPM
from ocl_tpu_torch.models.resnet import Reduced_ResNet18, SupConResNet, pooled_cells

def feature_dim_for(data: str, nf: int = 20) -> int:
    """The Reduced ResNet-18 trunk's feature width on `data`'s images:
    160 / 640 / 2,560 at nf 20 and 32 / 84 / 128 px."""
    return pooled_cells(input_size_match[data][0]) * nf * 8


def setup_architecture(params, generator: torch.Generator, device) -> torch.nn.Module:
    """Reduced ResNet-18 for `params.data` (SupConResNet for SCR), its
    weights drawn from `generator` (a CPU generator, so a seed gives the same
    weights on every device) and moved to `device`. For CNDPM, the expert
    mixture of `params.max_experts` slots (`ndpm.NDPM`)."""
    if params.agent == "CNDPM":
        return NDPM(params, generator).to(device)
    nf = getattr(params, "nf", 20)
    cdt = getattr(params, "compute_dtype", "fp32") or "fp32"
    if params.agent in ("SCR", "SCP"):
        model = SupConResNet(dim_in=feature_dim_for(params.data, nf), head=params.head, nf=nf,
                             compute_dtype=cdt)
    else:
        model = Reduced_ResNet18(n_classes_match[params.data], nf=nf,
                                 feature_dim=feature_dim_for(params.data, nf), compute_dtype=cdt)
    return init_model(model, generator).to(device)


def init_model(model: torch.nn.Module, generator: torch.Generator) -> torch.nn.Module:
    """Fresh parameters and BN state for `model`, in place: every Conv2d and
    Linear weight drawn from `generator` (layers.torch_init_), BN scale 1,
    bias 0, running mean 0 and variance 1. Returns `model`."""
    torch_init_(model, generator)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
    return model


def param_count(model: torch.nn.Module) -> int:
    """Number of parameter elements (BN running statistics excluded)."""
    return sum(p.numel() for p in model.parameters())


def _apply(model, fn, x, *args, **kwargs):
    """`fn(x, ...)` under `model`'s compute policy: as it is for "fp32";
    for "bf16" under autocast to bfloat16 on x's device, its output cast
    back to fp32."""
    if getattr(model, "compute_dtype", "fp32") != "bf16":
        return fn(x, *args, **kwargs)
    with torch.autocast(x.device.type, dtype=torch.bfloat16):
        out = fn(x, *args, **kwargs)
    return out.float()


def forward_train(model, x, w=None):
    """Training-mode forward; returns logits and folds the batch's BN
    statistics into the running buffers. `w` [B] leaves masked rows out of
    those statistics. Gradients flow when the caller has them enabled."""
    return _apply(model, model, x, train=True, w=w)


@torch.no_grad()
def forward_eval(model, x):
    """Logits with the BN running statistics; no mutation, no gradients."""
    return _apply(model, model, x, train=False)


@torch.no_grad()
def features_eval(model, x):
    """Deep features in eval mode (BN running stats, no mutation)."""
    return _apply(model, model.features, x, train=False)


def features_train(model, x, w=None):
    """Deep features in train mode; folds the batch's BN statistics."""
    return _apply(model, model.features, x, train=True, w=w)


def functional_forward(model, tensors, x, train=False, w=None, fold=True):
    """`model`'s forward with `tensors` (parameters and buffers by name, any
    subset) in place of its own, through `torch.func.functional_call`, so
    `torch.func.grad`, `vmap` and `jvp` can differentiate with respect to
    them. Eval or train mode; gradients flow when enabled. A train-mode fold
    lands in the buffers that `tensors` supplies, else in the model's own;
    `fold=False` makes none."""
    return _apply(model, lambda xb: torch.func.functional_call(
        model, tensors, (xb,), {"train": train, "w": w, "fold": fold}), x)


def snapshot(model):
    """A frozen copy of `model` (weights and BN statistics), for distillation."""
    teacher = copy.deepcopy(model)
    teacher.requires_grad_(False)
    return teacher


@torch.no_grad()
def forward_teacher(teacher, x, w=None):
    """Teacher / previous-model logits for distillation (counterpart of
    ocl_tpu/models/__init__.py:92-103): the reference never switches its
    teacher to eval, so BN normalises with the batch's own statistics (rows
    where `w`); the teacher's running statistics stay as they are and no
    gradient flows."""
    return _apply(teacher, teacher, x, train=True, w=w, fold=False)


@dataclass
class Stacked:
    """P models of one architecture: `params` and `buffers` map each name of
    `base` to a [P, ...] tensor (the parameters leaves that take gradients
    where the models' did). `base` is a model of the architecture whose own
    tensors stand in for none of the points."""

    base: torch.nn.Module
    params: dict
    buffers: dict

    @property
    def points(self) -> int:
        return next(iter(self.params.values())).shape[0]

    def tensors(self):
        """(params, buffers): the pytree that vmap maps over."""
        return self.params, self.buffers

    def point(self, p: int) -> torch.nn.Module:
        """Point p as a model of its own (a copy)."""
        model = copy.deepcopy(self.base)
        with torch.no_grad():
            for name, t in model.named_parameters():
                t.copy_(self.params[name][p])
            for name, t in model.named_buffers():
                t.copy_(self.buffers[name][p])
        return model

    @torch.no_grad()
    def copy_(self, other: "Stacked") -> None:
        """Every point's tensors from `other`'s, in place (a teacher's
        snapshot of the live models)."""
        torch._foreach_copy_(list(self.params.values()) + list(self.buffers.values()),
                             list(other.params.values()) + list(other.buffers.values()))


def stack_models(models, requires_grad: bool | None = None) -> Stacked:
    """`Stacked` of `models`, copied (torch.func.stack_module_state).
    Parameters take gradients as the first model's did, unless
    `requires_grad` says."""
    params, buffers = torch.func.stack_module_state(list(models))
    grad = next(models[0].parameters()).requires_grad if requires_grad is None else requires_grad
    for t in params.values():
        t.requires_grad_(grad)
    return Stacked(copy.deepcopy(models[0]), params, buffers)


@contextlib.contextmanager
def bind(base: torch.nn.Module, tensors):
    """Within the block, `base` computes with `tensors` ((params, buffers)
    of one point under vmap) in place of its own: its forward, `features`
    and `named_parameters` see them, and a train-mode BN fold writes into
    the buffers given (torch.func.functional_call's mechanism)."""
    params, buffers = tensors
    with _reparametrize_module(base, {**params, **buffers}):
        yield base

