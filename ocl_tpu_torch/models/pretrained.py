"""Pretrained backbones (counterpart of ocl_tpu/models/pretrained.py;
reference models/pretrained.py:4-7).

The reference wraps torchvision's ImageNet resnet18 with a replaced fc head;
no training path uses it. As in ocl_tpu, without torchvision: a full-width
ResNet-18 whose parameters can come from a local ``.npz`` in ocl_tpu's
format, so one file serves both packages: flax parameter paths joined by
"/" as keys (e.g. ``stages_0_0/Conv3x3_0/Conv_0/kernel``), convolution
kernels HWIO, Dense kernels [in, out]. The file maps onto the model through
`ocl_tpu_torch.interop`. `save_npz` writes a model's parameters in that
format.
"""

from __future__ import annotations

import numpy as np
import torch

from ocl_tpu_torch import interop
from ocl_tpu_torch.models.layers import torch_init_
from ocl_tpu_torch.models.resnet import ResNet18


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


def _unflat(flat):
    tree = {}
    for key, value in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def ResNet18_pretrained(nclasses, weights_npz: str | None = None,
                        generator: torch.Generator | None = None,
                        input_size: int = 224) -> torch.nn.Module:
    """A ResNet-18 (nf 64) with its weights drawn from `generator` (seed 0
    if None), then every parameter that `weights_npz` holds at its path and
    shape loaded from it; a missing key or one of another shape keeps its
    drawn value, and the BN running statistics keep their initial values
    (only parameters load, as in ocl_tpu). The linear head's width depends
    on the input resolution (the trunk pools by a fixed window): build at
    the resolution you will apply at."""
    model = ResNet18(nclasses, input_size=input_size)
    torch_init_(model, generator if generator is not None else torch.Generator().manual_seed(0))
    if weights_npz:
        params, stats = interop.to_jax(model.state_dict())
        with np.load(weights_npz) as f:
            disk = {k: f[k] for k in f.files}
        loaded = {key: disk[key] if key in disk and disk[key].shape == leaf.shape else leaf
                  for key, leaf in _flat(params)}
        model.load_state_dict(interop.from_jax(_unflat(loaded), stats), strict=True)
    return model


def save_npz(model: torch.nn.Module, path: str) -> None:
    """Write `model`'s parameters (not its BN running statistics) to `path`
    in ocl_tpu's .npz format, which `ResNet18_pretrained` and ocl_tpu's own
    loader read."""
    params, _ = interop.to_jax(model.state_dict())
    np.savez(path, **dict(_flat(params)))
