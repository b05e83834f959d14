"""Name registries of the port (counterpart of ocl_tpu/registry.py).

Entries resolve lazily, as in the JAX registry. Every dataset and every
agent of ocl_tpu is registered.
"""

from __future__ import annotations


def _lazy(path, name):
    def build(*args, **kwargs):
        import importlib

        mod = importlib.import_module(path)
        return getattr(mod, name)(*args, **kwargs)

    return build


data_objects = {
    "cifar100": _lazy("ocl_tpu_torch.data.datasets", "CIFAR100"),
    "cifar10": _lazy("ocl_tpu_torch.data.datasets", "CIFAR10"),
    "core50": _lazy("ocl_tpu_torch.data.datasets", "CORE50"),
    "mini_imagenet": _lazy("ocl_tpu_torch.data.datasets", "Mini_ImageNet"),
    "openloris": _lazy("ocl_tpu_torch.data.datasets", "OpenLORIS"),
    "synthetic": _lazy("ocl_tpu_torch.data.datasets", "Synthetic"),
}

agents = {
    "ER": _lazy("ocl_tpu_torch.agents.er", "ExperienceReplay"),
    "AGEM": _lazy("ocl_tpu_torch.agents.agem", "AGEM"),
    "EWC": _lazy("ocl_tpu_torch.agents.ewc_pp", "EWC_pp"),
    "LWF": _lazy("ocl_tpu_torch.agents.lwf", "Lwf"),
    "ICARL": _lazy("ocl_tpu_torch.agents.icarl", "Icarl"),
    "GDUMB": _lazy("ocl_tpu_torch.agents.gdumb", "Gdumb"),
    "SCR": _lazy("ocl_tpu_torch.agents.scr", "SupContrastReplay"),
    "CNDPM": _lazy("ocl_tpu_torch.agents.cndpm", "Cndpm"),
}
