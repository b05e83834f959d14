"""FLOP counting of eager torch code (counterpart of ocl_tpu/utils/flops.py).

ocl_tpu walks a jaxpr; the port counts one call as it runs, under a
`TorchDispatchMode` that sees every aten op: 2 * MACs for convolutions and
matrix products, forward and backward (the formulas of
`torch.utils.flop_counter`), and 1 FLOP an output element for the aten
counterparts of ocl_tpu's ELEMENTWISE primitives: a deliberate
under-estimate, so that MFU figures err low. Reductions, copies and
indexing count nothing.

One departure: the input gradient of a strided convolution is charged its
forward's work. JAX writes that gradient as an lhs-dilated convolution, and
ocl_tpu's counter charges the zeros it inserts, stride² times the forward's
work, which contradicts its own under-estimate rule.

Eager code has no `scan`, `cond` or `while`: a step is counted as it runs.
Count a step in the state whose branch you mean (a full buffer takes the
branch ocl_tpu's `cond_mode="max"` charges).
"""

from __future__ import annotations

import copy

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten

# convolutions and matrix products: torch.utils.flop_counter's formulas
MATMUL = {aten.mm, aten.addmm, aten.bmm, aten.baddbmm, aten.convolution,
          aten._convolution, aten.cudnn_convolution, aten.convolution_backward}

# aten counterparts of ocl_tpu's ELEMENTWISE (utils/flops.py:15-19), by name
# without a trailing "_" (in place) or a leading "_foreach_" (a list of
# tensors): max/min are maximum/minimum and relu, logistic is sigmoid,
# integer_pow is pow, select_n is where and relu's backward
ELEMENTWISE = {
    "add", "sub", "mul", "div", "maximum", "minimum", "relu", "threshold_backward", "pow",
    "exp", "log", "tanh", "sigmoid", "rsqrt", "sqrt", "erf", "neg", "abs", "sign", "floor",
    "where", "clamp", "clamp_min", "clamp_max",
}


def _base_name(func) -> str:
    name = func.overloadpacket.__name__
    if name.startswith("_foreach_"):
        name = name[len("_foreach_"):]
    return name.rstrip("_")


def _elements(value) -> int:
    return sum(t.numel() for t in tree_leaves(value) if isinstance(t, torch.Tensor))


class FlopCount(TorchDispatchMode):
    """Counts the FLOPs of the aten ops run inside it: `matmul` (convolutions
    and matrix products) and `elementwise`; `total` is their sum."""

    def __init__(self):
        super().__init__()
        self.matmul = 0
        self.elementwise = 0

    @property
    def total(self) -> int:
        return self.matmul + self.elementwise

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        if packet in MATMUL:
            self.matmul += int(flop_registry[packet](*args, **kwargs, out_val=out))
        elif _base_name(func) in ELEMENTWISE:
            # an in-place op returns its first argument; a _foreach_ op in
            # place returns nothing and writes its first list
            self.elementwise += _elements(out if out is not None else args[0])
        return out


def estimate_fn_flops(fn, *args, **kwargs) -> int:
    """FLOPs of one call of `fn(*args, **kwargs)`, counted as it runs.

    The call runs on deep copies of `args` and `kwargs`, so counting leaves
    the caller's model, buffer, optimizer and generator as they were, and
    the counted step is no step of the run; a bound method's object
    (`agent.step`) is not copied."""
    args, kwargs = copy.deepcopy((args, kwargs))
    with FlopCount() as counter:
        fn(*args, **kwargs)
    return counter.total
