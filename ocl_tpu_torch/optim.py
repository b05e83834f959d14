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


ADAM_BETAS, ADAM_EPS = (0.9, 0.999), 1e-8


def _per_point(v, leaf):
    """A [P] vector shaped to broadcast over the stacked leaf `leaf` [P, ...]."""
    return v.reshape((-1,) + (1,) * (leaf.dim() - 1))


class StackedOptimizer:
    """SGD or Adam over stacked leaves [P, ...], each point with its own
    learning rate and weight decay ([P] tensors): the counterpart of
    `setup_opt(..., inject=True)` in ocl_tpu, whose injected hyperparameters
    are array leaves of a vmapped optimizer state.

    The update is torch.optim's, term for term, as multi-tensor (foreach) ops
    over the leaves: weight decay is coupled into the gradient
    (g + wd * p), then SGD takes p - lr * g and Adam its bias-corrected
    moments. Every point steps at once, so Adam's step count is one Python
    int. A point with lr 0 keeps its weights bit for bit. `zero_grad` and
    `step` mirror torch.optim.Optimizer's."""

    def __init__(self, name: str, params, lr, wd, state=None):
        if name not in ("SGD", "Adam"):
            raise ValueError("wrong optimizer name: {!r}".format(name))
        self.name = name
        self.params = list(params)
        self.lr = lr
        self.wd = wd
        self.step_count = 0
        if name == "Adam":
            self.exp_avg = [torch.zeros_like(p) for p in self.params]
            self.exp_avg_sq = [torch.zeros_like(p) for p in self.params]
        if state is not None:
            self.load_state(state)

    def per_leaf(self, v):
        return [_per_point(v, p) for p in self.params]

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self):
        ps = self.params
        grads = torch._foreach_add([p.grad for p in ps],
                                   torch._foreach_mul(ps, self.per_leaf(self.wd)))
        if self.name == "SGD":
            torch._foreach_mul_(grads, self.per_leaf(self.lr))
            torch._foreach_sub_(ps, grads)
            return
        self.step_count += 1
        b1, b2 = ADAM_BETAS
        torch._foreach_lerp_(self.exp_avg, grads, 1 - b1)
        torch._foreach_mul_(self.exp_avg_sq, b2)
        torch._foreach_addcmul_(self.exp_avg_sq, grads, grads, value=1 - b2)
        bc1 = 1 - b1 ** self.step_count
        bc2_sqrt = (1 - b2 ** self.step_count) ** 0.5
        den = torch._foreach_sqrt(self.exp_avg_sq)
        torch._foreach_div_(den, bc2_sqrt)
        torch._foreach_add_(den, ADAM_EPS)
        upd = torch._foreach_div(self.exp_avg, den)
        torch._foreach_mul_(upd, self.per_leaf(self.lr / bc1))
        torch._foreach_sub_(ps, upd)

    def state(self):
        """Adam's step count and moments (None under SGD)."""
        if self.name != "Adam":
            return None
        return {"step": self.step_count, "exp_avg": self.exp_avg, "exp_avg_sq": self.exp_avg_sq}

    def load_state(self, state):
        if self.name == "Adam" and state:
            self.step_count = int(state["step"])
            for dst, src in zip(self.exp_avg + self.exp_avg_sq,
                                list(state["exp_avg"]) + list(state["exp_avg_sq"])):
                dst.copy_(src)
