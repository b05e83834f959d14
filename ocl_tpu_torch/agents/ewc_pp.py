"""Online EWC, EWC++ (counterpart of ocl_tpu/agents/ewc_pp.py; reference
agents/ewc_pp.py). No buffer.

Every step adds the squared gradients of the full loss (penalty and
distillation included) to a temporary Fisher; before every
`fisher_update_after`-th step of a task (1-based) the temporary Fisher folds
into the running one, F <- (1 - alpha) F + (alpha / fua) T, and resets. The
loss adds lambda * sum(F_norm (theta - theta*)²) once a task has ended. After
each task the running Fisher is min-max normalised with one global min and
max, and the parameters are kept as theta*.

Agent state: "prev_params", "running_fisher", "tmp_fisher" and
"normalized_fisher" are dicts by parameter name, "has_prev" a 0/1 float
tensor, "step_in_task" a Python int.

In a data-parallel step (parallel/dp.py) each rank's loss is its share of
the whole loss, penalty included, and the temporary Fisher takes the square
of the gradient summed over the ranks: (Σ_r g_r)², not Σ_r g_r².

The stacked hooks (ocl_tpu/agents/ewc_pp.py:137-172): on a StackedState the
dicts hold [P, ...] leaves, the Fisher updates are elementwise, the penalty
is each point's own under vmap, and `after_train_stacked` min-max normalises
each point's Fisher with that point's min and max; one reduction over the
stacked leaves would mix points.
"""

from __future__ import annotations

import torch

from ocl_tpu_torch.agents.base import ContinualLearner, point_map
from ocl_tpu_torch.models import forward_train
from ocl_tpu_torch.optim import _per_point
from ocl_tpu_torch.parallel import dp


class EWC_pp(ContinualLearner):
    uses_buffer = False

    def __init__(self, params):
        super().__init__(params)
        self.lambda_ = float(params.lambda_)
        self.alpha = float(params.alpha)
        self.fua = int(params.fisher_update_after)

    def init_agent_state(self, model):
        def zeros():
            return {n: torch.zeros_like(p) for n, p in model.named_parameters()}

        ag = {"prev_params": {n: p.detach().clone() for n, p in model.named_parameters()},
              "has_prev": torch.zeros((), device=self.device),
              "running_fisher": zeros(), "tmp_fisher": zeros(), "normalized_fisher": zeros(),
              "step_in_task": 0}
        ag.update(super().init_agent_state(model) or {})
        return ag

    def fold_fisher(self, ag):
        """Before every fua-th step of a task: the temporary Fisher folds into
        the running one and resets (elementwise, so stacked leaves too)."""
        if (ag["step_in_task"] + 1) % self.fua == 0:
            with torch.no_grad():
                for n, r in ag["running_fisher"].items():
                    r.copy_((1.0 - self.alpha) * r + (self.alpha / self.fua) * ag["tmp_fisher"][n])
                    ag["tmp_fisher"][n].zero_()

    def loss(self, state, ctx, xb, yb):
        """One point's loss (penalty and distillation included) and batch
        accuracy."""
        ag = state.agent
        logits = forward_train(state.model, xb)
        loss = self.criterion(logits, yb, ctx)
        reg = sum((ag["normalized_fisher"][n] * (p - ag["prev_params"][n]).square()).sum()
                  for n, p in state.model.named_parameters())
        loss = loss + self.lambda_ * reg * ag["has_prev"]
        loss = self.maybe_kd_blend(loss, logits, xb, ctx, ag)
        return dp.share(loss), (logits.argmax(1) == yb).float().mean()

    def add_squared_grads(self, ag, named_params):
        with torch.no_grad():
            for n, p in named_params:
                ag["tmp_fisher"][n].add_(p.grad.square())
        ag["step_in_task"] += 1

    def step(self, state, ctx, xb, yb, draws=None):
        ag = state.agent
        self.fold_fisher(ag)
        state.optimizer.zero_grad()
        loss, acc = self.loss(state, ctx, *dp.local_rows(xb, yb))
        loss.backward()
        dp.reduce_grads(state.model)
        self.add_squared_grads(ag, state.model.named_parameters())
        state.optimizer.step()
        return loss.detach(), acc

    def stacked_step(self, ss, ctx, xb, yb, draws=None):
        ag = ss.agent
        self.fold_fisher(ag)
        ss.optimizer.zero_grad()
        loss, acc = point_map(ss, self.loss, ctx, xb, yb)
        loss.sum().backward()
        self.add_squared_grads(ag, ss.model.params.items())
        ss.optimizer.step()
        return loss.detach(), acc

    def train_task(self, state, ctx, x_train, y_train):
        state.agent["step_in_task"] = 0
        return super().train_task(state, ctx, x_train, y_train)

    def after_train(self, state, ctx):
        ag = state.agent
        with torch.no_grad():
            running = list(ag["running_fisher"].values())
            mx = torch.stack([f.max() for f in running]).max()
            mn = torch.stack([f.min() for f in running]).min()
            for n, f in ag["running_fisher"].items():
                ag["normalized_fisher"][n].copy_((f - mn) / (mx - mn + 1e-32))
            for n, p in state.model.named_parameters():
                ag["prev_params"][n].copy_(p)
            ag["has_prev"].fill_(1.0)
        return super().after_train(state, ctx)

    def before_task_stacked(self, ss):
        ss.agent["step_in_task"] = 0
        return ss

    def after_train_stacked(self, ss, ctx):
        """after_train for every point, the Fisher normalised per point."""
        ag = ss.agent
        with torch.no_grad():
            running = list(ag["running_fisher"].values())
            mx = torch.stack([f.flatten(1).amax(1) for f in running]).amax(0)  # [P]
            mn = torch.stack([f.flatten(1).amin(1) for f in running]).amin(0)
            for n, f in ag["running_fisher"].items():
                ag["normalized_fisher"][n].copy_(
                    (f - _per_point(mn, f)) / (_per_point(mx, f) - _per_point(mn, f) + 1e-32))
            for n, p in ss.model.params.items():
                ag["prev_params"][n].copy_(p)
            ag["has_prev"].fill_(1.0)
        return super().after_train_stacked(ss, ctx)
