"""iCaRL, online variant (counterpart of ocl_tpu/agents/icarl.py; reference
agents/icarl.py).

BCE with logits over one-hot targets in a compact label space (labels
numbered in the order they first arrive, reference :43-46), summed over the
classes seen so far. Once a task has finished, a memory batch of `batch` rows
is appended with all-zero targets, and every old-class column's target
becomes the sigmoid of the previous task's model on the combined rows
(reference :57-62). Slots the buffer update wrote during this task are not
retrieved (reference :65). Evaluation is nearest-class-mean (agents/base.py).

Two parity-ablation switches, set as params attributes only, as in ocl_tpu
(tools/parity_vs_reference.py ICARL_* rows): `abl_icarl_noexcl` retrieves
without the updated-slot exclusion, and `abl_icarl_teacher_evalbn` runs the
teacher with its running BN statistics (eval mode) instead of the batch's.

ocl_tpu decides "is there a teacher" on the device with `lax.cond`; here it
is a host fact, the task count. On the first task the step runs on the
incoming batch alone: ocl_tpu's memory rows are all masked out there, and a
masked row changes neither the BN statistics nor the loss.

Stacked (the grid tuner, counterpart of ocl_tpu/agents/icarl.py:148-168):
the compact label map and the column masks are shared by every point, the
step's loss runs under vmap with them broadcast, and each point keeps its
own mask of updated slots ([P, mem_size + 1]).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ocl_tpu_torch.agents.base import ContinualLearner, point_map
from ocl_tpu_torch.buffer import build_update
from ocl_tpu_torch.buffer.retrieve import gumbel, random_retrieve
from ocl_tpu_torch.models import forward_eval, forward_teacher, forward_train, snapshot
from ocl_tpu_torch.ops.losses import bce_ohe


class Icarl(ContinualLearner):
    def __init__(self, params):
        super().__init__(params)
        self.update = build_update(self)
        self.compact: dict = {}   # original label -> compact column (per run)
        self.abl_noexcl = bool(getattr(params, "abl_icarl_noexcl", False))
        self.abl_evalbn = bool(getattr(params, "abl_icarl_teacher_evalbn", False))

    def init_state(self, seed):
        self.compact = {}
        return super().init_state(seed)

    def init_agent_state(self, model):
        return {"teacher": snapshot(model)}

    def draw(self, generator, batch):
        """One step's draws: the retrieval's Gumbel noise over the slots, then
        the update's (ocl_tpu's r_ret, r_upd)."""
        return {"retrieve": {"g": gumbel((self.params.mem_size,), generator, self.device)},
                "update": self.update.draw(generator, batch)}

    def train_task(self, state, ctx, x_train, y_train):
        self.start_task()
        return super().train_task(state, ctx, x_train, y_train)

    def start_task(self):
        """Per task, on the host and moved to the device once: the compact
        label map, the column masks, and a fresh mask of updated slots (one
        spare slot takes the writes of dropped items)."""
        for lbl in self.new_labels:
            self.compact.setdefault(lbl, len(self.compact))
        label_map = torch.zeros(self.n_classes, dtype=torch.int64)
        for orig, cid in self.compact.items():
            label_map[orig] = cid
        cols = torch.arange(self.n_classes)
        self.label_map = label_map.to(self.device)
        self.col_mask = (cols < len(self.old_labels) + len(self.new_labels)).to(self.device)
        self.old_cols = (cols < len(self.old_labels)).to(self.device)
        self.updated = torch.zeros(self.params.mem_size + 1, dtype=torch.bool, device=self.device)

    def loss(self, state, ctx, xb, yb, updated, g):
        """One point's loss; `updated` [mem_size + 1] its mask of updated
        slots, `g` its retrieval noise."""
        batch = xb.shape[0]
        targets = F.one_hot(self.label_map[yb], self.n_classes).float()
        x_all, row_mask = xb, None
        if ctx.task_seen > 0:
            excl = None if self.abl_noexcl else updated[:-1]
            mem_x, _, _, mem_mask = random_retrieve(state.buffer, batch, g, excl_mask=excl)
            x_all = torch.cat([xb, mem_x])
            row_mask = torch.cat([torch.ones_like(yb, dtype=torch.bool), mem_mask])
            targets = torch.cat([targets, torch.zeros_like(targets)])
            teacher = state.agent["teacher"]
            if self.abl_evalbn:
                # the ablation: running-statistic BN over every row
                q = torch.sigmoid(forward_eval(teacher, x_all))
            else:
                # the previous task's model in train mode (the reference
                # deepcopies it there): batch-statistic BN over the valid rows
                q = torch.sigmoid(forward_teacher(teacher, x_all, w=row_mask))
            targets = torch.where(self.old_cols[None, :], q, targets)
        logits = forward_train(state.model, x_all, row_mask)
        return bce_ohe(logits, targets, class_mask=self.col_mask, mask=row_mask)

    def step(self, state, ctx, xb, yb, draws=None):
        model, opt, buf = state.model, state.optimizer, state.buffer
        if draws is None:
            draws = self.draw(state.generator, xb.shape[0])
        opt.zero_grad()
        loss = self.loss(state, ctx, xb, yb, self.updated, draws["retrieve"]["g"])
        loss.backward()
        opt.step()
        replaced = self.update.run(model, buf, xb, yb, draws["update"])
        self.updated[torch.where(replaced >= 0, replaced, buf.mem_size)] = True
        return loss.detach(), torch.zeros((), device=self.device)

    def after_train(self, state, ctx):
        """The teacher takes this task's weights before the review pass, if
        any (ocl_tpu/agents/icarl.py:170-180)."""
        state.agent["teacher"].load_state_dict(state.model.state_dict())
        return super().after_train(state, ctx)

    # ------------------------------------------------------------- stacked

    def stacked_train_task(self, ss, ctx, xs, ys):
        self.start_task()
        self.updated = torch.zeros(ss.points, self.params.mem_size + 1, dtype=torch.bool,
                                   device=self.device)
        return super().stacked_train_task(ss, ctx, xs, ys)

    def stacked_step(self, ss, ctx, xb, yb, draws=None):
        if draws is None:
            draws = ss.draw(lambda g: self.draw(g, xb.shape[1]))
        ss.optimizer.zero_grad()
        loss = point_map(ss, self.loss, ctx, xb, yb, self.updated, draws["retrieve"]["g"])
        loss.sum().backward()
        ss.optimizer.step()
        with torch.no_grad():
            replaced = point_map(ss, lambda v, c, x, y, d: self.update.run(v.model, v.buffer,
                                                                           x, y, d),
                                 ctx, xb, yb, draws["update"])
        rows = torch.arange(ss.points, device=self.device)[:, None]
        self.updated[rows, torch.where(replaced >= 0, replaced, ss.buffer.mem_size)] = True
        return loss.detach(), torch.zeros(ss.points, device=self.device)

    def after_train_stacked(self, ss, ctx):
        ss.agent["teacher"].copy_(ss.model)
        return super().after_train_stacked(ss, ctx)
