"""Learning without Forgetting (counterpart of ocl_tpu/agents/lwf.py;
reference agents/lwf.py). No buffer.

loss = (1/t) CE + (1 - 1/t) KD, t = tasks seen + 1, against the previous
task's model as teacher (the frozen copy in the agent state, normalising
with the batch's statistics as the reference's never-switched-to-eval
teacher does, kd_manager.py:22-25); KD counts once a task has ended. In a
data-parallel step (parallel/dp.py) each rank takes its rows, and the
teacher's batch statistics, as the student's, are the global batch's.
"""

from __future__ import annotations

import numpy as np

from ocl_tpu_torch.agents.base import ContinualLearner, point_map
from ocl_tpu_torch.models import forward_teacher, forward_train
from ocl_tpu_torch.ops.losses import kd_loss
from ocl_tpu_torch.parallel import dp


class Lwf(ContinualLearner):
    uses_buffer = False

    def loss(self, state, ctx, xb, yb):
        """One point's loss and batch accuracy."""
        ag = state.agent
        logits = forward_train(state.model, xb)
        loss_new = self.criterion(logits, yb, ctx)
        loss_old = kd_loss(logits, forward_teacher(ag["teacher"], xb)) * ag["has_teacher"]
        w = float(np.float32(1.0) / np.float32(ctx.task_seen + 1))
        return dp.share(w * loss_new + (1.0 - w) * loss_old), \
            (logits.argmax(1) == yb).float().mean()

    def step(self, state, ctx, xb, yb, draws=None):
        state.optimizer.zero_grad()
        loss, acc = self.loss(state, ctx, *dp.local_rows(xb, yb))
        loss.backward()
        dp.reduce_grads(state.model)
        state.optimizer.step()
        return loss.detach(), acc

    def stacked_step(self, ss, ctx, xb, yb, draws=None):
        ss.optimizer.zero_grad()
        loss, acc = point_map(ss, self.loss, ctx, xb, yb)
        loss.sum().backward()
        ss.optimizer.step()
        return loss.detach(), acc
