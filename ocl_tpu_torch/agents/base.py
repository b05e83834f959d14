"""Agent base: train state, plain-CE criterion, batching, softmax evaluation
(counterpart of the slice of ocl_tpu/agents/base.py that ER needs).

ocl_tpu runs each task as one jitted `lax.scan`; here each step runs from
Python on the device's stream, and the host reads results back once per task
(losses) and once per evaluation (accuracies).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ocl_tpu_torch.buffer.state import BufferState, init_buffer
from ocl_tpu_torch.config import DEFAULT_TRICK, n_classes_match
from ocl_tpu_torch.models import forward_eval, setup_architecture
from ocl_tpu_torch.ops import losses
from ocl_tpu_torch.optim import setup_opt


@dataclass
class TaskCtx:
    """Per-task label bookkeeping as fixed [n_classes] masks."""

    old_mask: torch.Tensor   # [C] classes from completed tasks
    new_mask: torch.Tensor   # [C] classes in the current task
    task_seen: int           # tasks completed before this one


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    buffer: BufferState | None
    generator: torch.Generator  # on the device; every random draw of a run


class ContinualLearner:
    """Step logic + host-side orchestration for one CL algorithm."""

    uses_buffer = True

    def __init__(self, params):
        tricks = [k for k in DEFAULT_TRICK if params.trick.get(k)]
        if tricks:
            raise NotImplementedError("tricks {} are not ported yet".format(tricks))
        if getattr(params, "error_analysis", False):
            raise NotImplementedError("--error_analysis is not ported yet")
        self.params = params
        self.data = params.data
        self.device = torch.device(params.device)
        self.n_classes = n_classes_match[params.data]
        self.old_labels: list = []
        self.new_labels: list = []
        self.task_seen = 0
        self.verbose = params.verbose

    # ---------------------------------------------------------------- state

    def init_state(self, seed: int) -> TrainState:
        """Fresh model, optimizer, buffer and generator for one run. The
        weights come from a CPU generator, so a seed gives the same weights
        on every device; the run's draws come from a generator on the device."""
        p = self.params
        model = setup_architecture(p, torch.Generator().manual_seed(seed), self.device)
        opt = setup_opt(p.optimizer, model.parameters(), p.learning_rate, p.weight_decay)
        buffer = init_buffer(p.mem_size, self.data, self.device) if self.uses_buffer else None
        generator = torch.Generator(device=self.device).manual_seed(seed)
        self.old_labels, self.new_labels, self.task_seen = [], [], 0
        return TrainState(model=model, optimizer=opt, buffer=buffer, generator=generator)

    # ------------------------------------------------------- label tracking

    def before_train(self, y_train) -> TaskCtx:
        self.new_labels = sorted(set(int(v) for v in np.asarray(y_train).reshape(-1)))
        old_mask = torch.zeros(self.n_classes, dtype=torch.bool)
        old_mask[self.old_labels] = True
        new_mask = torch.zeros(self.n_classes, dtype=torch.bool)
        new_mask[self.new_labels] = True
        return TaskCtx(old_mask=old_mask.to(self.device), new_mask=new_mask.to(self.device),
                       task_seen=self.task_seen)

    def after_train(self, state: TrainState, ctx: TaskCtx) -> TrainState:
        self.old_labels += [l for l in self.new_labels if l not in self.old_labels]
        self.new_labels = []
        self.task_seen += 1
        return state

    # ------------------------------------------------------------ criterion

    def criterion(self, logits, labels, ctx: TaskCtx, mask=None):
        """Plain mean CE over the valid rows (the trick losses come later)."""
        return losses.cross_entropy(logits, labels, mask=mask)

    # ------------------------------------------------------------- training

    def train_learner(self, state: TrainState, x_train, y_train):
        """One task's online pass."""
        ctx = self.before_train(y_train)
        state = self.train_task(state, ctx, x_train, y_train)
        return self.after_train(state, ctx)

    def train_task(self, state, ctx, x_train, y_train):
        """Batchify, step through the batches, then read the losses back once."""
        xs, ys = self.batchify(state, x_train, y_train)
        loss_acc = [self.step(state, ctx, xs[i], ys[i]) for i in range(xs.shape[0])]
        if not loss_acc:
            return state
        loss, acc = torch.stack([torch.stack(la) for la in loss_acc]).T.cpu().tolist()
        if getattr(self.params, "debug_nans", False) and not np.all(np.isfinite(loss)):
            raise FloatingPointError("non-finite loss at step {} of task {} (--debug_nans)".format(
                int(np.nonzero(~np.isfinite(loss))[0][0]), self.task_seen))
        if self.verbose:
            for i in range(1, len(loss), 100):
                print("==>>> it: {}, avg. loss: {:.6f}, running train acc: {:.3f}"
                      .format(i, float(np.mean(loss[: i + 1])),
                              float(np.mean(acc[: i + 1]))))
        return state

    def step(self, state, ctx, xb, yb, draws=None):
        """One online step; returns (batch loss, batch accuracy) tensors."""
        raise NotImplementedError

    def batchify(self, state, x, y, batch_size=None):
        """Shuffle + reshape a task's data to [n_batches, B, ...] tensors on
        the device. With --epoch > 1 the batches repeat with a fresh shuffle
        per epoch (the reference DataLoader re-shuffles each epoch)."""
        bs = batch_size or self.params.batch
        epochs = max(1, int(getattr(self.params, "epoch", 1)))
        n = x.shape[0]
        n_batches = n // bs
        x = torch.from_numpy(np.asarray(x, np.float32)).to(self.device)
        y = torch.from_numpy(np.asarray(y, np.int64)).to(self.device)
        xs, ys = [], []
        for _ in range(epochs):
            perm = torch.randperm(n, generator=state.generator, device=self.device)
            perm = perm[: n_batches * bs]
            xs.append(x[perm].reshape(n_batches, bs, *x.shape[1:]))
            ys.append(y[perm].reshape(n_batches, bs))
        return torch.cat(xs), torch.cat(ys)

    # ------------------------------------------------------------- evaluate

    def evaluate(self, state: TrainState, test_loaders):
        """Softmax accuracy on every task's test set (counterpart of
        ocl_tpu/agents/base.py:284-335).

        test_loaders: list of (x [nb, B, H, W, C], y [nb, B], mask [nb, B])
        tensors on the device (see data.prepare_test_loaders).
        """
        correct, total = [], []
        for x, y, m in test_loaders:
            c = torch.zeros((), dtype=torch.int64, device=self.device)
            for xb, yb, mb in zip(x, y, m):
                pred = forward_eval(state.model, xb).argmax(1)
                c = c + ((pred == yb) & mb).sum()
            correct.append(c)
            total.append(m.sum())
        correct = torch.stack(correct).cpu().numpy()
        total = torch.stack(total).cpu().numpy()
        accs = correct / np.maximum(total, 1)
        if self.verbose:
            print(accs)
        return accs
