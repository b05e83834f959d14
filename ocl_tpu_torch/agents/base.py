"""Agent base: train state, trick-aware criterion, batching, evaluation
(counterpart of ocl_tpu/agents/base.py).

ocl_tpu runs each task as one jitted `lax.scan`; here each step runs from
Python on the device's stream, and the host reads results back once per task
(losses) and once per evaluation (accuracies; with --error_analysis, each
test set's predictions and logits).

The stacked hooks (counterpart of ocl_tpu/agents/base.py:145-174) train P
points at once, the stacked runs and the grid tuner of
experiment/parallel_run.py and parallel_tune.py: a `StackedState` holds P
train states as [P, ...] tensors, and `point_map` runs an agent's own
per-point code on all of them under `torch.func.vmap`, so each launch
serves every point; gradients, the optimizer step and the per-point
reductions (AGEM's projection, EWC's Fisher) act on the stacked leaves.
"""

from __future__ import annotations

import contextlib
import math
import pickle
import random
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from ocl_tpu_torch.agents import review
from ocl_tpu_torch.buffer.state import BufferState, StackedBuffer, init_buffer, valid_mask
from ocl_tpu_torch.config import n_classes_match
from ocl_tpu_torch.models import (
    Stacked,
    bind,
    feature_dim_for,
    features_eval,
    forward_eval,
    forward_teacher,
    forward_train,
    setup_architecture,
    snapshot,
)
from ocl_tpu_torch.ops import losses
from ocl_tpu_torch.optim import StackedOptimizer, setup_opt
from ocl_tpu_torch.parallel.mesh import gather_batch
from ocl_tpu_torch.utils.meters import AverageMeter

NCM_CHUNK = 256  # buffer rows per exemplar-feature forward in NCM eval


@dataclass
class TaskCtx:
    """Per-task label bookkeeping as fixed [n_classes] masks."""

    old_mask: torch.Tensor   # [C] classes from completed tasks
    new_mask: torch.Tensor   # [C] classes in the current task
    task_seen: int           # tasks completed before this one


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: Any  # a torch.optim.Optimizer; CN-DPM's per-slot state dict
    buffer: BufferState | None
    generator: torch.Generator  # on the device; every random draw of a run
    # agent-specific state, or None: the distillation teacher ("teacher", a
    # frozen model copy, and "has_teacher", a 0/1 float tensor) and EWC's
    # parameter-shaped dicts (agents/ewc_pp.py)
    agent: Any = None
    # the run's host-side draws, which the host needs without a device read:
    # GDumb's evictions and re-init seeds, SCR's jitter order
    host: random.Random | None = None


@dataclass
class StackedState:
    """P train states as one (the counterpart of ocl_tpu's [P, ...]-stacked
    TrainState): the models and the distillation teachers as `Stacked`, an
    optimizer with per-point hyperparameters, a StackedBuffer, and agent
    state as [P, ...] tensors (dicts of them for EWC) beside shared Python
    values. Each point keeps its own random draws: the generators and host
    `random.Random`s are those of `lanes`, and point p draws from lane
    `lane[p]` (a stacked run is its own lane; the grid points of one val run
    share theirs, as their ocl_tpu states share a key)."""

    model: Stacked
    optimizer: StackedOptimizer
    buffer: StackedBuffer | None
    generators: list          # torch.Generator of each lane
    hosts: list               # random.Random of each lane
    lane: list                # [P] the lane of each point
    agent: Any = None

    @property
    def points(self) -> int:
        return len(self.lane)

    def lane_index(self):
        """The [P] lane of each point on the device, or None where point p is
        lane p."""
        if self.lane == list(range(len(self.generators))):
            return None
        return torch.tensor(self.lane, device=next(iter(self.model.params.values())).device)

    def draw(self, draw_fn: Callable):
        """`draw_fn(generator)` on each lane, stacked to [P, ...] leaves."""
        trees = [draw_fn(g) for g in self.generators]
        stacked = torch.utils._pytree.tree_map(lambda *xs: torch.stack(xs), *trees)
        idx = self.lane_index()
        if idx is None:
            return stacked
        return torch.utils._pytree.tree_map(lambda t: t[idx], stacked)


def stack_ctx(ctx: TaskCtx, points: int) -> TaskCtx:
    """One TaskCtx for every point: its masks as [P, C]."""
    return TaskCtx(old_mask=ctx.old_mask.expand(points, -1),
                   new_mask=ctx.new_mask.expand(points, -1), task_seen=ctx.task_seen)


def point_map(ss: StackedState, fn: Callable, ctx: TaskCtx | None, *args):
    """`fn(view, ctx, *args)` for every point, under `torch.func.vmap`.

    `view` is a TrainState of one point: its `model` (and any teacher in its
    `agent`) is the stacked model's base, bound to that point's tensors
    (models.bind); its `buffer` a BufferState over the point's rows; its
    agent dict the point's tensors beside the shared Python values; no
    optimizer or generator (draws come in `args`). `ctx` is a TaskCtx with
    [P, C] masks (stack_ctx), or None; `args` are [P, ...] tensors or
    pytrees of them. Returns fn's tensors stacked to [P, ...]. Writes to the
    view's buffer and BN buffers land in the stacked tensors; the buffer's
    counters, which fn may advance, are shared and copied back once.

    Autograd runs outside vmap: `loss.sum().backward()` on fn's [P] losses
    puts each point's own gradient into the stacked leaves, since no point
    reads another's tensors."""
    ag = ss.agent if isinstance(ss.agent, dict) else {}
    mods = {k: v for k, v in ag.items() if isinstance(v, Stacked)}
    mapped = {k: v for k, v in ag.items() if isinstance(v, (torch.Tensor, dict))}
    static = {k: v for k, v in ag.items() if k not in mods and k not in mapped}
    buf = ss.buffer
    masks = () if ctx is None else (ctx.old_mask, ctx.new_mask)
    views = []

    def one(model_t, buf_t, mod_t, mapped_t, masks_t, *a):
        with contextlib.ExitStack() as stack:
            model = stack.enter_context(bind(ss.model.base, model_t))
            agent = None
            if ss.agent is not None:
                agent = dict(static, **mapped_t)
                for k, t in mod_t.items():
                    agent[k] = stack.enter_context(bind(mods[k].base, t))
            view = TrainState(model=model, optimizer=None,
                              buffer=None if buf is None else buf.point_view(buf_t),
                              generator=None, agent=agent)
            views.append(view)
            pctx = None if ctx is None else TaskCtx(masks_t[0], masks_t[1], ctx.task_seen)
            return fn(view, pctx, *a)

    out = torch.func.vmap(one)(ss.model.tensors(), () if buf is None else buf.tensors(),
                               {k: m.tensors() for k, m in mods.items()}, mapped, masks, *args)
    if buf is not None:
        buf.current_index = views[0].buffer.current_index
        buf.n_seen_so_far = views[0].buffer.n_seen_so_far
    return out


class ContinualLearner:
    """Step logic + host-side orchestration for one CL algorithm."""

    uses_buffer = True

    def __init__(self, params):
        self.params = params
        self.data = params.data
        self.device = torch.device(params.device)
        self.n_classes = n_classes_match[params.data]
        self.trick = params.trick
        self.needs_kd = bool(self.trick.get("kd_trick") or self.trick.get("kd_trick_star")
                             or params.agent == "LWF")
        self.ncm_classify = bool(self.trick.get("ncm_trick")) or \
            params.agent in ("ICARL", "SCR", "SCP")
        self.old_labels: list = []
        self.new_labels: list = []
        self.new_labels_zombie: list = []
        self.class_task_map: dict = {}
        self.task_seen = 0
        self.verbose = params.verbose
        # --error_analysis accumulators, one entry an evaluation (reference
        # agents/base.py:33-40)
        self.error_list: list = []
        self.new_class_score: list = []
        self.old_class_score: list = []
        self.fc_norm_new: list = []
        self.fc_norm_old: list = []
        self.bias_norm_new: list = []
        self.bias_norm_old: list = []
        # the mesh evaluation fans out over (--n_devices > 1; set by the
        # runner in each rank), or None
        self.eval_mesh = None

    # ---------------------------------------------------------------- state

    def init_state(self, seed: int) -> TrainState:
        """Fresh model, optimizer, buffer, agent state and generators for one
        run. The weights come from a CPU generator, so a seed gives the same
        weights on every device; the run's draws come from a generator on the
        device, and the draws the host needs from a `random.Random`. The
        three take distinct seeds spawned from `seed` (ocl_tpu splits its key
        in two): on the CPU, two generators with one seed would draw the same
        numbers for the weights and for the run. The first two words of
        generate_state(3) are those of generate_state(2), so the weights and
        device draws are those of a two-seed spawn."""
        p = self.params
        weights_seed, draws_seed, host_seed = (
            int(s) for s in np.random.SeedSequence(seed).generate_state(3))
        model = setup_architecture(p, torch.Generator().manual_seed(weights_seed), self.device)
        opt = setup_opt(p.optimizer, model.parameters(), p.learning_rate, p.weight_decay)
        buffer = init_buffer(p.mem_size, self.data, self.device) if self.uses_buffer else None
        generator = torch.Generator(device=self.device).manual_seed(draws_seed)
        self.old_labels, self.new_labels, self.task_seen = [], [], 0
        return TrainState(model=model, optimizer=opt, buffer=buffer, generator=generator,
                          agent=self.init_agent_state(model), host=random.Random(host_seed))

    def init_agent_state(self, model):
        if self.needs_kd:
            return {"teacher": snapshot(model),
                    "has_teacher": torch.zeros((), device=self.device)}
        return None

    # ------------------------------------------------------- label tracking

    def before_train(self, y_train) -> TaskCtx:
        self.new_labels = sorted(set(int(v) for v in np.asarray(y_train).reshape(-1)))
        for lbl in self.new_labels:
            self.class_task_map[lbl] = self.task_seen
        old_mask = torch.zeros(self.n_classes, dtype=torch.bool)
        old_mask[self.old_labels] = True
        new_mask = torch.zeros(self.n_classes, dtype=torch.bool)
        new_mask[self.new_labels] = True
        return TaskCtx(old_mask=old_mask.to(self.device), new_mask=new_mask.to(self.device),
                       task_seen=self.task_seen)

    def end_task_labels(self) -> None:
        """The host's label bookkeeping at the end of a task."""
        self.old_labels += [l for l in self.new_labels if l not in self.old_labels]
        self.new_labels_zombie = list(self.new_labels)
        self.new_labels = []
        self.task_seen += 1

    def after_train(self, state: TrainState, ctx: TaskCtx) -> TrainState:
        self.end_task_labels()
        if self.trick.get("review_trick") and self.uses_buffer:
            review.review_pass(self, state, ctx)
        if self.needs_kd:
            state.agent["teacher"].load_state_dict(state.model.state_dict())
            state.agent["has_teacher"].fill_(1.0)
        return state

    # ------------------------------------------------------------ criterion

    def criterion(self, logits, labels, ctx: TaskCtx, mask=None):
        """Trick-aware loss (reference agents/base.py:93-113)."""
        if self.trick.get("labels_trick"):
            return losses.labels_trick_ce(logits, labels, mask=mask)
        if self.trick.get("separated_softmax"):
            return losses.separated_softmax_ce(logits, labels, ctx.old_mask, ctx.new_mask,
                                               mask=mask)
        return losses.cross_entropy(logits, labels, mask=mask)

    def maybe_kd_blend(self, loss, logits, x, ctx: TaskCtx, agent_state, mask=None):
        """kd_trick (weight 1/t) and kd_trick_star (1/sqrt(t)) blending with
        the previous task's model, t = tasks seen + 1 (reference
        agents/exp_replay.py:42-47). The weights are fp32, as ocl_tpu's."""
        if not (self.trick.get("kd_trick") or self.trick.get("kd_trick_star")):
            return loss
        teacher_logits = forward_teacher(agent_state["teacher"], x, w=mask)
        kd = losses.kd_loss(logits, teacher_logits, mask=mask) * agent_state["has_teacher"]
        t = np.float32(ctx.task_seen + 1)
        w = float(np.float32(1.0) / (t if self.trick.get("kd_trick") else np.sqrt(t)))
        return w * loss + (1.0 - w) * kd

    # --------- stacked-state hooks (experiment/parallel_run.py and
    # parallel_tune.py). The host's label bookkeeping is shared by every
    # point, as ocl_tpu's agent0 carries it; agents whose end-of-task work
    # reduces over leaves, or whose task is not a scan over the stream's
    # batches, override these.

    # When True, the tuner hands stacked_train_task the raw task arrays
    # (x_train, y_train) of the val runs instead of batches: GDumb retrains
    # on its balanced memory, not the stream.
    stacked_consumes_raw = False

    def before_task_stacked(self, ss: StackedState) -> StackedState:
        return ss

    def after_train_stacked(self, ss: StackedState, ctx: TaskCtx) -> StackedState:
        """after_train for every point: the teacher takes each point's weights
        and `has_teacher` stays [P]. (review_trick does not stack: the
        runners send it to the sequential path.)"""
        self.end_task_labels()
        if self.needs_kd:
            ss.agent["teacher"].copy_(ss.model)
            ss.agent["has_teacher"].fill_(1.0)
        return ss

    def stacked_train_task(self, ss: StackedState, ctx: TaskCtx, xs, ys) -> StackedState:
        """One task for every point: xs [P, n_batches, B, ...] and ys
        [P, n_batches, B] (the tuner's shared batches expanded), one
        `stacked_step` a batch, the losses read back once."""
        loss_acc = [self.stacked_step(ss, ctx, xs[:, i], ys[:, i]) for i in range(xs.shape[1])]
        if loss_acc and getattr(self.params, "debug_nans", False):
            loss = torch.stack([la[0] for la in loss_acc]).cpu().numpy()
            if not np.all(np.isfinite(loss)):
                raise FloatingPointError("non-finite loss in task {} (--debug_nans)".format(
                    self.task_seen))
        return ss

    def stacked_step(self, ss: StackedState, ctx: TaskCtx, xb, yb, draws=None):
        """One online step of every point on xb [P, B, ...], yb [P, B];
        returns (loss [P], accuracy [P]). `draws` as `step`'s, stacked to
        [P, ...]; None draws them from the points' lanes."""
        raise NotImplementedError("{} has no stacked step".format(type(self).__name__))

    def evaluate_stacked(self, ss: StackedState, test_loaders):
        """[P, len(test_loaders)] accuracies of every point: nearest class
        mean (iCaRL, ncm_trick) or softmax. test_loaders as `evaluate`'s, each
        tensor with a leading point axis [P, nb, ...] (the stacked runs' own
        test sets) or without one (the tuner's shared sets)."""
        if self.ncm_classify:
            means = self.ncm_means_stacked(ss)
            seen = torch.zeros(self.n_classes, dtype=torch.bool)
            seen[self.old_labels] = True
            seen = seen.to(self.device)

            def predict(view, _, xb, means):
                f = features_eval(view.model, xb)
                f = f / torch.clamp(f.norm(dim=1, keepdim=True), min=1e-12)
                d = (f[:, None, :] - means[None, :, :]).square().sum(-1)
                return torch.where(seen[None, :], d, math.inf).argmin(1)

            return self._accuracies_stacked(ss, test_loaders, predict, means)
        return self._accuracies_stacked(
            ss, test_loaders, lambda view, _, xb: forward_eval(view.model, xb).argmax(1))

    def _accuracies_stacked(self, ss, test_loaders, predict, *extra):
        p = ss.points
        correct, total = [], []
        for x, y, m in test_loaders:
            if y.dim() == 2:  # shared: y [nb, B]
                x, y, m = (t.expand(p, *t.shape) for t in (x, y, m))
            c = torch.zeros(p, dtype=torch.int64, device=self.device)
            for i in range(x.shape[1]):
                pred = point_map(ss, predict, None, x[:, i], *extra)
                c = c + ((pred == y[:, i]) & m[:, i]).sum(1)
            correct.append(c)
            total.append(m.sum((1, 2)))
        correct = torch.stack(correct, 1).cpu().numpy()
        total = torch.stack(total, 1).cpu().numpy()
        return correct / np.maximum(total, 1)

    def ncm_means_stacked(self, ss: StackedState):
        """[P, n_classes, D] class means of every point's buffer, as
        `ncm_means` makes them (with --abl_ncm_zero_empty too), each point's
        noise drawn from its lane."""
        dim = feature_dim_for(self.data, self.params.nf)
        noise = ss.draw(lambda g: torch.randn(self.n_classes, dim, generator=g,
                                              device=self.device))
        return point_map(ss, lambda view, _, nz: self.ncm_means(view, nz), None, noise)

    def review_draws(self, state, batch):
        """The random draws of one review_trick batch: none here; SCR
        augments its batches."""
        return None

    def review_loss(self, model, xb, yb, ctx, draws=None):
        """The loss of one review_trick batch (agents/review.py), with that
        batch's `review_draws`."""
        return self.criterion(forward_train(model, xb), yb, ctx)

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
        """Accuracy on every task's test set: nearest class mean (iCaRL, SCR,
        ncm_trick), else softmax, instrumented with --error_analysis
        (counterpart of ocl_tpu/agents/base.py:284-335).

        test_loaders: list of (x [nb, B, H, W, C], y [nb, B], mask [nb, B])
        tensors on the device (see data.prepare_test_loaders).

        With `eval_mesh` set (--n_devices > 1), each rank holds its rows of
        every test batch (parallel/dp.py::shard_loaders) and the correct and
        total counts are summed over the ranks, so every rank returns the
        unsharded evaluation's accuracies (counterpart of the sharded eval of
        ocl_tpu/agents/base.py:297-330).
        """
        if self.ncm_classify:
            return self._evaluate_ncm(state, test_loaders)
        if getattr(self.params, "error_analysis", False):
            return self._evaluate_error_analysis(state, test_loaders)
        return self._accuracies(test_loaders, lambda xb: forward_eval(state.model, xb).argmax(1))

    def _accuracies(self, test_loaders, predict):
        correct, total = [], []
        for x, y, m in test_loaders:
            c = torch.zeros((), dtype=torch.int64, device=self.device)
            for xb, yb, mb in zip(x, y, m):
                c = c + ((predict(xb) == yb) & mb).sum()
            correct.append(c)
            total.append(m.sum())
        counts = torch.stack([torch.stack(correct), torch.stack(total)])
        if self.eval_mesh is not None:
            self.eval_mesh.all_reduce_(counts)
        correct, total = counts.cpu().numpy()
        accs = correct / np.maximum(total, 1)
        if self.verbose:
            print(accs)
        return accs

    def _evaluate_error_analysis(self, state: TrainState, test_loaders):
        """Softmax eval + old/new confusion instrumentation (counterpart of
        ocl_tpu/agents/base.py:337-427; reference agents/base.py:144-226):
        counts of old-task errors landing on the last task's classes (on) or
        elsewhere (oo), of last-task errors landing on older classes (no) or
        elsewhere (nn), the mean logits over the old and the new class
        columns, and the linear head's per-group weight and bias means (NaN
        for an empty group; none for a model without `linear`); dumps
        (correct_lb, predict_lb) to a `confusion` pickle in the working
        directory. Each test set's predictions and logits are read back once.
        Fanned out (`eval_mesh`), each rank computes its rows' logits and
        gathers every rank's, and rank 0 writes the pickle."""
        mesh = self.eval_mesh
        zombie = set(self.new_labels_zombie)
        old_minus_z = sorted(set(self.old_labels) - zombie)
        zombie_l = sorted(zombie)
        accs = np.zeros(len(test_loaders))
        no = nn_ = oo = on = 0
        new_score, old_score = AverageMeter(), AverageMeter()
        correct_lb, predict_lb = [], []
        for task, (x, y, m) in enumerate(test_loaders):
            logits = torch.stack([forward_eval(state.model, xb) for xb in x])
            if mesh is not None:
                logits, y, m = (gather_batch(mesh, t, 1) for t in (logits, y, m))
            logits = logits.reshape(-1, logits.shape[-1])
            ms = m.reshape(-1).cpu().numpy()
            logits = logits.cpu().numpy()[ms]
            ys = y.reshape(-1).cpu().numpy()[ms]
            preds = logits.argmax(1)
            accs[task] = float((preds == ys).mean()) if len(ys) else 0.0
            correct_lb += [task] * len(ys)
            predict_lb += [self.class_task_map.get(int(p), -1) for p in preds]
            wrong = preds[preds != ys]
            if task < self.task_seen - 1:
                on_tmp = int(np.isin(wrong, zombie_l).sum())
                oo += len(wrong) - on_tmp
                on += on_tmp
                if old_minus_z:
                    old_score.update(float(logits[:, old_minus_z].mean()), len(ys))
            elif task == self.task_seen - 1:
                no_tmp = int(np.isin(wrong, old_minus_z).sum())
                no += no_tmp
                nn_ += len(wrong) - no_tmp
                if zombie_l:
                    new_score.update(float(logits[:, zombie_l].mean()), len(ys))
        self.error_list.append((no, nn_, oo, on))
        self.new_class_score.append(new_score.avg())
        self.old_class_score.append(old_score.avg())
        linear = getattr(state.model, "linear", None)
        if linear is not None:
            # ocl_tpu's Dense kernel is [in, out]: its kernel[:, cols] is
            # weight[cols, :] here
            weight = linear.weight.detach().cpu().numpy()
            bias = linear.bias.detach().cpu().numpy()

            def group_mean(a, cols):
                return float(a[cols].mean()) if cols else float("nan")

            self.fc_norm_new.append(group_mean(weight, zombie_l))
            self.bias_norm_new.append(group_mean(bias, zombie_l))
            self.fc_norm_old.append(group_mean(weight, old_minus_z))
            self.bias_norm_old.append(group_mean(bias, old_minus_z))
        if self.verbose:
            # the reference's lines, in its order (agents/base.py:212-226)
            print(accs)
            print("no ratio: {}\non ratio: {}".format(no / (no + nn_ + 0.1), on / (oo + on + 0.1)))
            print(self.error_list)
            print(self.new_class_score)
            print(self.old_class_score)
            print(self.fc_norm_old)
            print(self.fc_norm_new)
            print(self.bias_norm_old)
            print(self.bias_norm_new)
        if mesh is None or mesh.rank == 0:
            with open("confusion", "wb") as fp:
                pickle.dump([correct_lb, predict_lb], fp)
        return accs

    def ncm_means(self, state: TrainState, noise=None):
        """[n_classes, D] unit class means of the buffer's exemplar features
        (eval mode, chunks of NCM_CHUNK rows, each feature L2-normalised). A
        class with no exemplar gets a normal-noise mean from the run's
        generator (`noise` [n_classes, D] replaces the draw); with
        --abl_ncm_zero_empty it gets 1e6 in every entry, out of reach.

        Fanned out (`eval_mesh`), each rank sweeps its share of the rows (of
        a slot-sharded buffer, the slots it holds), the sums and counts are
        summed over the ranks and rank 0's noise is used, so every rank holds
        the same means."""
        buf = state.buffer
        mesh = self.eval_mesh
        dim = feature_dim_for(self.data, self.params.nf)
        if mesh is None:
            imgs, labels, valid = buf.imgs, buf.labels, valid_mask(buf)
        elif hasattr(buf, "own_rows"):   # parallel/sharded_buffer.py
            imgs, labels, valid = buf.own_rows()
        else:
            s = mesh.span(buf.mem_size)
            imgs, labels, valid = buf.imgs[s], buf.labels[s], valid_mask(buf)[s]
        feats = torch.cat([features_eval(state.model, c) for c in imgs.split(NCM_CHUNK)]) \
            if imgs.shape[0] else imgs.new_zeros(0, dim)
        feats = feats / torch.clamp(feats.norm(dim=1, keepdim=True), min=1e-12)
        w = valid.float()
        # out of place, so that it also maps under vmap (ncm_means_stacked)
        sums = torch.zeros(self.n_classes, feats.shape[1], device=self.device).index_add(
            0, labels, feats * w[:, None])
        cnts = torch.zeros(self.n_classes, device=self.device).index_add(0, labels, w)
        if noise is None:
            noise = torch.randn(self.n_classes, dim, generator=state.generator,
                                device=self.device)
        if mesh is not None:
            mesh.all_reduce_(sums)
            mesh.all_reduce_(cnts)
            mesh.broadcast_(noise)
        has = (cnts > 0)[:, None]
        means = torch.where(has, sums / torch.clamp(cnts, min=1.0)[:, None], noise)
        means = means / torch.clamp(means.norm(dim=1, keepdim=True), min=1e-12)
        if getattr(self.params, "abl_ncm_zero_empty", False):
            means = torch.where(has, means, 1e6)
        return means

    def _evaluate_ncm(self, state: TrainState, test_loaders, noise=None):
        """Nearest-class-mean accuracy over the classes seen so far
        (counterpart of ocl_tpu/agents/base.py:429-543): argmin of the
        broadcast squared distance between a test feature and the means."""
        means = self.ncm_means(state, noise)
        seen = torch.zeros(self.n_classes, dtype=torch.bool)
        seen[self.old_labels] = True
        seen = seen.to(self.device)

        def predict(xb):
            f = features_eval(state.model, xb)
            f = f / torch.clamp(f.norm(dim=1, keepdim=True), min=1e-12)
            d = (f[:, None, :] - means[None, :, :]).square().sum(-1)
            return torch.where(seen[None, :], d, math.inf).argmin(1)

        return self._accuracies(test_loaders, predict)
