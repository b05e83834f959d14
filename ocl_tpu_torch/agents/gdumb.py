"""GDumb: greedy class-balanced memory, retrained from scratch at the end of
each task (counterpart of ocl_tpu/agents/gdumb.py; reference agents/gdumb.py).

Per incoming image, in a shuffled order: keep it if its class is below the
per-class quota mem_size // classes seen, first evicting a random image of
the largest class when the memory is full (reference :19-31). The memory is
host-side bookkeeping (no model involved), moved to the device once a task.
At the end of the task a fresh model and optimizer take `mem_epoch` epochs of
minibatch steps over the memory, each gradient clipped to a global norm of
`clip` (reference :52-83). `minlr` is accepted and unused, as in ocl_tpu.

ocl_tpu evicts with Python's global, unseeded `random`; the port draws the
evictions, the stream order and each task's re-init seed from the run's
host `random.Random` (TrainState.host), so a seed fixes the run.

Stacked (the grid tuner, counterpart of ocl_tpu/agents/gdumb.py:77-162):
the balanced memory and the minibatch order do not depend on lr or wd, so
each val run (lane) builds its own on the host once, from its own draws,
exactly as its sequential run would, and the grid points of that val run
share it. Every point re-initialises from its lane's draw and retrains with
its own lr and wd, the global-norm clip taken per point. (ocl_tpu builds
every val run's memory and order from run 0's draws.)
"""

from __future__ import annotations

import numpy as np
import torch

from ocl_tpu_torch.agents.base import ContinualLearner, point_map
from ocl_tpu_torch.models import forward_train, setup_architecture, stack_models
from ocl_tpu_torch.optim import StackedOptimizer, _per_point, setup_opt


def clip_by_global_norm_(grads, max_norm: float) -> None:
    """optax.clip_by_global_norm in place: scale every gradient by
    max_norm / ||g|| when the global norm ||g|| >= max_norm, else leave them
    (torch's clip_grad_norm_ scales by max_norm / (||g|| + 1e-6) instead).
    No host read."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    torch._foreach_mul_(grads, torch.where(norm < max_norm, 1.0, max_norm / norm))


def clip_by_global_norm_stacked_(grads, max_norm: float) -> None:
    """clip_by_global_norm_ for every point of stacked gradients [P, ...],
    each point by its own global norm."""
    norm = torch.linalg.vector_norm(torch.stack([g.flatten(1).norm(dim=1) for g in grads]),
                                    dim=0)
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    torch._foreach_mul_(grads, [_per_point(scale, g) for g in grads])


class Gdumb(ContinualLearner):
    uses_buffer = False

    def __init__(self, params):
        super().__init__(params)
        self.mem_img: dict = {}   # class -> list of images (numpy)
        self.mem_c: dict = {}     # class -> count

    def init_state(self, seed):
        self.mem_img, self.mem_c = {}, {}
        return super().init_state(seed)

    def greedy_balancing_update(self, x, y: int, rng) -> None:
        """Offer image `x` of class `y` to the memory; `rng` (a
        `random.Random`) picks the evicted image."""
        k_c = self.params.mem_size // max(1, len(self.mem_img))
        if y not in self.mem_img or self.mem_c[y] < k_c:
            if sum(self.mem_c.values()) >= self.params.mem_size:
                cls_max = max(self.mem_c.items(), key=lambda kv: kv[1])[0]
                self.mem_img[cls_max].pop(rng.randrange(self.mem_c[cls_max]))
                self.mem_c[cls_max] -= 1
            if y not in self.mem_img:
                self.mem_img[y] = []
                self.mem_c[y] = 0
            self.mem_img[y].append(np.array(x, np.float32))
            self.mem_c[y] += 1

    def memory(self):
        """The memory as (images [N, H, W, C], labels [N]) on the device, in
        class insertion order."""
        xs, ys = [], []
        for c, imgs in self.mem_img.items():
            xs += imgs
            ys += [c] * self.mem_c[c]
        return (torch.from_numpy(np.stack(xs).astype(np.float32)).to(self.device),
                torch.tensor(ys, dtype=torch.int64).to(self.device))

    def build_memory(self, host, generator, x_train, y_train):
        """A task's host work: the stream offered to the memory in an order
        from `host`, the re-init's weight seed, then the retrain's minibatch
        order [steps, batch] from `generator` (None if the memory holds less
        than a batch). Returns (mem_x, mem_y, weight seed, idx)."""
        order = list(range(x_train.shape[0]))
        host.shuffle(order)
        for i in order:
            self.greedy_balancing_update(x_train[i], int(y_train[i]), host)
        mem_x, mem_y = self.memory()
        seed = host.getrandbits(63)
        bs = self.params.batch
        nb = len(mem_y) // bs
        idx = None
        if nb > 0:
            idx = torch.cat([torch.randperm(len(mem_y), generator=generator,
                                            device=self.device)[: nb * bs].reshape(nb, bs)
                             for _ in range(self.params.mem_epoch)])
        return mem_x, mem_y, seed, idx

    def train_task(self, state, ctx, x_train, y_train):
        mem_x, mem_y, seed, idx = self.build_memory(state.host, state.generator,
                                                    x_train, y_train)
        # a fresh model and optimizer (reference :61-63)
        p = self.params
        state.model = setup_architecture(p, torch.Generator().manual_seed(seed), self.device)
        state.optimizer = setup_opt(p.optimizer, state.model.parameters(), p.learning_rate,
                                    p.weight_decay)
        if idx is not None:
            self.retrain(state, ctx, mem_x, mem_y, idx)
        return state

    def retrain(self, state, ctx, mem_x, mem_y, idx):
        """One clipped optimizer step per row of `idx` [steps, batch], indices
        into the memory; returns the losses [steps] on the device."""
        model, opt = state.model, state.optimizer
        params = list(model.parameters())
        losses = []
        for idxb in idx:
            opt.zero_grad()
            loss = self.criterion(forward_train(model, mem_x[idxb]), mem_y[idxb], ctx)
            loss.backward()
            clip_by_global_norm_([q.grad for q in params], float(self.params.clip))
            opt.step()
            losses.append(loss.detach())
        return torch.stack(losses) if losses else torch.zeros(0, device=self.device)

    # ------------------------------------------------------------- stacked

    stacked_consumes_raw = True

    def stacked_train_task(self, ss, ctx, x_train, y_train):
        """One task for every point of the tuner from the raw task arrays:
        each lane's memory, re-init seed and order (build_memory, with the
        lane's own memory dicts), then a stacked retrain of fresh models."""
        lanes = len(ss.generators)
        if len(getattr(self, "lane_memory", ())) != lanes:
            self.lane_memory = [({}, {}) for _ in range(lanes)]
        built = []
        for lane in range(lanes):
            self.mem_img, self.mem_c = self.lane_memory[lane]
            built.append(self.build_memory(ss.hosts[lane], ss.generators[lane],
                                           x_train, y_train))
        p = self.params
        models = [setup_architecture(p, torch.Generator().manual_seed(b[2]), self.device)
                  for b in built]
        ss.model = stack_models([models[lane] for lane in ss.lane])
        ss.optimizer = StackedOptimizer(p.optimizer, ss.model.params.values(),
                                        ss.optimizer.lr, ss.optimizer.wd)
        if built[0][3] is None:
            return ss
        if len({b[1].shape[0] for b in built}) != 1:
            raise ValueError("GDumb's stacked retrain needs equally sized memories, got {}"
                             .format([b[1].shape[0] for b in built]))
        lane = torch.tensor(ss.lane, device=self.device)
        mem_x = torch.stack([b[0] for b in built])[lane]    # [P, N, H, W, C]
        mem_y = torch.stack([b[1] for b in built])[lane]
        idx = torch.stack([b[3] for b in built])[lane]      # [P, steps, batch]
        self.retrain_stacked(ss, ctx, mem_x, mem_y, idx)
        return ss

    def retrain_stacked(self, ss, ctx, mem_x, mem_y, idx):
        """`retrain` for every point: mem_x [P, N, ...], mem_y [P, N], idx
        [P, steps, batch]."""
        rows = torch.arange(ss.points, device=self.device)[:, None]
        clip = float(self.params.clip)

        def loss(view, c, xb, yb):
            return self.criterion(forward_train(view.model, xb), yb, c)

        for i in range(idx.shape[1]):
            ss.optimizer.zero_grad()
            rows_i = (rows, idx[:, i])
            point_map(ss, loss, ctx, mem_x[rows_i], mem_y[rows_i]).sum().backward()
            clip_by_global_norm_stacked_([q.grad for q in ss.optimizer.params], clip)
            ss.optimizer.step()
