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
"""

from __future__ import annotations

import numpy as np
import torch

from ocl_tpu_torch.agents.base import ContinualLearner
from ocl_tpu_torch.models import forward_train, setup_architecture
from ocl_tpu_torch.optim import setup_opt


def clip_by_global_norm_(grads, max_norm: float) -> None:
    """optax.clip_by_global_norm in place: scale every gradient by
    max_norm / ||g|| when the global norm ||g|| >= max_norm, else leave them
    (torch's clip_grad_norm_ scales by max_norm / (||g|| + 1e-6) instead).
    No host read."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    torch._foreach_mul_(grads, torch.where(norm < max_norm, 1.0, max_norm / norm))


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

    def train_task(self, state, ctx, x_train, y_train):
        order = list(range(x_train.shape[0]))
        state.host.shuffle(order)
        for i in order:
            self.greedy_balancing_update(x_train[i], int(y_train[i]), state.host)
        mem_x, mem_y = self.memory()

        # a fresh model and optimizer (reference :61-63)
        p = self.params
        weights = torch.Generator().manual_seed(state.host.getrandbits(63))
        state.model = setup_architecture(p, weights, self.device)
        state.optimizer = setup_opt(p.optimizer, state.model.parameters(), p.learning_rate,
                                    p.weight_decay)
        bs = p.batch
        nb = len(mem_y) // bs
        if nb > 0:
            idx = torch.cat([torch.randperm(len(mem_y), generator=state.generator,
                                            device=self.device)[: nb * bs].reshape(nb, bs)
                             for _ in range(p.mem_epoch)])
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
