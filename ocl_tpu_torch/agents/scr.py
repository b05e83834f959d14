"""Supervised Contrastive Replay (counterpart of ocl_tpu/agents/scr.py;
reference agents/scr.py).

Per batch and --mem_iters: retrieve memory rows, join them to the incoming
batch, and take one SupCon step over two views of the joined rows: the
images and their augmentation (ops/augment.py). With --fused_replay (the
default) both views go through one masked forward, so their BN statistics
fold once over the valid rows of both; without it, two forwards, each
folding (the reference's order). The buffer update follows. Evaluation is
nearest-class-mean over the encoder's features (agents/base.py).

ocl_tpu skips the whole optimizer step with `lax.cond` when no memory row is
valid. Here the host decides: for the random, MIR and ASER retrievals no row
is valid exactly when the buffer is empty, which its Python-int counters say;
match and mem_match before their warm-up return no row, also a counter test;
after it, a retrieval that finds a class short returns none, which only the
device knows, so those two read the mask back once a step.

With review_trick, each review batch first runs a train-mode forward whose
output is dropped (reference agents/base.py:77): it folds the batch's BN
statistics one extra time (--scr_review_dead_forward, default True); then
the two-view loss with that batch's own augmentation.
"""

from __future__ import annotations

import torch

from ocl_tpu_torch.agents.base import ContinualLearner
from ocl_tpu_torch.buffer import build_retrieve, build_update
from ocl_tpu_torch.config import input_size_match
from ocl_tpu_torch.models import forward_train
from ocl_tpu_torch.ops.augment import draw_scr_transform, scr_transform
from ocl_tpu_torch.ops.losses import supcon_loss
from ocl_tpu_torch.parallel import dp


class SupContrastReplay(ContinualLearner):
    def __init__(self, params):
        super().__init__(params)
        self.retrieve = build_retrieve(self)
        self.update = build_update(self)
        self.temp = float(params.temp)
        self.fused_views = bool(getattr(params, "fused_replay", False))
        self.image_hw = tuple(input_size_match[params.data][:2])

    def draw_aug(self, state, batch):
        """The augmentation draws of `batch` images."""
        return draw_scr_transform(state.generator, state.host, batch, self.image_hw)

    def two_view_loss(self, model, x, y, mask, aug_draws):
        """SupCon loss over [x, scr_transform(x)]; `mask` [B] or None marks
        the valid rows. In a data-parallel step each rank forwards its rows
        of both views, and the projected features of every rank's rows are
        gathered before the loss, whose positives span the global batch;
        the rank's share is the loss over W."""
        aug = scr_transform(x, aug_draws)
        x_r, aug_r, m_r = dp.local_rows(x, aug, mask)
        if self.fused_views:
            m2 = None if m_r is None else torch.cat([m_r, m_r])
            f1, f2 = forward_train(model, torch.cat([x_r, aug_r]), m2).chunk(2)
        else:
            f1 = forward_train(model, x_r, m_r)
            f2 = forward_train(model, aug_r, m_r)
        feats = dp.gather_rows(torch.stack([f1, f2], dim=1))
        return dp.share(supcon_loss(feats, y, self.temp, mask=mask))

    def has_memory(self, buf, mem_mask) -> bool:
        """Whether a retrieval returned a valid row (see the module's
        docstring for when this reads the device)."""
        p = self.params
        if p.eps_mem_batch == 0 or p.mem_size == 0 or buf.current_index == 0:
            return False
        if p.retrieve in ("match", "mem_match"):
            if buf.n_seen_so_far <= p.eps_mem_batch * p.warmup:
                return False
            return bool(mem_mask.any())
        return True

    def step(self, state, ctx, xb, yb, draws=None):
        """`draws`, if given: {"iters": [{"retrieve", "aug"}] one entry a
        --mem_iters, "update"}; else they come from the run's generators."""
        model, opt, buf = state.model, state.optimizer, state.buffer
        iters = draws["iters"] if draws is not None else [None] * int(self.params.mem_iters)
        loss = torch.zeros((), device=self.device)
        for it in iters:
            ret = it["retrieve"] if it else self.retrieve.draw(state.generator, xb.shape[0])
            # SCR retrieves before any backward (reference agents/scr.py:49):
            # MIR scores with zero batch gradients
            grads = ({n: torch.zeros_like(q) for n, q in model.named_parameters()}
                     if self.params.retrieve == "MIR" else None)
            with torch.no_grad():
                mem_x, mem_y, mem_mask = self.retrieve.run(model, buf, xb, yb, ret, grads=grads)
            if not self.has_memory(buf, mem_mask):
                continue
            comb_x, comb_y = torch.cat([mem_x, xb]), torch.cat([mem_y, yb])
            comb_mask = torch.cat([mem_mask, torch.ones_like(yb, dtype=torch.bool)])
            aug = it["aug"] if it else self.draw_aug(state, comb_x.shape[0])
            opt.zero_grad()
            loss = self.two_view_loss(model, comb_x, comb_y, comb_mask, aug)
            loss.backward()
            dp.reduce_grads(model)
            opt.step()
        upd = draws["update"] if draws is not None else self.update.draw(state.generator,
                                                                           xb.shape[0])
        self.update.run(model, buf, xb, yb, upd)
        return loss.detach(), torch.zeros((), device=self.device)

    review_draws = draw_aug

    def review_loss(self, model, xb, yb, ctx, draws=None):
        if getattr(self.params, "scr_review_dead_forward", True):
            with torch.no_grad():
                forward_train(model, xb)
        return self.two_view_loss(model, xb, yb, None, draws)
