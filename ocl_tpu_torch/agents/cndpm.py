"""CN-DPM agent: routing, wake updates and the sleep phase (counterpart of
ocl_tpu/agents/cndpm.py; reference agents/cndpm.py + models/ndpm/ndpm.py:44-187).

Per batch: route each sample by its least negative log joint (column 0, the
dummy expert, stands for the short-term memory), weight the expert NLLs by
the routing posterior, update only the used experts (gradient clipped by
value 0.5, each at its own MultiStepLR rate); when the STM fills, sleep: the
next free slot trains its VAE for `sleep_step_g` (4,000) and its classifier
for `sleep_step_d` (1,000) steps on STM samples (batch 50, with
replacement), the CRP prior records the STM's size, and the STM clears.

ocl_tpu runs a task as one `lax.scan` with the sleep as a `lax.cond`
branch. Here each wake step runs eagerly from Python over the born slots
only (`active`, a Python int: unborn slots have prior -inf, so they are
never routed to nor updated), and reads the STM's count back once, the
step's one device sync, to decide the sleep on the host. The sleep trains
slot k over slots 0..k (the precursors only for their lateral features).

The per-slot optimizers are a masked manual SGD / Adam over the stacked
[K, ...] leaves (`_masked_slot_update`), and the per-expert MultiStepLR is a
per-slot step counter (`sched_t`) mapped through `multistep_lr`: the sleep
trains the newborn at the base lr, the two scheduler steps at its end
(reference ndpm.py:184-185) push it past milestone 1, and each wake update
steps it again (ndpm.py:94-95).

TrainState for CN-DPM: `model` is the mixture (models/ndpm.py), `optimizer`
the per-slot optimizer state {"g": VAE, "d": classifier}, each {} under SGD
and {"m", "v": leaf dicts, "t": [K] steps} under Adam, and `agent` the dict
below (init_state). Every random draw of a step or a sleep can be handed in
(`draws`), so the tests give both packages the same ones.

Capacity note: when all `max_experts` slots are born, further sleeps clear
the STM without training, as in ocl_tpu (the reference grows without bound;
raise --max_experts if the saturation counter is nonzero).
"""

from __future__ import annotations

import random
import warnings

import numpy as np
import torch

from ocl_tpu_torch.agents.base import ContinualLearner, TrainState
from ocl_tpu_torch.config import input_size_match
from ocl_tpu_torch.models import ndpm_vars as V
from ocl_tpu_torch.models import setup_architecture
from ocl_tpu_torch.models.ndpm import (
    _nchw,
    _vae_nll_from_z,
    chilled_nll,
    cls_forward,
    leaf_views,
    ndpm_predict,
    slot_dicts,
    vae_encode_all,
    vae_nlls,
)
from ocl_tpu_torch.parallel import dp

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
EVAL_NOISE_SEED = 99   # ocl_tpu folds 99 into the run's key for evaluation


def _per_slot(v, a):
    """A [n] vector shaped to broadcast over the stacked leaf `a`."""
    return v.reshape((-1,) + (1,) * (a.dim() - 1))


@torch.no_grad()
def _masked_slot_update(opt_name, lr, grads, opt, params, slot_mask):
    """Manual per-slot SGD / Adam, in place, over stacked [n, ...] leaves.

    `params` and `grads` are dicts of leaves by name (`params` views into
    the mixture's stacked weights), `lr` [n] the per-slot rates (the
    per-expert MultiStepLR schedule, reference models/ndpm/component.py:
    53-55), `slot_mask` [n] bool the slots to update, `opt` {} (SGD) or
    {"m", "v": leaf dicts, "t": [n]} views of the Adam state. Gradients are
    clipped by value first. ocl_tpu's arithmetic, term for term, as
    multi-tensor (foreach) ops over the leaves: a per-slot factor is a 0-d
    tensor when n is 1 (the sleep), else one broadcast view a leaf."""
    names = list(params)
    ps = [params[k] for k in names]

    def per_leaf(v):
        return v.reshape(()) if v.numel() == 1 else [_per_slot(v, p) for p in ps]

    gs = torch._foreach_clamp_max(torch._foreach_clamp_min(
        [grads[k] for k in names], -V.CLIP_VALUE), V.CLIP_VALUE)
    mask = slot_mask.to(torch.float32)
    if opt_name != "Adam":
        torch._foreach_mul_(gs, per_leaf(mask * lr))
        torch._foreach_sub_(ps, gs)
        return
    opt["t"].add_(slot_mask.to(opt["t"].dtype))
    tf = torch.clamp(opt["t"], min=1).to(torch.float32)
    bm = per_leaf(mask)
    ms, vs = [opt["m"][k] for k in names], [opt["v"][k] for k in names]
    # m += mask * ((1 - b1) g + (b1 - 1) m); v likewise with (1 - b2) g g
    dm = torch._foreach_mul(gs, 1 - ADAM_B1)
    torch._foreach_add_(dm, torch._foreach_mul(ms, ADAM_B1 - 1))
    torch._foreach_mul_(dm, bm)
    torch._foreach_add_(ms, dm)
    dv = torch._foreach_mul(gs, 1 - ADAM_B2)
    torch._foreach_mul_(dv, gs)
    torch._foreach_add_(dv, torch._foreach_mul(vs, ADAM_B2 - 1))
    torch._foreach_mul_(dv, bm)
    torch._foreach_add_(vs, dv)
    # p -= mask * lr (m / bc1) / (sqrt(v / bc2) + eps)
    step = torch._foreach_div(ms, per_leaf(1 - ADAM_B1 ** tf))
    torch._foreach_mul_(step, per_leaf(lr))
    den = torch._foreach_div(vs, per_leaf(1 - ADAM_B2 ** tf))
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, ADAM_EPS)
    torch._foreach_div_(step, den)
    torch._foreach_mul_(step, bm)
    torch._foreach_sub_(ps, step)


def multistep_lr(base_lr, sched_t, milestones=V.LR_MILESTONES, gamma=V.LR_GAMMA):
    """Per-slot torch MultiStepLR: lr * gamma^(milestones passed). `sched_t`
    [K] counts each expert's scheduler.step() calls (reference
    component.py:53-55 builds one MultiStepLR per component; ndpm.py:95
    steps it after every wake update and ndpm.py:184-185 twice at sleep
    end)."""
    passed = torch.zeros_like(sched_t)
    for m in milestones:
        passed = passed + (sched_t >= m).to(sched_t.dtype)
    return base_lr * gamma ** passed.to(torch.float32)


def _slice_opt(opt, lo, hi):
    """Views [lo:hi] of a part's optimizer state ({} under SGD)."""
    if not opt:
        return {}
    return {"m": leaf_views(opt["m"], lo, hi), "v": leaf_views(opt["v"], lo, hi),
            "t": opt["t"][lo:hi]}


class Cndpm(ContinualLearner):
    uses_buffer = False

    def __init__(self, params):
        super().__init__(params)
        self.K = int(params.max_experts)
        self.stm_capacity = int(params.stm_capacity)

    def init_state(self, seed: int) -> TrainState:
        """The mixture from a CPU generator, fresh per-slot optimizer state,
        the agent dict, and the run's generators (as the base class spawns
        them, plus a fourth word that seeds evaluation's noise)."""
        p = self.params
        weights_seed, draws_seed, host_seed, eval_seed = (
            int(s) for s in np.random.SeedSequence(seed).generate_state(4))
        model = setup_architecture(p, torch.Generator().manual_seed(weights_seed), self.device)
        self.old_labels, self.new_labels, self.task_seen = [], [], 0
        K, B, dev = self.K, p.batch, self.device
        shape = tuple(input_size_match[self.data])

        def opt_for(part):
            if p.optimizer != "Adam":
                return {}
            leaves = model.part(part)
            return {"m": {k: torch.zeros_like(v) for k, v in leaves.items()},
                    "v": {k: torch.zeros_like(v) for k, v in leaves.items()},
                    "t": torch.zeros(K, dtype=torch.int64, device=dev)}

        agent = {
            # CRP prior log-counts [1 + K]: column 0 (STM) starts at
            # log_alpha, unborn experts at -inf (reference priors.py:24-63)
            "log_counts": torch.cat([torch.tensor([float(p.log_alpha)]),
                                     torch.full((K,), -float("inf"))]).to(dev),
            "active": 0,            # experts born (host int)
            # the STM: stm_capacity + B rows; a wake step starts below
            # capacity, so its last row is never a routed sample's and
            # takes the samples that are not routed to the STM
            "stm_x": torch.zeros((self.stm_capacity + B,) + shape, device=dev),
            "stm_y": torch.zeros(self.stm_capacity + B, dtype=torch.int64, device=dev),
            "stm_count": 0,         # host int, read back once a wake step
            "saturated_sleeps": 0,
            # per-expert MultiStepLR step counters (the g and d schedulers
            # always step together, reference expert.py:54-58)
            "sched_t": torch.zeros(K, dtype=torch.int64, device=dev),
            "eval_seed": eval_seed,
        }
        return TrainState(model=model, optimizer={"g": opt_for("vae"), "d": opt_for("cls")},
                          buffer=None,
                          generator=torch.Generator(device=dev).manual_seed(draws_seed),
                          agent=agent, host=random.Random(host_seed))

    # ------------------------------------------------------------ training

    def _noise(self, state, rows, n):
        return [torch.randn(rows, V.VAE_Z_SAMPLES, V.VAE_Z_DIM, generator=state.generator,
                            device=self.device) for _ in range(n)]

    def wake_loss(self, state, xb, yb, noise):
        """The wake loss over the dummy and the born slots (reference
        ndpm.py:44-95): returns (loss, to_stm [B], usage [1 + n], gradient
        leaves {"vae", "cls"}: [n, ...] autograd leaves sharing the
        weights' storage). `noise` holds 1 + n draws of [B, S, z]."""
        ag, model, n = state.agent, state.model, state.agent["active"]
        x = _nchw(xb)
        leaves = {part: leaf_views(model.part(part), 0, n, grad=True) for part in ("vae", "cls")}
        g = vae_nlls(model.part("dummy_vae"), slot_dicts(leaves["vae"]), x, noise)
        d = chilled_nll(cls_forward(model.part("dummy_cls"), slot_dicts(leaves["cls"]), x),
                        yb, self.params.classifier_chill)
        nll = g + d                                                    # [B, 1 + n]
        nl_joint = nll.detach() - ag["log_counts"][None, : 1 + n]
        to_stm = torch.argmin(nl_joint, dim=1) == 0
        to_expert = torch.exp(-nl_joint + nl_joint.min(dim=1, keepdim=True).values)
        to_expert = torch.cat([torch.zeros_like(to_expert[:, :1]), to_expert[:, 1:]], dim=1)
        to_expert = to_expert / (to_expert.sum(dim=1, keepdim=True) + 1e-7)
        nll_train = nll * (1.0 - to_stm.to(nll.dtype))[:, None]
        loss = torch.sum(torch.sum(nll_train * to_expert, dim=0))
        return loss, to_stm, to_expert.sum(dim=0), leaves

    def step(self, state, ctx, xb, yb, draws=None):
        """One wake step; then the sleep when the STM is full. `draws`:
        {"noise": 1 + active [B, S, z] tensors, "sleep": the sleep's draws
        (see `sleep`)}; None draws them from the run's generator. Returns
        the step's loss tensor."""
        ag, p = state.agent, self.params
        n = ag["active"]
        noise = draws["noise"] if draws else self._noise(state, xb.shape[0], 1 + n)
        # data-parallel (parallel/dp.py): the wake loss of this rank's rows (a
        # sum over rows, so the shares add up), its gradients, the slots'
        # usage and the routing summed or gathered over the ranks; the STM
        # takes the global batch's routed rows alike on every rank
        loss, to_stm, usage, leaves = self.wake_loss(
            state, *dp.local_rows(xb, yb), [dp.local_rows(z) for z in noise])
        to_stm = dp.gather_rows(to_stm.to(torch.uint8)).bool()
        usage = dp.rank_sum(usage)
        if n:
            parts = ("vae", "cls")
            grads = dp.rank_sum_all(torch.autograd.grad(
                loss, [v for part in parts for v in leaves[part].values()],
                materialize_grads=True))
            it = iter(grads)
            grads = {part: {k: next(it) for k in leaves[part]} for part in parts}
        loss = loss.detach()

        with torch.no_grad():
            # push routed samples into the STM (reference ndpm.py:58-62)
            routed = to_stm.to(torch.int64)
            pos = ag["stm_count"] + torch.cumsum(routed, 0) - 1
            slot = torch.where(to_stm, pos, ag["stm_x"].shape[0] - 1)
            ag["stm_x"].index_copy_(0, slot, xb)
            ag["stm_y"].index_copy_(0, slot, yb)

            # CRP usage recording (reference priors.py:40-52)
            u = torch.cat([usage, torch.zeros(self.K - n, device=usage.device)])
            ag["log_counts"] = torch.logaddexp(
                ag["log_counts"], torch.log(torch.clamp(u, min=1e-30)) +
                torch.where(u > 0, 0.0, -float("inf")))

            if n:
                # wake update of the used experts at each one's scheduled lr
                slot_mask = usage[1:] > 0
                wake_lr = multistep_lr(float(p.learning_rate), ag["sched_t"][:n])
                for part, key in (("vae", "g"), ("cls", "d")):
                    _masked_slot_update(p.optimizer, wake_lr, grads[part],
                                        _slice_opt(state.optimizer[key], 0, n), leaves[part],
                                        slot_mask)
                # every wake optimizer step also steps the scheduler
                ag["sched_t"][:n] += slot_mask.to(torch.int64)

        # the step's one device read: whether the STM is full
        ag["stm_count"] += int(routed.sum())
        if ag["stm_count"] >= self.stm_capacity:
            self.sleep(state, draws.get("sleep") if draws else None)
        return loss

    def _sleep_draws(self, state, n):
        p = self.params
        steps_g = int(getattr(p, "sleep_step_g", V.SLEEP_STEP_G))
        steps_d = int(getattr(p, "sleep_step_d", V.SLEEP_STEP_D))
        idx = torch.randint(0, n, (steps_g + steps_d, V.SLEEP_BATCH_SIZE),
                            generator=state.generator, device=self.device)
        return {"g_idx": idx[:steps_g], "d_idx": idx[steps_g:], "g_noise": None}

    def sleep(self, state, draws=None):
        """Train the next free slot k on the STM (reference ndpm.py:97-187),
        or, with every slot born, clear the STM and count a saturated sleep.
        `draws`: {"g_idx" [steps_g, 50], "d_idx" [steps_d, 50]: STM rows,
        "g_noise": steps_g draws of [50, S, z] or None to draw each VAE
        step's from the run's generator}."""
        ag, p, model = state.agent, self.params, state.model
        k, n = ag["active"], ag["stm_count"]
        ag["stm_count"] = 0
        if k >= self.K:
            ag["saturated_sleeps"] += 1
            return
        draws = draws or self._sleep_draws(state, n)
        # the newborn's prior: logaddexp(0, log n) (add_expert +
        # record_usage(len(dream)), reference :108-125)
        lc = ag["log_counts"].clone()
        lc[1 + k] = torch.logaddexp(torch.zeros(()), torch.log(torch.tensor(float(n))))
        # the newborn's scheduler has not stepped: base lr until the two
        # scheduler steps at the sleep's end
        lr = multistep_lr(float(p.learning_rate), ag["sched_t"][k: k + 1])
        one = torch.ones(1, dtype=torch.bool, device=self.device)
        chill = p.classifier_chill

        # the precursors' weights stay as they are for the whole sleep
        lower = {part: slot_dicts(leaf_views(model.part(part), 0, k)) for part in ("vae", "cls")}

        def g_loss(own, xb, i):
            x = _nchw(xb)
            slots = lower["vae"] + slot_dicts(own)
            z_mus, z_lvs = vae_encode_all(slots, x)
            noise = draws["g_noise"][i] if draws["g_noise"] is not None else \
                self._noise(state, xb.shape[0], 1)[0]
            nll = _vae_nll_from_z(slots[k], z_mus[k], z_lvs[k], x, noise)
            return nll.mean()

        def d_loss(own, xb, yb):
            slots = lower["cls"] + slot_dicts(own)
            preds = cls_forward(None, slots, _nchw(xb))[:, k: k + 1]
            return chilled_nll(preds, yb, chill)[:, 0].mean()

        for part, key, loss_fn, idx in (("vae", "g", g_loss, draws["g_idx"]),
                                        ("cls", "d", d_loss, draws["d_idx"])):
            opt = _slice_opt(state.optimizer[key], k, k + 1)
            # slot k's weights: autograd leaves that share their storage,
            # updated in place
            own = leaf_views(model.part(part), k, k + 1, grad=True)
            for i in range(idx.shape[0]):
                xb, yb = ag["stm_x"][idx[i]], ag["stm_y"][idx[i]]
                arg = i if part == "vae" else yb
                grads = torch.autograd.grad(loss_fn(own, xb, arg), list(own.values()),
                                            materialize_grads=True)
                # the loss's weight decay, WEIGHT_DECAY * sum of slot k's
                # squared weights (padded entries included), enters as its
                # gradient: one multi-tensor add
                torch._foreach_add_(grads, list(own.values()), alpha=2 * V.WEIGHT_DECAY)
                _masked_slot_update(p.optimizer, lr, dict(zip(own, grads)), opt, own, one)
        ag["log_counts"] = lc
        ag["active"] = k + 1
        # expert.lr_scheduler_step() twice at the sleep's end (reference
        # ndpm.py:184-185): the newborn crosses milestone 1
        ag["sched_t"][k] += 2

    def train_task(self, state, ctx, x_train, y_train):
        xs, ys = self.batchify(state, x_train, y_train)
        losses = [self.step(state, ctx, xs[i], ys[i]) for i in range(xs.shape[0])]
        if losses and getattr(self.params, "debug_nans", False):
            loss = torch.stack(losses).cpu().numpy()
            if not np.all(np.isfinite(loss)):
                raise FloatingPointError(
                    "non-finite CN-DPM loss at step {} of task {} (--debug_nans)".format(
                        int(np.nonzero(~np.isfinite(loss))[0][0]), self.task_seen))
        ag = state.agent
        n_sat = ag["saturated_sleeps"]
        if n_sat > 0:
            warnings.warn(
                "CN-DPM: {} sleep(s) hit the --max_experts={} cap and discarded their STM "
                "contents; results will diverge from the unbounded reference — raise "
                "--max_experts.".format(n_sat, self.K), RuntimeWarning, stacklevel=2)
        if self.verbose:
            print("[CNDPM] experts: {} stm: {} saturated_sleeps: {}".format(
                ag["active"], ag["stm_count"], n_sat))
        return state

    # ------------------------------------------------------------- evaluate

    def eval_noise(self, state):
        """One [test_batch, S, z] draw a born slot, from a generator seeded
        afresh from the run's seed, reused for every test batch (ocl_tpu
        reuses one key; evaluation never moves the training draws)."""
        g = torch.Generator(device=self.device).manual_seed(
            state.agent["eval_seed"] + EVAL_NOISE_SEED)
        return [torch.randn(self.params.test_batch, V.VAE_Z_SAMPLES, V.VAE_Z_DIM, generator=g,
                            device=self.device) for _ in range(state.agent["active"])]

    @torch.no_grad()
    def evaluate(self, state, test_loaders, noise=None):
        n = state.agent["active"]
        if n == 0:
            # no expert to run on the input (reference ndpm.py:27-28):
            # chance-level zeros instead of raising
            return np.zeros(len(test_loaders))
        noise = self.eval_noise(state) if noise is None else noise
        if self.eval_mesh is not None:   # this rank's rows of each test batch
            noise = [z[self.eval_mesh.rows(z.shape[0], "test batch rows")] for z in noise]
        lc = state.agent["log_counts"]
        return self._accuracies(
            test_loaders, lambda xb: ndpm_predict(state.model, xb, noise, lc, n).argmax(1))
