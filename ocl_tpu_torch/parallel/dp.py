"""Data-parallel train step and evaluation fan-out (counterpart of
ocl_tpu/parallel/dp.py).

ocl_tpu's sharded programs are XLA SPMD programs: they compute what the
unsharded program computes, up to the order of reductions. Here each rank
runs the agent's own step code on its rows, under a data-parallel context
(`data_parallel`) that the step's few batch-level reductions read:

* `models/layers.py::BatchNorm` sums its weighted row count, its Σw·x and its
  Σw·(x − mean)² over the ranks (`batch_sum`, differentiable): the
  statistics of the global batch, in the two-pass form;
* the agent's losses become the rank's share of the global mean (`share`):
  its rows' sum over the global count, so the shares add up to the loss;
* `reduce_grads` sums the gradients over the ranks before the optimizer
  step, which every rank then takes alike, so parameters stay replicated
  bit for bit. `batch_sum`'s backward sums the gradient of the statistics
  over the ranks as well: rank r's backward then carries every rank's loss
  through its own rows, and the sum over ranks counts each term once;
* a gradient read before the step is the global one: MIR's virtual step
  takes the batch gradients summed over the ranks (`rank_sum_all`, the
  .grad left as they are for the one reduction), AGEM reduces g and g_ref
  before their dot products, EWC++ squares the reduced gradient;
* feature sweeps of the retrieval and update strategies (ASER's) run on the
  rank's rows and are gathered (`row_map`), so every rank holds the same
  features and makes the same picks; MIR's two scoring forwards run on the
  rank's rows of the subsample, their BN statistics over all of it
  (`split_rows`); SCR's projected features are gathered before its SupCon
  loss, whose positives span the global batch (`gather_rows`, whose
  backward hands each rank its rows' summed gradient).

The draws of a step (reservoir uniforms, Gumbel noise, augmentation) are the
same on every rank: each rank's generator starts from the run's seed and
draws the same amounts.

Outside the context every hook is the identity, so the single-process and
stacked paths are unchanged.
"""

from __future__ import annotations

import contextlib

import torch

from ocl_tpu_torch.parallel.mesh import Mesh, shard_batch

_ACTIVE: Mesh | None = None   # the mesh a data-parallel step runs under


def active() -> Mesh | None:
    return _ACTIVE


@contextlib.contextmanager
def data_parallel(mesh: Mesh):
    """Within the block, the agents' step code runs data-parallel on `mesh`."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, mesh
    try:
        yield mesh
    finally:
        _ACTIVE = prev


class _BatchSum(torch.autograd.Function):
    """Sum over the ranks; its backward sums the gradient over the ranks."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return mesh.all_reduce_(t.detach().clone())

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce_(g.detach().clone()), None


class _GatherRows(torch.autograd.Function):
    """Every rank's rows, in rank order; the backward gives each rank the sum
    over the ranks of the gradient of its own rows."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        ctx.rows = t.shape[0]
        return mesh.all_gather(t.detach())

    @staticmethod
    def backward(ctx, g):
        g = ctx.mesh.all_reduce_(g.detach().clone())
        return g[ctx.mesh.rank * ctx.rows:(ctx.mesh.rank + 1) * ctx.rows], None


def batch_sum(t):
    """Σ over the ranks of `t`, differentiable (identity outside the context)."""
    return t if _ACTIVE is None else _BatchSum.apply(t, _ACTIVE)


def rank_sum(t):
    """Σ over the ranks of `t`, no gradient (identity outside the context)."""
    if _ACTIVE is None:
        return t
    return _ACTIVE.all_reduce_(t.detach().clone())


def gather_rows(t):
    """The global batch's rows of `t` from every rank's, differentiable."""
    return t if _ACTIVE is None else _GatherRows.apply(t, _ACTIVE)


def local_rows(*ts):
    """This rank's rows of each tensor (None passes through); the tensors
    themselves outside the context."""
    if _ACTIVE is None:
        return ts if len(ts) > 1 else ts[0]
    out = tuple(None if t is None else _ACTIVE.local(t) for t in ts)
    return out if len(out) > 1 else out[0]


def share(loss, mask=None):
    """The rank's share of a mean over the global batch from `loss`, the mean
    over this rank's rows (where `mask`): times the rank's count over the
    global one. Outside the context, `loss`."""
    if _ACTIVE is None:
        return loss
    if mask is None:
        return loss / _ACTIVE.size
    n = mask.to(torch.float32).sum()
    return loss * n / torch.clamp(rank_sum(n), min=1.0)


def split_rows(fn, mask, *ts):
    """fn(mask, *ts) for a gradient-free fn over rows that meet only in
    BatchNorm's statistics over the rows where `mask`: each rank runs its
    share of the rows, padded with masked-off rows to a multiple of W, and
    the [n, ...] results are gathered, so every rank holds the same. The
    statistics count each row once: had every rank run all n, the count
    would be n W and the running variance's n / (n - 1) would drift. fn(mask,
    *ts) outside the context."""
    if _ACTIVE is None:
        return fn(mask, *ts)
    n = mask.shape[0]
    pad = (-n) % _ACTIVE.size
    if pad:
        mask = torch.cat([mask, mask.new_zeros(pad)])
        ts = [torch.cat([t, t[:1].expand(pad, *t.shape[1:])]) for t in ts]
    return _ACTIVE.all_gather(fn(_ACTIVE.local(mask), *(_ACTIVE.local(t) for t in ts)))[:n]


def row_map(fn, x):
    """fn(x) for a row-wise, gradient-free fn (split_rows' sharing of the
    rows); fn(x) outside the context."""
    if _ACTIVE is None:
        return fn(x)
    return split_rows(lambda _, r: fn(r), torch.ones(x.shape[0], dtype=torch.bool,
                                                     device=x.device), x)


def rank_sum_all(tensors):
    """rank_sum of each of `tensors`, in one collective (the tensors
    themselves outside the context)."""
    if _ACTIVE is None:
        return tensors
    flat = _ACTIVE.all_reduce_(torch.cat([t.detach().reshape(-1) for t in tensors]))
    return [g.view_as(t) for t, g in zip(tensors, flat.split([t.numel() for t in tensors]))]


def reduce_grads(model) -> None:
    """Sum every parameter's gradient over the ranks, in one collective
    (nothing outside the context)."""
    if _ACTIVE is None:
        return
    params = [p for p in model.parameters() if p.grad is not None]
    if not params:
        return
    flat = _ACTIVE.all_reduce_(torch.cat([p.grad.reshape(-1) for p in params]))
    for p, g in zip(params, flat.split([p.numel() for p in params])):
        p.grad.copy_(g.view_as(p.grad))


# ------------------------------------------------------------------ the step

# the two agents ocl_tpu's make_dp_train_task cannot take either: it jits
# `_build_train_task_fn()` with the in_shardings of (state, ctx, xs, ys)
DP_REFUSED = {
    "ICARL": "its task function takes (state, label_map, n_old, all_cls, xs, ys), which "
             "those in_shardings do not fit (a TypeError there)",
    "GDUMB": "it has no task function: it trains in its end-of-task retrain (a "
             "NotImplementedError there)",
}


def check_dp_supported(agent) -> None:
    """Raise NotImplementedError for an agent the data-parallel step does not
    run. It runs every other one, with any retrieval and update: ER, AGEM
    and SCR, EWC++, LwF, the tricks (review_trick's pass comes after the
    task, outside the step) and CN-DPM's wake step."""
    name = agent.params.agent
    if name in DP_REFUSED:
        raise NotImplementedError(
            "the data-parallel step does not run {}, as ocl_tpu's make_dp_train_task cannot "
            "take it: {}".format(name, DP_REFUSED[name]))


def make_dp_train_task(agent, mesh: Mesh):
    """agent's task loop with every step data-parallel over `mesh`.

    Returns train_task(state, ctx, xs, ys, draws=None), and for CN-DPM
    train_task(state, xs, ys, draws=None), as ocl_tpu/parallel/dp.py:38-42:
    xs [n_batches, B, ...] and ys [n_batches, B] are the same on every rank,
    which takes its B / W rows of each batch (and of the retrieved memory
    rows); the state's buffer may be slot-sharded (parallel/sharded_buffer.py)
    or replicated. `draws`, if given, is the list of each step's draws (as
    the agent's `step` takes them). Returns (state, {"loss": [n], "acc": [n]})
    with the global batch's loss and accuracy, on every rank."""
    check_dp_supported(agent)

    def train_task(state, ctx, xs, ys, draws=None):
        mesh.rows(xs.shape[1], "batch rows")
        out = []
        with data_parallel(mesh):
            for i in range(xs.shape[0]):
                res = agent.step(state, ctx, xs[i], ys[i],
                                 draws=None if draws is None else draws[i])
                loss, acc = res if isinstance(res, tuple) else (res, torch.zeros_like(res))
                out.append(torch.stack([loss.float(), acc.float()]))
        if not out:
            return state, {"loss": torch.zeros(0), "acc": torch.zeros(0)}
        m = mesh.all_reduce_(torch.stack(out))   # the shares add up to the loss
        return state, {"loss": m[:, 0], "acc": m[:, 1] / mesh.size}

    if agent.params.agent == "CNDPM":
        return lambda state, xs, ys, draws=None: train_task(state, None, xs, ys, draws)
    return train_task


# ------------------------------------------------------- evaluation fan-out

def make_dp_eval(agent, mesh: Mesh):
    """Evaluation with the test batches split over `mesh`: sets the agent's
    `eval_mesh` and returns eval_tasks(state, loaders) -> the accuracy of
    each test set (`agent.evaluate`'s, the same on every rank) for loaders
    of prepare_test_loaders' [nb, B, ...] tensors, whole on every rank."""
    agent.eval_mesh = mesh

    def eval_tasks(state, loaders):
        return agent.evaluate(state, shard_loaders(mesh, loaders))

    return eval_tasks


def shard_loaders(mesh: Mesh, loaders):
    """This rank's rows of every test batch of `loaders` (prepare_test_loaders'
    [nb, B, ...] tensors): each rank keeps only those on its device."""
    return [tuple(shard_batch(mesh, t, 1).clone() for t in loader) for loader in loaders]


def broadcast_state(mesh: Mesh, agent, state) -> None:
    """Rank 0's train state, as far as an evaluation reads it, on every rank,
    in place, once every rank has come to it (`Mesh.wait_all`): the model's
    parameters and BN buffers, the tensors of the agent state (CN-DPM's
    counts), for an NCM agent its buffer's images, labels and counters, and
    the agent's label bookkeeping (utils/checkpoint.py's agent meta, GDumb's
    host memory left out)."""
    import torch.distributed as dist

    from ocl_tpu_torch.utils import checkpoint

    buf = state.buffer if agent.ncm_classify else None
    ag = state.agent if isinstance(state.agent, dict) else {}
    mesh.wait_all()   # the other ranks wait here, with no limit, while rank 0 trains
    host = None
    if mesh.rank == 0:
        meta = checkpoint.snapshot_agent_meta(agent)
        meta.pop("mem_img", None)
        host = {"meta": meta,
                "agent": {k: v for k, v in ag.items() if isinstance(v, (bool, int, float, str))},
                "buffer": None if buf is None else (buf.current_index, buf.n_seen_so_far)}
    box = [host]
    dist.broadcast_object_list(box, 0, group=mesh.group,
                               device=mesh.device if mesh.backend == "nccl" else None)
    host = box[0]
    if mesh.rank:
        checkpoint.restore_agent_meta(agent, host["meta"])
        ag.update(host["agent"])
        if buf is not None:
            buf.current_index, buf.n_seen_so_far = host["buffer"]
    tensors = list(state.model.parameters()) + list(state.model.buffers())
    tensors += [t for t in torch.utils._pytree.tree_leaves(
        {k: v for k, v in ag.items() if not isinstance(v, torch.nn.Module)})
        if isinstance(t, torch.Tensor)]
    if buf is not None:
        tensors += [buf.slot_imgs, buf.slot_labels, buf.class_counts]
    with torch.no_grad():
        mesh.broadcast_tensors_(tensors)
