"""Stacked grid tuning: every (grid point, val run) pair trains at once
(counterpart of ocl_tpu/experiment/parallel_tune.py).

The sequential tuner (experiment/tune.py) trains G x R runs one after the
other, each a launch sequence of one model. Where the grid varies only
optimizer scalars (learning_rate, weight_decay), every point runs the same
step: the G x R states are stacked (experiment/parallel_run.py::_stack),
each point carries its own lr and wd in the stacked optimizer
(optim.StackedOptimizer), and one launch sequence serves all points
(agents/base.py::point_map). The grid points of val run r share that run's
init (seed + 1000 + r) and draws, as in the sequential loop, and every point
consumes the same shuffled tune batches, from a generator of their own, so
the grid points are compared paired. The gate below is a memory bound: all
points' states live on the card at once.

Agents: ER and AGEM (every strategy; MIR only without an lr grid), LwF and
EWC++ step stacked; iCaRL shares its compact-label bookkeeping and evaluates through
the stacked NCM (`ncm_means_stacked`, with --abl_ncm_zero_empty, which
ocl_tpu's `_make_stacked_ncm` lacks); GDumb builds each val run's balanced
memory on the host from that run's draws and retrains every point stacked.

With --n_devices W > 1 the points are padded to a multiple of W (repeating
the last, as ocl_tpu pads its point axis to the device count) and dealt
round-robin to W ranks (parallel/mesh.py::launch), each rank stacks its
share, and every rank gets the accuracies back in point order and picks the
same winner. ocl_tpu shards its points over every device it sees; the
port's ranks exist only under --n_devices, so here the flag is the trigger.
"""

from __future__ import annotations

import os
from types import SimpleNamespace

import numpy as np
import torch

from ocl_tpu_torch.agents.base import stack_ctx
from ocl_tpu_torch.config import input_size_match
from ocl_tpu_torch.experiment.metrics import compute_performance
from ocl_tpu_torch import parallel
from ocl_tpu_torch.experiment.parallel_run import _stack, dealt, gather_dealt
from ocl_tpu_torch.registry import agents

INJECTABLE = {"learning_rate", "weight_decay"}
# agents whose per-task transitions are safe on a stacked state: ER and AGEM
# have no end-of-task device work, LwF's and iCaRL's teacher snapshots are
# leaf-wise, EWC++ normalises its Fisher per point (after_train_stacked),
# iCaRL's NCM eval has a stacked path, and GDumb retrains every point
# stacked on its val run's memory
GRID_CAPABLE = ("ER", "AGEM", "LWF", "EWC", "ICARL", "GDUMB")

# on-card budget for the stacked states (buffers dominate): about a tenth of
# an H100's 80 GB, so activations and the allocator's slack fit beside them
STACK_BYTES_BUDGET = int(os.environ.get("OCL_TPU_TORCH_TUNE_STACK_BYTES", 8 << 30))

# the shuffle generator of the shared tune batches: its own seed, so it
# aliases no point's generator
SHUFFLE_SEED_OFFSET = 999_983


def _stack_bytes_estimate(params, total_points: int) -> int:
    """Rough on-card footprint of `total_points` stacked states: each
    point's episodic buffer (fp32 images) plus 64 MiB for its weights,
    optimizer state, BN statistics and teacher (a Reduced ResNet-18 at nf 20
    has about 1.1M parameters, 4.4 MB a copy)."""
    shape = input_size_match.get(getattr(params, "data", "cifar10"), [32, 32, 3])
    per_img = int(np.prod(shape)) * 4
    mem = int(getattr(params, "mem_size", 0) or 0)
    return total_points * (mem * per_img + (64 << 20))


def supports_parallel_grid(default_params, tune_params) -> bool:
    varying = {k for k, v in tune_params.items()
               if isinstance(v, (list, tuple)) and len(v) > 1}
    if not varying or not varying <= INJECTABLE:
        return False
    # the *effective* per-point params: length-1 grid lists override the
    # defaults without varying (e.g. retrieve: [MIR], mem_size: [10000])
    eff = dict(vars(default_params))
    eff.update({k: (v[0] if isinstance(v, (list, tuple)) else v)
                for k, v in tune_params.items() if k not in varying})
    if eff.get("agent") not in GRID_CAPABLE:
        return False
    # MIR's virtual step takes the configured lr (buffer/mir.py), one value
    # for every point: a grid over lr cannot reach it
    if eff.get("retrieve") == "MIR" and "learning_rate" in varying:
        return False
    trick = dict(default_params.trick)
    for k in ("ncm_trick", "review_trick"):
        if isinstance(eff.get(k), bool):
            trick[k] = eff[k]
    # NCM eval reads the episodic buffer, which GDumb does not keep
    if trick.get("ncm_trick") and eff.get("agent") == "GDUMB":
        return False
    if trick.get("review_trick") or bool(eff.get("error_analysis", False)):
        return False
    g_points = 1
    for v in tune_params.values():
        if isinstance(v, (list, tuple)):
            g_points *= max(1, len(v))
    total = g_points * max(1, int(getattr(default_params, "num_runs_val", 1)))
    est = _stack_bytes_estimate(SimpleNamespace(**eff), total)
    if est > STACK_BYTES_BUDGET:
        print("parallel grid skipped: {} stacked points need ~{:.1f} GiB on the card "
              "(> {:.1f} GiB budget, OCL_TPU_TORCH_TUNE_STACK_BYTES) — sequential "
              "tuning".format(total, est / (1 << 30), STACK_BYTES_BUDGET / (1 << 30)))
        return False
    return True


def shuffle_generator(seed: int, device):
    """The generator of the shared tune batches (seeded as init_state seeds
    a run's draws)."""
    draws_seed = int(np.random.SeedSequence(seed + SHUFFLE_SEED_OFFSET).generate_state(2)[1])
    return torch.Generator(device=device).manual_seed(draws_seed)


def _tune_on_ranks(tune_data, tune_test_loaders, default_params, tune_params, grid, merged):
    """tune_hyper_parallel in one rank: the test sets onto its device."""
    mesh = parallel.get_mesh()
    default_params.device = str(mesh.device)
    loaders = [tuple(t.to(mesh.device) for t in loader) for loader in tune_test_loaders]
    return tune_hyper_parallel(tune_data, loaders, default_params, tune_params, grid, merged)


def tune_hyper_parallel(tune_data, tune_test_loaders, default_params, tune_params, grid,
                        merged):
    """Returns the winning grid dict (the contract of tune_hyper)."""
    from ocl_tpu_torch.experiment.run import n_devices

    mesh = None
    if n_devices(default_params) > 1:
        mesh = parallel.current()
        if mesh is None:   # start the ranks; each runs this function
            loaders = [tuple(t.cpu() for t in loader) for loader in tune_test_loaders]
            return parallel.launch(_tune_on_ranks, (tune_data, loaders, default_params,
                                                    tune_params, grid, merged),
                                   n_devices(default_params), default_params.device)[0]
    R = int(default_params.num_runs_val)
    G = len(grid)
    points = [(g, r) for g in range(G) for r in range(R)]
    n_real = len(points)
    while mesh is not None and len(points) % mesh.size:
        points.append(points[-1])
    print("{} grid points x {} val runs = {} stacked tuning states{}".format(
        G, R, n_real, "" if mesh is None else " ({} padding), dealt to {} ranks".format(
            len(points) - n_real, mesh.size)))
    n_points = len(points)
    points = [points[i] for i in dealt(n_points, mesh)]
    params_g = [merged(default_params, grid[g]) for g in range(G)]
    # agent 0 serves every point: only lr and wd differ between points, and
    # they live in the stacked optimizer; it carries the host bookkeeping
    agent0 = agents[params_g[0].agent](params_g[0])
    seed = int(default_params.seed)
    states_r = [agent0.init_state(seed + 1000 + r) for r in range(R)]
    ss = _stack([states_r[r] for _, r in points],
                lr=[float(params_g[g].learning_rate) for g, _ in points],
                wd=[float(params_g[g].weight_decay) for g, _ in points])
    del states_r
    P = ss.points
    print("tuning points stacked on one device (one launch sequence for all points)")
    shuffle = SimpleNamespace(generator=shuffle_generator(seed, agent0.device))

    acc = np.zeros((P, len(tune_data), len(tune_test_loaders)))
    for t, (x_train, y_train, _labels) in enumerate(tune_data):
        # agent 0 keeps the label bookkeeping for all points (identical
        # streams, identical label sets), as the sequential loop's agents do
        ctx = agent0.before_train(y_train)
        sctx = stack_ctx(ctx, P)
        ss = agent0.before_task_stacked(ss)
        if agent0.stacked_consumes_raw:
            ss = agent0.stacked_train_task(ss, sctx, x_train, y_train)
        else:
            xs, ys = agent0.batchify(shuffle, x_train, y_train)
            ss = agent0.stacked_train_task(ss, sctx, xs.expand(P, *xs.shape),
                                           ys.expand(P, *ys.shape))
        ss = agent0.after_train_stacked(ss, ctx)
        acc[:, t] = agent0.evaluate_stacked(ss, tune_test_loaders)

    acc = gather_dealt(mesh, acc, n_points)[:n_real]
    acc = acc.reshape(G, R, len(tune_data), len(tune_test_loaders))
    tune_accs = []
    for g in range(G):
        (end_acc, _ci), *_ = compute_performance(acc[g])
        tune_accs.append(end_acc)
        print("{} -> avg_end_acc {:.4f}".format(grid[g], end_acc))
    return grid[int(np.argmax(tune_accs))]
