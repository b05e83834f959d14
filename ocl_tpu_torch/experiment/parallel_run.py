"""Stacked runs: R independent runs of one experiment trained as one stacked
program (counterpart of ocl_tpu/experiment/parallel_run.py).

ocl_tpu vmaps the scanned task function over a [R, ...]-stacked TrainState.
Here the R runs' models are stacked tensors (models.Stacked) and every step
runs the agent's per-point code under `torch.func.vmap`
(agents/base.py::point_map): one launch sequence serves all R runs, convs
batched as grouped convolutions. Run r keeps its own task stream, test sets,
generators and label bookkeeping, and draws exactly what sequential run r
draws from `init_state(seed + r)`, so seed-paired runs reproduce
`multiple_run` up to the rounding of grouped convolutions.

Works for agents whose step is a per-point function and whose eval is the
softmax path (ER with every strategy, AGEM, EWC++, LwF); the rest, listed
by `unstackable`, go to the sequential `multiple_run` with the reason
printed.

With --n_devices W > 1 the runs are dealt round-robin to W ranks
(parallel/mesh.py::launch; run r to rank r mod W), each rank stacks its
share, and the accuracy matrices come back to every rank in run order.
ocl_tpu shards its run axis one run a device by itself whenever it sees at
least R devices; the port's ranks exist only under --n_devices, so here the
flag is the trigger.
"""

from __future__ import annotations

import os
import pickle
import time
from types import SimpleNamespace

import numpy as np
import torch

from ocl_tpu_torch.agents.base import StackedState, TaskCtx
from ocl_tpu_torch.buffer.state import stack_buffers
from ocl_tpu_torch.data import continuum, prepare_test_loaders
from ocl_tpu_torch.experiment.metrics import compute_performance
from ocl_tpu_torch.models import Stacked, stack_models
from ocl_tpu_torch.optim import StackedOptimizer, setup_opt
from ocl_tpu_torch.registry import agents
from ocl_tpu_torch.utils.io import load_yaml
from ocl_tpu_torch.utils.profiling import Throughput

VMAP_CAPABLE = ("ER", "AGEM", "EWC", "LWF")



def unstackable(params) -> str | None:
    """Why `params`' runs cannot train stacked, or None if they can."""
    ncm = params.trick.get("ncm_trick") or params.agent in ("ICARL", "SCR", "SCP")
    if params.agent not in VMAP_CAPABLE:
        return "agent {} has no stacked runner".format(params.agent)
    if params.trick.get("review_trick"):
        return "review_trick's end-of-task pass is not stacked"
    if ncm:
        return "NCM eval is not stacked in the runner"
    if getattr(params, "error_analysis", False):
        return "--error_analysis evaluates one run at a time"
    if not getattr(params, "online", True):
        return "offline mode trains one run at a time"
    if getattr(params, "ckpt_dir", None):
        return "--ckpt_dir checkpoints one run at a time"
    return None


def _optimizer_hyper(opt):
    group = opt.param_groups[0]
    return float(group["lr"]), float(group["weight_decay"])


def _stack_agent(agent_states):
    """Stacks per-point agent state: modules (teachers) as Stacked, tensors
    and dicts of tensors along a new point axis; other values are shared and
    must agree."""
    if agent_states[0] is None:
        return None
    out = {}
    for k, v in agent_states[0].items():
        vs = [a[k] for a in agent_states]
        if isinstance(v, torch.nn.Module):
            out[k] = stack_models(vs)
        elif isinstance(v, torch.Tensor):
            out[k] = torch.stack(vs)
        elif isinstance(v, dict):
            out[k] = {n: torch.stack([x[n] for x in vs]) for n in v}
        else:
            if any(x != v for x in vs):
                raise ValueError("agent state {!r} differs between points".format(k))
            out[k] = v
    return out


def _stack(states, lr=None, wd=None) -> StackedState:
    """A StackedState of the TrainStates `states` (copies of their tensors).
    States that share a generator share a lane: their draws are made once.
    `lr` and `wd` ([P] sequences) replace the optimizers' own."""
    model = stack_models([s.model for s in states])
    gens, hosts, lane = [], [], []
    for s in states:
        for i, g in enumerate(gens):
            if g is s.generator:
                lane.append(i)
                break
        else:
            gens.append(s.generator)
            hosts.append(s.host)
            lane.append(len(gens) - 1)
    hyper = [_optimizer_hyper(s.optimizer) for s in states]
    dev = next(iter(model.params.values())).device
    lr = torch.tensor([h[0] for h in hyper] if lr is None else list(lr), device=dev)
    wd = torch.tensor([h[1] for h in hyper] if wd is None else list(wd), device=dev)
    name = "Adam" if isinstance(states[0].optimizer, torch.optim.Adam) else "SGD"
    opt_state = None
    if name == "Adam":
        opt_state = _stack_adam_state([s.model for s in states], [s.optimizer for s in states])
    opt = StackedOptimizer(name, model.params.values(), lr, wd, opt_state)
    buffer = None if states[0].buffer is None else stack_buffers([s.buffer for s in states])
    return StackedState(model=model, optimizer=opt, buffer=buffer, generators=gens,
                        hosts=hosts, lane=lane, agent=_stack_agent([s.agent for s in states]))


def _stack_adam_state(models, opts):
    steps = set()
    exp_avg, exp_avg_sq = [], []
    for params in zip(*(m.parameters() for m in models)):
        st = [o.state.get(p, {}) for o, p in zip(opts, params)]
        steps |= {int(s["step"]) if s else 0 for s in st}
        exp_avg.append(torch.stack([s["exp_avg"] if s else torch.zeros_like(p)
                                    for s, p in zip(st, params)]))
        exp_avg_sq.append(torch.stack([s["exp_avg_sq"] if s else torch.zeros_like(p)
                                       for s, p in zip(st, params)]))
    if len(steps) != 1:
        raise ValueError("stacked Adam states must agree on their step, got {}".format(steps))
    return {"step": steps.pop(), "exp_avg": exp_avg, "exp_avg_sq": exp_avg_sq}


def point_state(ss: StackedState, p: int, params):
    """Point p of `ss` as a plain TrainState (copies; the generator and host
    are its lane's own objects)."""
    from ocl_tpu_torch.agents.base import TrainState

    model = ss.model.point(p)
    opt = setup_opt(params.optimizer, model.parameters(), float(ss.optimizer.lr[p]),
                    float(ss.optimizer.wd[p]))
    st = ss.optimizer.state()
    if st and st["step"] > 0:
        for q, m, v in zip(model.parameters(), st["exp_avg"], st["exp_avg_sq"]):
            opt.state[q] = {"step": torch.tensor(float(st["step"])),
                            "exp_avg": m[p].clone(), "exp_avg_sq": v[p].clone()}
    agent = None
    if ss.agent is not None:
        agent = {}
        for k, v in ss.agent.items():
            if isinstance(v, Stacked):
                agent[k] = v.point(p)
                agent[k].requires_grad_(False)
            elif isinstance(v, torch.Tensor):
                agent[k] = v[p].clone()
            elif isinstance(v, dict):
                agent[k] = {n: t[p].clone() for n, t in v.items()}
            else:
                agent[k] = v
    return TrainState(model=model, optimizer=opt,
                      buffer=None if ss.buffer is None else ss.buffer.point(p),
                      generator=ss.generators[ss.lane[p]], agent=agent,
                      host=ss.hosts[ss.lane[p]])


def _stack_loaders(per_run):
    """[P, nb, ...] test tensors from each run's loaders for one task."""
    return tuple(torch.stack(ts) for ts in zip(*per_run))


def dealt(n: int, mesh) -> list:
    """The points of n that `mesh`'s rank trains (round-robin), or all of
    them in a single process."""
    return list(range(n)) if mesh is None else list(range(mesh.rank, n, mesh.size))


def gather_dealt(mesh, local: np.ndarray, n: int) -> np.ndarray:
    """[n, ...] from every rank's rows of its `dealt` points, in point order,
    on every rank."""
    if mesh is None:
        return local
    mesh.wait_all()   # a rank with fewer or faster points waits here, with no limit
    per = -(-n // mesh.size)
    pad = np.zeros((per,) + local.shape[1:], np.float64)
    pad[: len(local)] = local
    every = mesh.all_gather(torch.tensor(pad, device=mesh.device)).cpu().numpy()
    return np.stack([every[(p % mesh.size) * per + p // mesh.size] for p in range(n)])


def multiple_run_parallel(params, store=False, save_path=None):
    """`params.num_runs` runs trained stacked; prints multiple_run's metric
    lines and an aggregate throughput; returns compute_performance's tuple."""
    from ocl_tpu_torch.config import apply_runtime_flags
    from ocl_tpu_torch.experiment.run import (check_supported, fan_out_mesh, multiple_run,
                                              start_ranks)

    # ocl_tpu runs sequentially on a single device when num_runs > 1: its
    # stacked convolutions were slower there. On one card the port stacks
    # for any num_runs: 3 fused-ER runs stacked took 595.2 images/s against
    # 415.6 run one after another (chip_smoke.py phase 21 (a), H100 80GB
    # HBM3, 700.00 W; PERF.md §6, PR 7).
    reason = unstackable(params)
    if reason is not None:
        print("[parallel_runs] {}: sequential multiple_run".format(reason))
        return multiple_run(params, store=store, save_path=save_path)
    check_supported(params)
    ranks = start_ranks(multiple_run_parallel, params, store, save_path)
    if ranks is not None:
        return ranks[0]
    mesh = fan_out_mesh(params)
    if mesh is not None and params.num_runs < mesh.size:
        raise ValueError("{} runs cannot be dealt to {} ranks: give each rank a run".format(
            params.num_runs, mesh.size))
    apply_runtime_flags(params)
    device = torch.device(params.device)

    start = time.time()
    n_runs = params.num_runs
    mine = dealt(n_runs, mesh)
    print("Setting up data stream ({} stacked runs{})".format(
        n_runs, "" if mesh is None else ", dealt to {} ranks".format(mesh.size)))
    data_continuum = continuum(params.data, params.cl_type, params)
    np.random.seed(params.seed)
    runs_tasks, runs_tests = [], []
    for r in range(n_runs):
        data_continuum.new_run()
        tasks = list(data_continuum)
        if r in mine:
            runs_tasks.append(tasks)
            runs_tests.append(prepare_test_loaders(data_continuum.test_data(), params, device))
    n_tasks, n_tests = len(runs_tasks[0]), len(runs_tests[0])
    tests = [_stack_loaders([rt[t] for rt in runs_tests]) for t in range(n_tests)]

    agent = agents[params.agent](params)
    ss = _stack([agent.init_state(params.seed + r) for r in mine])

    old_labels = [set() for _ in mine]
    acc = np.zeros((len(mine), n_tasks, n_tests))
    tput = Throughput()
    for t in range(n_tasks):
        old_mask = torch.zeros(len(mine), agent.n_classes, dtype=torch.bool)
        new_mask = torch.zeros(len(mine), agent.n_classes, dtype=torch.bool)
        xs, ys = [], []
        for r in range(len(mine)):
            x, y, _labels = runs_tasks[r][t]
            new = sorted(set(int(v) for v in np.asarray(y).reshape(-1)))
            old_mask[r, sorted(old_labels[r])] = True
            new_mask[r, new] = True
            old_labels[r].update(new)
            # run r's shuffle, from its own generator, as agent.batchify
            # draws it in the sequential run
            xr, yr = agent.batchify(SimpleNamespace(generator=ss.generators[r]), x, y)
            xs.append(xr)
            ys.append(yr)
        ctx = TaskCtx(old_mask=old_mask.to(device), new_mask=new_mask.to(device), task_seen=t)
        xs, ys = torch.stack(xs), torch.stack(ys)
        with tput.measure(int(np.prod(ys.shape)), device):
            ss = agent.before_task_stacked(ss)
            ss = agent.stacked_train_task(ss, ctx, xs, ys)
            ss = agent.after_train_stacked(ss, ctx)
        # the test sets of the tasks seen so far: one a task, but CORe50's
        # ni protocol has a single test set for all its tasks
        seen = tests[: t + 1]
        acc[:, t, : len(seen)] = agent.evaluate_stacked(ss, seen)
        if params.verbose:
            print("task {}: acc {}".format(t, acc[:, t, : len(seen)].mean(axis=0)))

    acc = gather_dealt(mesh, acc, n_runs)
    images_per_s = tput.images_per_sec()
    if mesh is not None:   # every rank's images over the slowest rank's seconds
        it = mesh.all_gather(torch.tensor([[tput.images, tput.seconds]], dtype=torch.float64,
                                          device=mesh.device)).cpu().numpy()
        images_per_s = it[:, 0].sum() / it[:, 1].max() if it[:, 1].max() else 0.0
    end = time.time()
    if store and (mesh is None or mesh.rank == 0):
        result_path = load_yaml("config/global.yml", key="path")["result"]
        table_path = result_path + params.data
        os.makedirs(table_path, exist_ok=True)
        if not save_path:
            save_path = getattr(params, "model_name", params.agent) + "_" + \
                getattr(params, "data_name", params.data) + ".pkl"
        with open(table_path + "/" + save_path, "wb") as f:
            pickle.dump({"time": end - start, "acc_array": acc}, f)
    avg_end_acc, avg_end_fgt, avg_acc, avg_bwtp, avg_fwt = compute_performance(acc)
    print("----------- Total {} run: {}s -----------".format(n_runs, end - start))
    print("----------- aggregate stream throughput {:.1f} images/sec -----------".format(
        images_per_s))
    print("----------- Avg_End_Acc {} Avg_End_Fgt {} Avg_Acc {} Avg_Bwtp {} Avg_Fwt {}-----------"
          .format(avg_end_acc, avg_end_fgt, avg_acc, avg_bwtp, avg_fwt))
    return avg_end_acc, avg_end_fgt, avg_acc, avg_bwtp, avg_fwt
