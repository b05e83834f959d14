"""Rank functions of tests/test_torch_parallel_*.py (imported by name in the
spawned ranks, so they live in a module of their own; torch and the port
only).

A step spec is a dict the test builds from ocl_tpu's state:
  params       default_params keywords (the device is the rank's);
  state_dict   the model's weights (the port's names);
  buffer       None, or {"imgs", "labels", "score"} numpy arrays and
               "current_index", "n_seen";
  cndpm        None, or CN-DPM's (agent dict, optimizer dict);
  task_seen, old_labels, ctx_y   the agent's label bookkeeping;
  agent        None, or ocl_tpu's agent pytree (numpy leaves: a teacher,
               EWC's trees), through interop.agent_from_jax;
  xs, ys       numpy batches [n, B, ...], [n, B];
  draws        each step's draws, as the agent's `step` takes them;
  perturb      added to every parameter first (a control run);
  xla_order    run the SV sums in XLA:CPU's order (test_torch_aser.py);
  z_samples, flush_denormal   CN-DPM's z samples, and subnormals flushed as
               XLA's CPU backend flushes them (test_torch_cndpm.py).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch


@contextlib.contextmanager
def arithmetic(spec):
    """Within the block, the spec's arithmetic: with `xla_order`,
    test_torch_aser.py::xla_summation_order; with `flush_denormal`,
    subnormals flushed to zero. Both undone after."""
    from ocl_tpu_torch.buffer import aser as port_aser
    from ocl_tpu_torch.ops import knn_sv as port_knn_sv

    saved = port_knn_sv.reverse_cumsum, port_knn_sv.sum_rows, port_aser.sum_rows
    if spec.get("xla_order"):
        import test_torch_aser as ta

        def reverse_cumsum(v):
            return torch.flip(ta._xla_cumsum(torch.flip(v, dims=[1])), dims=[1])

        def sum_rows(sv):
            return ta._seq_scan(sv, 0)[-1]

        port_knn_sv.reverse_cumsum = reverse_cumsum
        port_knn_sv.sum_rows = port_aser.sum_rows = sum_rows
    if spec.get("flush_denormal"):
        torch.set_flush_denormal(True)
    try:
        yield
    finally:
        port_knn_sv.reverse_cumsum, port_knn_sv.sum_rows, port_aser.sum_rows = saved
        torch.set_flush_denormal(False)


def build(spec, device="cpu"):
    """(agent, TrainState, ctx) of a spec, whole (not sharded)."""
    from ocl_tpu_torch.config import default_params
    from ocl_tpu_torch.models import ndpm_vars
    from ocl_tpu_torch.registry import agents

    if "z_samples" in spec:
        ndpm_vars.VAE_Z_SAMPLES = spec["z_samples"]
    p = default_params(**spec["params"], device=str(device))
    for k, v in spec.get("attrs", {}).items():
        setattr(p, k, v)
    agent = agents[p.agent](p)
    for k, v in spec.get("agent_attrs", {}).items():
        setattr(agent, k, v)
    state = agent.init_state(0)
    state.model.load_state_dict(spec["state_dict"])
    if spec.get("cndpm") is not None:
        eval_seed = state.agent["eval_seed"]
        state.agent, state.optimizer = spec["cndpm"]
        state.agent["eval_seed"] = eval_seed
    if spec.get("agent") is not None:
        from ocl_tpu_torch import interop

        state.agent = interop.agent_from_jax(spec["agent"], state.model)
    if spec.get("buffer") is not None:
        b, buf = spec["buffer"], state.buffer
        buf.imgs.copy_(torch.from_numpy(b["imgs"]))
        buf.labels.copy_(torch.from_numpy(np.asarray(b["labels"], np.int64)))
        buf.score.copy_(torch.from_numpy(b["score"]))
        buf.class_counts.copy_(torch.from_numpy(np.bincount(
            b["labels"][: b["current_index"]], minlength=buf.class_counts.shape[0])))
        buf.current_index, buf.n_seen_so_far = b["current_index"], b["n_seen"]
    if spec.get("perturb"):
        with torch.no_grad():
            for q in state.model.parameters():
                q.add_(spec["perturb"])
    agent.task_seen = spec.get("task_seen", 0)
    agent.old_labels = list(spec.get("old_labels", []))
    ctx = agent.before_train(spec["ctx_y"]) if p.agent != "CNDPM" else None
    return agent, state, ctx


def result(agent, state, losses):
    """What the tests compare: weights, buffer (whole), losses, EWC's
    temporary Fisher, CN-DPM's STM."""
    from ocl_tpu_torch.parallel.sharded_buffer import ShardedBuffer, gather_buffer

    out = {"sd": {k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()},
           "loss": [float(v) for v in losses]}
    if isinstance(state.agent, dict) and "tmp_fisher" in state.agent:
        out["tmp_fisher"] = {k: v.cpu().clone() for k, v in state.agent["tmp_fisher"].items()}
    buf = state.buffer
    if buf is not None:
        if isinstance(buf, ShardedBuffer):
            buf = gather_buffer(buf)
        out["buffer"] = {"imgs": buf.imgs.cpu().numpy(), "labels": buf.labels.cpu().numpy(),
                         "score": buf.score.cpu().numpy(),
                         "counts": buf.class_counts.cpu().numpy(),
                         "current_index": buf.current_index, "n_seen": buf.n_seen_so_far}
    if agent.params.agent == "CNDPM":
        from ocl_tpu_torch import interop

        ag, _ = interop.cndpm_state_to_jax(state.agent, state.optimizer)
        out["stm"] = {"count": int(ag["stm_count"]), "y": np.asarray(ag["stm_y"]),
                      "x": np.asarray(ag["stm_x"])}
    return out


def run_plain(spec):
    """The spec's steps in one process, the port's own step, on one thread
    as the ranks run (a convolution's order of sums depends on the threads)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _run_plain(spec)
    finally:
        torch.set_num_threads(threads)


def _run_plain(spec):
    agent, state, ctx = build(spec)
    losses = []
    with arithmetic(spec):
        for i in range(spec["xs"].shape[0]):
            res = agent.step(state, ctx, torch.from_numpy(spec["xs"][i]),
                             torch.from_numpy(spec["ys"][i]), draws=spec["draws"][i])
            losses.append((res[0] if isinstance(res, tuple) else res).detach())
    return result(agent, state, losses)


def run_dp(spec):
    """The spec's steps data-parallel on this rank, over a slot-sharded
    buffer (parallel/dp.py::make_dp_train_task). With `first` in the spec,
    also the result after its first `first` steps, as "first"."""
    from ocl_tpu_torch import parallel
    from ocl_tpu_torch.parallel import dp
    from ocl_tpu_torch.parallel.sharded_buffer import shard_buffer

    mesh = parallel.get_mesh()
    agent, state, ctx = build(spec, mesh.device)
    if state.buffer is not None:
        state.buffer = shard_buffer(state.buffer, mesh)
    task = dp.make_dp_train_task(agent, mesh)
    xs, ys = torch.from_numpy(spec["xs"]), torch.from_numpy(spec["ys"])
    n = xs.shape[0]
    cuts = [0, spec["first"], n] if spec.get("first") else [0, n]
    losses, first = [], None
    with arithmetic(spec):
        for lo, hi in zip(cuts, cuts[1:]):
            args = (xs[lo:hi], ys[lo:hi], spec["draws"][lo:hi])
            if agent.params.agent == "CNDPM":
                state, m = task(state, *args)
            else:
                state, m = task(state, ctx, *args)
            losses += list(m["loss"])
            if hi < n:
                first = result(agent, state, losses)
    out = result(agent, state, losses)
    if first is not None:
        out["first"] = first
    return out


def run_specs(specs, retrievals=None):
    """run_dp of every spec (by name) on this rank, and mir_retrieval of
    each of `retrievals` ({name: (spec, grads)})."""
    out = {name: run_dp(spec) for name, spec in specs.items()}
    for name, (spec, grads) in (retrievals or {}).items():
        out[name] = mir_retrieval(spec, grads)
    return out


def mir_retrieval(spec, grads):
    """MIR's retrieval alone, from the spec's first draws and batch with the
    batch gradients `grads` (numpy, by parameter name): data-parallel over a
    slot-sharded buffer on a rank of a launch, else in one process. Returns
    the picks and the BN running statistics after MIR's pre forward."""
    from ocl_tpu_torch import parallel
    from ocl_tpu_torch.parallel import dp
    from ocl_tpu_torch.parallel.sharded_buffer import shard_buffer

    mesh = parallel.current()
    agent, state, _ = build(spec)
    buf = state.buffer if mesh is None else shard_buffer(state.buffer, mesh)
    g = {k: torch.from_numpy(v) for k, v in grads.items()}
    with contextlib.nullcontext() if mesh is None else dp.data_parallel(mesh):
        x, y, mask = agent.retrieve.run(state.model, buf, torch.from_numpy(spec["xs"][0]),
                                        torch.from_numpy(spec["ys"][0]),
                                        spec["draws"][0]["retrieve"][0], grads=g)
    return {"picks": (x.numpy(), y.numpy(), mask.numpy()),
            "stats": {k: v.clone() for k, v in state.model.state_dict().items()
                      if k.endswith(("running_mean", "running_var"))}}


def buffer_checks(case):
    """The sharded-buffer checks of test_torch_parallel_buffer.py on this
    rank: the buffer `case["buffer"]` sharded over the ranks, then random
    and class-balanced retrieval, a reservoir update, ASER's retrieval (its
    SV sums in XLA's order), a GSS update and an NCM evaluation, each on a
    fresh shard. Returns what each gave (whole, on every rank)."""
    from ocl_tpu_torch import parallel
    from ocl_tpu_torch.buffer.reservoir import reservoir_update
    from ocl_tpu_torch.buffer.retrieve import class_balanced_sample, random_retrieve
    from ocl_tpu_torch.parallel import dp
    from ocl_tpu_torch.parallel.sharded_buffer import gather_buffer, shard_buffer

    mesh = parallel.get_mesh()
    out = {}
    agent, state, _ = build(case["aser"])

    def fresh(key="buffer"):
        return shard_buffer(build(dict(case["aser"], buffer=case[key]))[1].buffer, mesh)

    x, y, _, m = random_retrieve(fresh(), case["k"], case["g"])
    out["random"] = (x.numpy(), y.numpy(), m.numpy())
    x, y, idx, m = class_balanced_sample(fresh(), case["n_smp_cls"], case["gc"])
    out["balanced"] = (x.numpy(), y.numpy(), idx.numpy(), m.numpy())

    sbuf = fresh("update_buffer")
    replaced = reservoir_update(sbuf, *case["update"])
    whole = gather_buffer(sbuf)
    out["update"] = (whole.labels.numpy(), whole.imgs.numpy(), whole.class_counts.numpy(),
                     replaced.numpy(), whole.current_index, whole.n_seen_so_far)

    sbuf = fresh()
    sbuf.n_seen_so_far = case["aser_n_seen"]
    with arithmetic({"xla_order": True}), dp.data_parallel(mesh):
        mx, my, mm = agent.retrieve.run(state.model, sbuf, *case["aser_batch"],
                                        case["aser_draws"])
    out["aser"] = (mx.numpy(), my.numpy(), mm.numpy())

    g_agent, g_state, _ = build(dict(case["gss"], buffer=case["gss_buffer"]))
    g_state.buffer = shard_buffer(g_state.buffer, mesh)
    g_agent.update.run(g_state.model, g_state.buffer, *case["gss_batch"], case["gss_draws"])
    whole = gather_buffer(g_state.buffer)
    out["gss"] = (whole.labels.numpy(), whole.score.numpy(), whole.class_counts.numpy())

    n_agent, n_state, _ = build(dict(case["ncm"], buffer=case["buffer"]))
    n_state.buffer = shard_buffer(n_state.buffer, mesh)
    n_agent.eval_mesh = mesh
    loaders = dp.shard_loaders(mesh, case["loaders"])
    out["ncm"] = (n_agent.ncm_means(n_state, case["noise"]).numpy(),
                  n_agent._evaluate_ncm(n_state, loaders, case["noise"]))
    return out


def eval_checks(case):
    """The evaluation fan-out on this rank: make_dp_eval's accuracies, and
    `evaluate`'s over this rank's test rows (NCM over a replicated buffer,
    --error_analysis in `case["cwd"]`)."""
    import os

    from ocl_tpu_torch import parallel
    from ocl_tpu_torch.parallel import dp

    mesh = parallel.get_mesh()
    out = {}
    agent, state, _ = build(case["softmax"])
    out["softmax"] = dp.make_dp_eval(agent, mesh)(state, case["loaders"])
    loaders = dp.shard_loaders(mesh, case["loaders"])
    n_agent, n_state, _ = build(case["ncm"])
    n_agent.eval_mesh = mesh
    out["ncm"] = n_agent._evaluate_ncm(n_state, loaders, case["noise"])
    e_agent, e_state, _ = build(case["errors"])
    e_agent.eval_mesh = mesh
    os.chdir(case["cwd"])
    out["errors"] = (e_agent.evaluate(e_state, loaders), e_agent.error_list)
    return out


def linger(seconds, rank_that_lingers):
    """One rank sleeps `seconds`, the others return at once (a hung rank)."""
    import time

    from ocl_tpu_torch import parallel

    if parallel.get_mesh().rank == rank_that_lingers:
        time.sleep(seconds)
    return parallel.get_mesh().rank


def slow_lead_run(params, delay_s, group_timeout_s):
    """experiment/run.py::multiple_run on this rank, in a group whose
    collectives time out after `group_timeout_s`, with rank 0 sleeping
    `delay_s` before its first train_learner: a task that trains for longer
    than the timeout while the other ranks wait to evaluate."""
    import time

    import torch.distributed as dist

    from ocl_tpu_torch import parallel
    from ocl_tpu_torch.agents.base import ContinualLearner
    from ocl_tpu_torch.experiment.run import multiple_run

    mesh = parallel.get_mesh()
    parallel.shutdown()
    mesh = parallel.init(mesh.rank, mesh.size, "cpu", store=dist.PrefixStore("short", mesh.store),
                         timeout_s=group_timeout_s)
    if mesh.rank == 0:
        cls = ContinualLearner
        train = cls.train_learner

        def slow(self, *args, **kwargs):
            cls.train_learner = train
            time.sleep(delay_s)
            return train(self, *args, **kwargs)

        cls.train_learner = slow
    return multiple_run(params, store=True, save_path="acc.pkl")
