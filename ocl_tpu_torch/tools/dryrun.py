"""The distribution layer's patterns, each run once over W ranks (the port's
counterpart of `__graft_entry__.py::dryrun_multichip`).

    python -m ocl_tpu_torch.tools.dryrun --n_devices 2 [--device cpu] [--nf 20]

At nf 4 (or --nf) and the JAX dry run's sizes (memory 8 W slots, batch and retrieved
rows 2 W): the data-parallel ER step over a slot-sharded buffer, the memory
it fills, ER + ASER (K1 on every rank), ER + GSS, SCR's two-view step,
CN-DPM's wake step, the softmax and NCM evaluation fan-out (NCM's beside
its unsharded accuracy), and the stacked grid tune with its points dealt to
the ranks. Each pattern prints a flushed
`pattern OK: <name> (i/n, t=...s)` line when it finishes, with the ranks'
parameter checksums, which must agree; the last line sums them up. Ranks
share the card when W exceeds the cards (backend gloo).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

PATTERNS = ("dp-batch ER train step", "slot-sharded memory fill",
            "sharded ASER KNN-SV retrieve/update", "sharded GSS update",
            "sharded SCR two-view step", "sharded CN-DPM wake step", "eval fan-out",
            "sharded NCM eval", "grid-parallel tune")


def checksum(model) -> float:
    """Σ of every parameter and BN buffer, in float64: the ranks' must agree."""
    return float(sum(t.double().sum() for t in model.state_dict().values()))


def _ranks_agree(mesh, value: float) -> bool:
    vals = mesh.all_gather(torch.tensor([value], dtype=torch.float64, device=mesh.device))
    return bool((vals == vals[0]).all())


def _setup(mesh, device, seed, nf, **kw):
    from ocl_tpu_torch.config import default_params
    from ocl_tpu_torch.parallel.sharded_buffer import shard_buffer
    from ocl_tpu_torch.registry import agents

    p = default_params(data="synthetic", nf=nf, verbose=False, device=str(device), **kw)
    agent = agents[p.agent](p)
    state = agent.init_state(seed)
    if state.buffer is not None:
        state.buffer = shard_buffer(state.buffer, mesh)
    return agent, state, agent.before_train([0, 1])


def _batches(device, steps, batch, seed):
    g = np.random.RandomState(seed)
    xs = torch.tensor(g.rand(steps, batch, 32, 32, 3), dtype=torch.float32, device=device)
    ys = torch.tensor(np.tile(np.arange(2), (steps, batch // 2)), device=device)
    return xs, ys


def run_patterns(nf: int = 4):
    """Every pattern on this rank at base width `nf`; returns this rank's
    figures."""
    from ocl_tpu_torch import parallel
    from ocl_tpu_torch.models import feature_dim_for
    from ocl_tpu_torch.ops import distance
    from ocl_tpu_torch.parallel import dp
    from ocl_tpu_torch.parallel.sharded_buffer import gather_buffer

    mesh = parallel.get_mesh()
    w, dev = mesh.size, mesh.device
    t0 = time.perf_counter()
    done, out = [], {"rank": mesh.rank, "agree": {}, "loss": {}}

    def ok(name, model=None, loss=None):
        if model is not None:
            out["agree"][name] = _ranks_agree(mesh, checksum(model))
            if not out["agree"][name]:
                raise RuntimeError("pattern {}: the ranks' parameters differ".format(name))
        if loss is not None:
            out["loss"][name] = float(loss)
            if not np.isfinite(out["loss"][name]):
                raise RuntimeError("pattern {}: loss {}".format(name, loss))
        done.append(name)
        print("pattern OK: {} ({}/{}, t={:.1f}s)".format(name, len(done), len(PATTERNS),
                                                         time.perf_counter() - t0), flush=True)

    # 1-2: the DP ER step over a slot-sharded buffer, and the memory it fills
    agent, state, ctx = _setup(mesh, dev, 0, nf, agent="ER", mem_size=w * 8, eps_mem_batch=w * 2,
                               batch=w * 2)
    xs, ys = _batches(dev, 2, w * 2, 0)
    state, m = dp.make_dp_train_task(agent, mesh)(state, ctx, xs, ys)
    ok(PATTERNS[0], state.model, m["loss"][-1])
    full = gather_buffer(state.buffer)
    if full.current_index != 2 * w * 2 or not torch.equal(full.labels[:4 * w].cpu(),
                                                         ys.reshape(-1).cpu()):
        raise RuntimeError("the sharded memory holds {} rows, not the batches'".format(
            full.current_index))
    ok(PATTERNS[1])

    # 3: ER + ASER past a full memory, K1 on every rank
    a_agent, a_state, a_ctx = _setup(mesh, dev, 1, nf, agent="ER", update="ASER", retrieve="ASER",
                                     aser_type="asvm", k=2, n_smp_cls=1.0, mem_size=w * 8,
                                     eps_mem_batch=w, batch=w * 2)
    a_xs, a_ys = _batches(dev, (w * 8) // (w * 2) + 2, w * 2, 1)
    before = distance.pairwise_sqdist.launches
    a_state, a_m = dp.make_dp_train_task(a_agent, mesh)(a_state, a_ctx, a_xs, a_ys)
    out["k1_launches"] = distance.pairwise_sqdist.launches - before
    if out["k1_launches"] == 0 and dev.type == "cuda":
        raise RuntimeError("the DP ASER step launched no pairwise_sqdist kernel")
    ok(PATTERNS[2], a_state.model, a_m["loss"][-1])

    # 4: ER + GSS past a full memory
    g_agent, g_state, g_ctx = _setup(mesh, dev, 2, nf, agent="ER", update="GSS",
                                     gss_mem_strength=2, gss_batch_size=w, mem_size=w * 8,
                                     eps_mem_batch=w, batch=w * 2)
    g_xs, g_ys = _batches(dev, (w * 8) // (w * 2) + 2, w * 2, 2)
    g_state, g_m = dp.make_dp_train_task(g_agent, mesh)(g_state, g_ctx, g_xs, g_ys)
    ok(PATTERNS[3], g_state.model, g_m["loss"][-1])

    # 5: SCR's two-view step
    s_agent, s_state, s_ctx = _setup(mesh, dev, 3, nf, agent="SCR", mem_size=w * 8,
                                     eps_mem_batch=w, batch=w * 2, head="mlp", temp=0.07)
    s_xs, s_ys = _batches(dev, 2, w * 2, 3)
    s_state, s_m = dp.make_dp_train_task(s_agent, mesh)(s_state, s_ctx, s_xs, s_ys)
    ok(PATTERNS[4], s_state.model, s_m["loss"][-1])

    # 6: CN-DPM's wake step
    from ocl_tpu_torch.models import ndpm_vars as V

    old_z, V.VAE_Z_SAMPLES = V.VAE_Z_SAMPLES, 2
    try:
        c_agent, c_state, _ = _setup(mesh, dev, 4, nf, agent="CNDPM", max_experts=2,
                                     stm_capacity=8 * w, batch=w * 2, optimizer="Adam",
                                     learning_rate=0.001)
        c_agent.sleep_step_g, c_agent.sleep_step_d = 4, 2
        c_xs, c_ys = _batches(dev, 2, w * 2, 4)
        c_state, c_m = dp.make_dp_train_task(c_agent, mesh)(c_state, c_xs, c_ys)
        if int(c_state.agent["stm_count"]) != 2 * w * 2:
            raise RuntimeError("the CN-DPM STM holds {} rows".format(
                int(c_state.agent["stm_count"])))
        ok(PATTERNS[5], c_state.model, c_m["loss"][-1])
    finally:
        V.VAE_Z_SAMPLES = old_z

    # 7-8: the evaluation fan-out, softmax and NCM
    tx, ty = _batches(dev, 2, w * 2, 5)
    tm = torch.ones_like(ty, dtype=torch.bool)
    acc = dp.make_dp_eval(agent, mesh)(state, [(tx, ty, tm)])
    if not 0.0 <= float(acc[0]) <= 1.0:
        raise RuntimeError("eval fan-out accuracy {}".format(acc))
    ok(PATTERNS[6])
    s_agent.old_labels = [0, 1]
    noise = torch.zeros(s_agent.n_classes, feature_dim_for("synthetic", nf), device=dev)
    whole = s_agent._evaluate_ncm(s_state, [(tx, ty, tm)], noise)   # on every row
    s_agent.eval_mesh = mesh
    accs = s_agent._evaluate_ncm(s_state, dp.shard_loaders(mesh, [(tx, ty, tm)]), noise)
    out["ncm"] = (float(accs[0]), float(whole[0]))
    if not 0.0 <= float(accs[0]) <= 1.0:
        raise RuntimeError("NCM fan-out accuracy {}".format(accs))
    ok(PATTERNS[7])

    # 9: the stacked grid tune, its points dealt to the ranks
    from ocl_tpu_torch.config import default_params
    from ocl_tpu_torch.experiment.parallel_tune import tune_hyper_parallel
    from ocl_tpu_torch.experiment.tune import _merged, parameter_grid

    params = default_params(data="synthetic", agent="ER", nf=nf, verbose=False, device=str(dev),
                            mem_size=w * 8, eps_mem_batch=w * 2, batch=w * 2, num_runs_val=1,
                            n_devices=w)
    g = np.random.RandomState(0)
    tune_data = [(g.rand(4 * w, 32, 32, 3).astype(np.float32), g.randint(0, 2, 4 * w), None)]
    loaders = [(tx[:1], ty[:1], tm[:1])]
    tune = {"learning_rate": [0.01, 0.1]}
    grid = parameter_grid(tune)
    best = tune_hyper_parallel(tune_data, loaders, params, tune, grid, _merged)
    if best not in grid:
        raise RuntimeError("the tune returned {}".format(best))
    ok(PATTERNS[8])
    out["seconds"] = time.perf_counter() - t0
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--n_devices", type=int, default=2)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--nf", type=int, default=4)
    args = parser.parse_args(argv)
    from ocl_tpu_torch import parallel

    results = parallel.launch(run_patterns, (args.nf,), args.n_devices, args.device)
    r0 = results[0]
    print("dryrun OK on {} ranks ({} patterns: {}); K1 launches per rank {}; losses {}; NCM "
          "fan-out / unsharded accuracy {}; {:.1f} s".format(
              args.n_devices, len(PATTERNS), ", ".join(PATTERNS),
              [r["k1_launches"] for r in results],
              {k: round(v, 4) for k, v in r0["loss"].items()}, r0["ncm"], r0["seconds"]),
          flush=True)
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
