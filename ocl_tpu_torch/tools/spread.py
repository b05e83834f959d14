"""Repeat one configuration of the flag CLI and show how its runs spread.

For every run of every repeat: its accuracy on each task's own test set
right after training that task, also with BN on the test batches' own
statistics, the loss of every step, whether its weights, BN statistics and
losses stayed finite, and, on the synthetic stream, how many buffer slots
hold a label other than their image's class. A run that reads low on the
task it has just trained shows here whether it diverged (non-finite
values), was fed wrong labels (mislabelled slots), ended its task inside a
loss spike (its last steps' losses), or has running BN statistics that lag
its weights (it reads high on batch statistics).

    python -m ocl_tpu_torch.tools.spread --repeats 8 -- --data synthetic \\
        --agent ER --update GSS --num_runs 3 --parallel_runs True ...

The flags after `--` are general_main's; the runs take cuDNN's and
torch's default algorithms, or with `--deterministic` deterministic ones.
`--seed_step K` runs repeat i at seed + i K. A task with no step (CORe50's
cut trees) is not counted as read low.
One line a repeat; with `--json PATH`, every figure as one JSON object
there. `deterministic()` serves chip_smoke.py's phases 18, 22 (c) and 24.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import time

import numpy as np
import torch

# a run "reads low" on a task it has just trained at or below this accuracy
LOW = 0.5


@contextlib.contextmanager
def deterministic():
    """Within the block, cuDNN and torch choose deterministic algorithms, so
    that two runs from one state compute the same sums. Yields the set of
    the warnings of ops that have no deterministic algorithm (they run as
    before)."""
    import warnings

    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
             torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    seen = set()
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield seen
            seen.update(str(w.message).split(".")[0] for w in caught
                        if "deterministic" in str(w.message))
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved[:2]
        torch.use_deterministic_algorithms(saved[2], warn_only=saved[3])


def synthetic_classes(params):
    """[n_classes, D] the synthetic stream's class centres (data/datasets.py::
    Synthetic), or None for another dataset."""
    if params.data != "synthetic":
        return None
    n = getattr(params, "synthetic_classes", 10)
    templates = np.random.RandomState(1234).rand(n, 32, 32, 3)
    scale = 1.0 - 0.85 * float(getattr(params, "synthetic_difficulty", 0.0))
    return torch.tensor((0.5 + scale * (templates - 0.5)).reshape(n, -1), dtype=torch.float32)


def mislabelled(imgs, labels, centres):
    """[P] slots a point whose label is not its image's nearest class centre;
    imgs [P, n, ...], labels [P, n]."""
    if centres is None or imgs.shape[1] == 0:
        return [0] * imgs.shape[0]
    x = imgs.reshape(imgs.shape[0], imgs.shape[1], -1).float().cpu()
    nearest = torch.cdist(x, centres[None].expand(x.shape[0], -1, -1)).argmin(-1)
    return (nearest != labels.cpu()).sum(1).tolist()


def all_finite(tensors):
    return bool(all(torch.isfinite(t).all() for t in tensors))


@torch.no_grad()
def batch_stats(model, xb, mb):
    """Predictions with BN on the test batch's own statistics (rows where
    `mb`) in place of the running ones, which stay as they are."""
    return model(xb, train=True, w=mb, fold=False).argmax(1)


def instrument(agent, rec, centres):
    """Record into `rec` every step's loss a point of `agent`'s runs
    (stacked or one at a time) and, after each task, whether the points'
    tensors are finite, how many slots a point are mislabelled, and each
    point's accuracy on the task's own test set with BN on batch statistics
    (a run whose running statistics lag its weights reads low only
    without them)."""
    from ocl_tpu_torch.agents.base import point_map

    step, stacked_step = agent.step, agent.stacked_step
    evaluate, evaluate_stacked = agent.evaluate, agent.evaluate_stacked

    def one_step(state, ctx, xb, yb, draws=None):
        loss, acc = step(state, ctx, xb, yb, draws)
        rec["loss"].append(loss.detach().reshape(1))
        return loss, acc

    def one_stacked_step(ss, ctx, xb, yb, draws=None):
        loss, acc = stacked_step(ss, ctx, xb, yb, draws)
        rec["loss"].append(loss.detach().reshape(-1))
        return loss, acc

    def own_test_set(test_loaders):
        """The test set of the task just trained (CORe50's ni protocol has one
        for all its tasks)."""
        return test_loaders[min(agent.task_seen - 1, len(test_loaders) - 1)]

    def after_task(model_tensors, buf, batch_acc):
        entry = {"end": len(rec["loss"]), "finite": all_finite(model_tensors),
                 "mislabelled": [0], "batch_stats_acc": batch_acc}
        if buf is not None:
            n = buf.current_index
            imgs, labels = buf.slot_imgs[..., :n, :, :, :], buf.slot_labels[..., :n]
            if labels.dim() == 1:
                imgs, labels = imgs[None], labels[None]
            entry["mislabelled"] = mislabelled(imgs, labels, centres)
        rec["tasks"].append(entry)

    def one_evaluate(state, test_loaders):
        model = state.model
        x, y, m = own_test_set(test_loaders)
        right = sum(((batch_stats(model, xb, mb) == yb) & mb).sum() for xb, yb, mb in zip(x, y, m))
        after_task(list(model.parameters()) + list(model.buffers()), state.buffer,
                   [float(right / m.sum())])
        return evaluate(state, test_loaders)

    def one_evaluate_stacked(ss, test_loaders):
        params, buffers = ss.model.tensors()
        x, y, m = own_test_set(test_loaders)
        right = sum(((point_map(ss, lambda v, _, xb, mb: batch_stats(v.model, xb, mb), None,
                                x[:, i], m[:, i]) == y[:, i]) & m[:, i]).sum(1)
                    for i in range(x.shape[1]))
        after_task(list(params.values()) + list(buffers.values()), ss.buffer,
                   (right / m.sum((1, 2))).tolist())
        return evaluate_stacked(ss, test_loaders)

    agent.step, agent.stacked_step = one_step, one_stacked_step
    agent.evaluate, agent.evaluate_stacked = one_evaluate, one_evaluate_stacked


def repeat_once(params):
    """One run of general_main on `params`, its output kept quiet: (its
    accuracy array [runs, tasks, tests], the record of instrument())."""
    import ocl_tpu_torch.experiment.parallel_run as parallel_mod
    import ocl_tpu_torch.experiment.run as run_mod
    from ocl_tpu_torch.general_main import main
    from ocl_tpu_torch.registry import agents

    arrays, rec, centres = [], {"loss": [], "tasks": []}, synthetic_classes(params)
    build, compute = agents[params.agent], run_mod.compute_performance

    def built(*args, **kwargs):
        agent = build(*args, **kwargs)
        instrument(agent, rec, centres)
        return agent

    def kept(acc):
        arrays.append(np.array(acc))
        return compute(acc)

    agents[params.agent] = built
    run_mod.compute_performance = parallel_mod.compute_performance = kept
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            main(params)
    finally:
        agents[params.agent] = build
        run_mod.compute_performance = parallel_mod.compute_performance = compute
    return arrays[-1], rec


def summarise(acc, rec):
    """Per run, per task: its accuracy on the task's own test set after
    training it, its last 5 losses, the largest of its last 10 and of all,
    whether they and the run's tensors stayed finite, and its mislabelled
    slots. Stacked runs record one entry a task for every run; runs one at
    a time record one a task, run after run."""
    runs, tasks = acc.shape[:2]
    stacked = len(rec["tasks"]) == tasks and runs > 1
    out = [[] for _ in range(runs)]
    start = 0
    for i, entry in enumerate(rec["tasks"]):
        rows = rec["loss"][start:entry["end"]]
        loss = torch.stack(rows).float().cpu().numpy() if rows else np.zeros((0, runs))
        start = entry["end"]
        t = i % tasks
        for r in (range(runs) if stacked else [i // tasks]):
            col = loss[:, r if stacked else 0]
            out[r].append({
                "own": float(acc[r, t, min(t, acc.shape[2] - 1)]),
                "last5": col[-5:].round(4).tolist(),
                "max_last10": float(col[-10:].max()) if len(col) else None,
                "max": float(col.max()) if len(col) else None,
                "batch_stats_own": entry["batch_stats_acc"][r if stacked else 0],
                "finite": entry["finite"] and bool(np.isfinite(col).all()),
                "mislabelled": entry["mislabelled"][r if stacked else 0]})
    return out


def reads_low(runs):
    """[(run, task)] of summarise()'s lanes that read <= LOW on a task they
    trained (a task with no step is left out)."""
    return [(r, t) for r, lanes in enumerate(runs) for t, lane in enumerate(lanes)
            if lane["own"] <= LOW and lane["max"] is not None]


def main(argv=None):
    from ocl_tpu_torch.config import build_parser

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--repeats", type=int, default=5)
    parser.add_argument("--seed_step", type=int, default=0,
                        help="repeat i runs at --seed + i * seed_step (0: every repeat at "
                             "--seed, so that only the card's own order of sums differs)")
    parser.add_argument("--deterministic", action="store_true",
                        help="run every repeat under deterministic algorithms (cuDNN and torch)")
    parser.add_argument("--json", default=None, help="write every figure here as JSON")
    parser.add_argument("flags", nargs=argparse.REMAINDER, help="-- general_main's flags")
    args = parser.parse_args(argv)
    flags = args.flags[1:] if args.flags[:1] == ["--"] else args.flags
    figures = {"flags": flags, "deterministic": args.deterministic, "repeats": []}
    for i in range(args.repeats):
        params = build_parser().parse_args(flags)
        params.seed += i * args.seed_step
        t0 = time.time()
        with deterministic() if args.deterministic else contextlib.nullcontext():
            acc, rec = repeat_once(params)
        runs = summarise(acc, rec)
        secs = time.time() - t0
        low = reads_low(runs)
        print("[spread] repeat {} (seed {}, {:.1f} s): each run's own-task accuracies {}; "
              "finite {}; mislabelled slots {}; reads <= {} at (run, task) {}".format(
                  i, params.seed, secs,
                  [[round(lane["own"], 4) for lane in lanes] for lanes in runs],
                  all(lane["finite"] for lanes in runs for lane in lanes),
                  [max(lane["mislabelled"] for lane in lanes) for lanes in runs], LOW, low),
              flush=True)
        for r, t in low:
            lane = runs[r][t]
            print("[spread]   run {} task {}: {:.4f} with BN on the test batches' statistics; "
                  "last 5 losses {}, largest of the last 10 {:.4f}, largest {:.4f}".format(
                      r, t, lane["batch_stats_own"], lane["last5"], lane["max_last10"],
                      lane["max"]), flush=True)
        figures["repeats"].append({"seed": params.seed, "seconds": secs, "runs": runs})
    if args.json:
        with open(args.json, "w") as f:
            json.dump(figures, f)
    return figures


if __name__ == "__main__":
    main()
