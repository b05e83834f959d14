"""One run of one cell: set-up, the measured window, the traced block of a
`--trace 1` run, then the reference's judgement of the checked steps.

The window is a closed loop: steps run back to back, the host enqueueing as
far ahead as the port lets it. It stops at the first step boundary after
`seconds` on the host clock and then synchronises. After each step the
harness records a CUDA event without syncing; the step intervals are read
from them once the window has closed. Nothing compiles inside the window:
set-up has run the cell's shapes (the checked steps and a few more).

End-to-end metrics (untraced runs): images_per_s, every stacked point's new
stream images over the window's wall time from the first step's enqueue to
the final synchronise; step_ms_p95, the 95th percentile (linear
interpolation) of the step intervals; setup_s, process start to the
window's first step. A traced run profiles `trace_steps` steps from 40% of
the window, between two synchronisations, and reports the per-layer
metrics, whose readers (oclbench/metrics/) read its `Run`.
"""

from __future__ import annotations

import gc
import importlib
import re
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from oclbench import flops, spec, trace
from oclbench.loops import arch_of
from oclbench.reference.judge import compare
from oclbench.reference.replay import replay

TRACE_START = 0.4   # share of the window before the traced block


@dataclass
class Run:
    """What the per-layer readers read."""
    events: list = field(default_factory=list)
    span: tuple | None = None
    block_steps: int = 0
    host_step_s: list = field(default_factory=list)   # outside the block
    intervals_s: list = field(default_factory=list)   # outside the block and the step after it
    step_flops: int = 0


def loop_for(cell, seed, device, seconds):
    """The cell's loop: class `Loop` of oclbench/loops/<its traffic's loop>.py."""
    name = cell.traffic["loop"]
    if not re.fullmatch(r"[a-z_][a-z0-9_]*", name):
        raise ValueError("no loop module can be named {!r}".format(name))
    return importlib.import_module("oclbench.loops." + name).Loop(cell.config, cell.traffic,
                                                                   seed, device, seconds)


def ref_cfg(config: dict) -> dict:
    r = config["recipe"]
    return {"n_smp_cls": int(r.get("n_smp_cls", 0)), "k": int(r.get("k", 0)),
            "eps_mem_batch": int(r["eps_mem_batch"])}


class Marks:
    """Step-end marks: CUDA events on the card (recorded without a sync,
    read after the window), the host clock on the CPU (tests only)."""

    def __init__(self, device, n):
        self.cuda = device.type == "cuda"
        self.pool = [torch.cuda.Event(enable_timing=True) for _ in range(n)] if self.cuda else []
        self.marks = []

    def mark(self):
        if not self.cuda:
            self.marks.append(time.perf_counter())
            return
        e = self.pool[len(self.marks)] if len(self.marks) < len(self.pool) else \
            torch.cuda.Event(enable_timing=True)
        e.record()
        self.marks.append(e)

    def intervals_s(self):
        if not self.cuda:
            return list(np.diff(self.marks))
        return [a.elapsed_time(b) / 1e3 for a, b in zip(self.marks, self.marks[1:])]


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def window(loop, seconds, device, trace_steps=0):
    """Runs the window; returns (steps, wall seconds, step intervals,
    host seconds of each step call, (first, last) step of the traced block
    or None, the finished profile or None)."""
    n_pool = int(loop.traffic["max_steps_per_s"] * seconds) + 16
    marks = Marks(device, n_pool)
    host, block, prof = [], None, None
    t0 = time.perf_counter()
    marks.mark()
    while True:
        if trace_steps and block is None and time.perf_counter() - t0 >= TRACE_START * seconds:
            first = len(host)
            prof = traced_block(loop, trace_steps, device, marks)
            host += [None] * trace_steps
            block = (first, first + trace_steps - 1)
            continue
        h0 = time.perf_counter()
        loop.step()
        h1 = time.perf_counter()
        host.append(h1 - h0)
        marks.mark()
        if h1 - t0 >= seconds and (not trace_steps or block is not None):
            break
    sync(device)
    wall = time.perf_counter() - t0
    return len(host), wall, marks.intervals_s(), host, block, prof


def traced_block(loop, steps, device, marks):
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    sync(device)
    with loop.instrumented(), profile(activities=activities) as prof:
        with record_function("block"):
            for _ in range(steps):
                with record_function("step"):
                    loop.step()
                marks.mark()
            sync(device)
    return prof


def run_cell(cell, seed, seconds, trace_on, device, t_start, fault=None):
    """One run of `cell` (a spec.Cell); returns (result dict, checks
    {name: (value, limit)}). `fault` (tests and calibration only) breaks
    the port before the checked steps."""
    device = torch.device(device)
    loop = loop_for(cell, seed, device, seconds)
    split = {"imports_cuda_init": time.perf_counter() - t_start}
    loop.setup(fault)
    sync(device)
    setup_s = time.perf_counter() - t_start
    split.update(loop.split)
    trace_steps = cell.traffic["trace_steps"] if trace_on else 0
    try:
        steps, wall, intervals, host, block, prof = window(loop, seconds, device, trace_steps)
        failed = loop.finish()
    finally:
        if loop.undo is not None:
            loop.undo()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    step_fn, record, start = loop.reference_step, loop.record, loop.start
    images_per_step, points = loop.images_per_step, loop.points
    loop.free()
    del loop
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    result = {"correct": None, "attempted": steps, "failed": failed, "metrics": {},
              "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                         "kind": torch.cuda.get_device_name(device) if device.type == "cuda"
                         else "cpu",
                         "count": 1, "memory_peak_bytes": int(peak)}}
    if trace_on:
        run = traced_run(cell, points, prof, block, host, intervals)
        for m in cell.per_layer:
            value = spec.reader(m["name"])(run)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        if run.span is not None:
            work = trace.device_work(run.events, run.span)
            result["device"]["busy_s"] = sum(
                b - a for a, b in trace.busy_intervals(work)) / 1e9
            result["device"]["window_s"] = (run.span[1] - run.span[0]) / 1e9
            result["breakdown"] = {"device_ops": [list(kv) for kv in
                                                  trace.device_ops(run.events, run.span)],
                                   "idle_gaps": [list(kv) for kv in
                                                 trace.idle_gaps(run.events, run.span)[:10]]}
    else:
        values = {"images_per_s": steps * images_per_step / wall,
                  "step_ms_p95": float(np.percentile(intervals, 95)) * 1e3,
                  "setup_s": setup_s}
        for m in cell.end_to_end:
            result["metrics"][m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}

    t_ref = time.perf_counter()
    numbers = judge(step_fn, arch_of(cell.config), ref_cfg(cell.config), start, record)
    split["reference_check_after_window"] = time.perf_counter() - t_ref
    checks = {k: (numbers[k], cell.limits[k]) for k in cell.limits}
    result["correct"] = all(v <= lim for v, lim in checks.values())
    result["setup_split_s"] = split
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return result, checks


def judge(step_fn, arch, cfg, start, record):
    """The judge's numbers of a program record against the reference's
    step `step_fn`."""
    ref, picks, exact = replay(step_fn, arch, cfg, start, prog=record)
    return compare(record, ref, picks, exact)


def traced_run(cell, points, prof, block, host, intervals):
    run = Run()
    run.step_flops = flops.step_flops(arch_of(cell.config), cell.traffic["step_passes"], points)
    first, last = block
    run.host_step_s = [h for h in host if h is not None]
    run.intervals_s = [s for i, s in enumerate(intervals) if not first <= i <= last + 1]
    run.block_steps = last - first + 1
    if prof is not None:
        run.events = trace.events_of(prof)
        run.span = trace.block_span(run.events)
    return run
