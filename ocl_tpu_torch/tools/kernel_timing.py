"""Timing of small kernels on the card.

Work of a few microseconds cannot be timed by one pair of CUDA events around
one Python call: the events then measure how fast the host enqueues the call,
and the spread between two runs is host noise. Each figure here times many
calls and divides by their count:

  device_ms   `launches` calls captured in one CUDA graph, CUDA events around
              each replay, the median replay over `launches`: what the card
              spends per call when the host keeps it fed;
  enqueue_ms  CUDA events around a loop of eager calls, over their count: the
              card's time per call when the host drives it eagerly, which for
              small work is the host's rate of issue;
  host_us     the host clock over eager calls with no sync (one sync after the
              clock is read), per call: the Python and launch cost.

The launch floor is device_ms of `t.zero_()` on a one-element tensor, the
least a launch costs the card inside a graph. `kernel_times` reads kernel
device times by name from a `torch.profiler` trace, as a cross-check, and
`busy_ms` the time in which at least one kernel ran: kernels on several
streams overlap, so their sum can exceed the wall time. Both read the
trace's raw device events, the ones `prof.events()` lists with device type
CUDA: `prof.events()` first builds the tree of every host op, which takes
tens of seconds for a trace of 10^5 events. `trace_events` reads a Chrome
trace file's events.

The timing functions need a CUDA device (nothing falls back to the CPU); the
readers read the trace they are given.
"""

from __future__ import annotations

import json
import statistics
import time

import torch

# published peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet)
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def _events(n):
    return [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            for _ in range(n)]


def device_ms(fn, launches=100, replays=20, warmup=3):
    """Device time of one call of `fn`: `launches` calls captured in one CUDA
    graph, the median of `replays` replays, each timed by CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    for _ in range(warmup):
        graph.replay()
    pairs = _events(replays)
    for start, end in pairs:
        start.record()
        graph.replay()
        end.record()
    torch.cuda.synchronize()
    ms = statistics.median(s.elapsed_time(e) for s, e in pairs) / launches
    graph.reset()
    return ms


def enqueue_ms(fn, calls=100, reps=5, warmup=10):
    """CUDA-event time of a loop of `calls` eager calls over `calls`, the
    median of `reps` loops."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = _events(reps)
    for start, end in pairs:
        start.record()
        for _ in range(calls):
            fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs) / calls


def host_us(fn, calls=1000, warmup=10):
    """Host-clock microseconds per eager call, over `calls` calls with no sync
    in between; one sync after the clock is read."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def figures(fn):
    """device_ms, enqueue_ms and host_us of `fn`, as a dict."""
    return {"device_ms": device_ms(fn), "enqueue_ms": enqueue_ms(fn), "host_us": host_us(fn)}


def launch_floor():
    """The three figures of `t.zero_()` on a one-element CUDA tensor."""
    t = torch.zeros(1, device="cuda")
    return figures(t.zero_)


def sqdist_bound(n, m, d):
    """(bound_ms, bound_by) of an [n, d] x [m, d] -> [n, m] fp32 squared
    distance: 2nmd + 2(n+m)d operations at the fp32 peak, against each input
    read once and the output written once at the memory peak."""
    flops = 2 * n * m * d + 2 * (n + m) * d
    nbytes = 4 * (n * d + m * d + n * m)
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def device_events(prof):
    """[(name, start ns, end ns)] of every device event (kernel, memcpy,
    memset) of a finished `torch.profiler.profile`, from its raw kineto
    results."""
    return [(e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_hidden_event", lambda: False)()]


def trace_events(path, category=None):
    """[(name, category, start us, duration us)] of the complete events of a
    Chrome trace file (`utils/profiling.py::trace` writes one), those of
    `category` alone if given ("cpu_op" for host ops, "kernel" for CUDA
    kernels)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], e.get("cat"), e["ts"], e["dur"]) for e in events
            if e.get("ph") == "X" and (category is None or e.get("cat") == category)]


def kernel_times(prof):
    """[(kernel name, device microseconds)] of every CUDA kernel in a
    finished `torch.profiler.profile`."""
    return [(name, (end - start) / 1e3) for name, start, end in device_events(prof)]


def busy_ms(prof):
    """Milliseconds of a finished `torch.profiler.profile` in which at least
    one CUDA kernel ran (the union of their intervals)."""
    total, end = 0, None
    for _, s, e in sorted(device_events(prof), key=lambda ev: (ev[1], ev[2])):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e6


def profiled_ms(fn, name, calls=100):
    """(ms per kernel, kernel count) of the kernels whose name contains `name`
    over `calls` eager calls of `fn`, from torch.profiler; (None, 0) when the
    trace holds no such kernel or no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    times = [us for k, us in kernel_times(prof) if name in k]
    if not times or sum(times) <= 0:
        return None, 0
    return sum(times) / len(times) / 1e3, len(times)
