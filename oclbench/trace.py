"""The traced block of a `--trace 1` run: a bounded run of steps in mid-window
under `torch.profiler` (CPU and CUDA activities), reduced to a list of
`Event`s that the per-layer readers and the breakdown read.

Kinds: "kernel", "memcpy", "memset" (device work), "runtime" (the host's
CUDA API calls, cuda* and cu*, which carry the correlation id of the work
they launched) and "range" (the benchmark's own `record_function` ranges:
"block" around the whole block, "step" around each step, "aser.retrieve",
"aser.update", "batchify", "task_boundary", and "k1:<n>x<m>x<d>x<points>"
around each launch of the distance kernel). Times are nanoseconds on the
profiler's clock, which it aligns for host and device.
"""

from __future__ import annotations

from typing import NamedTuple

RANGES = ("block", "step", "aser.retrieve", "aser.update", "batchify", "task_boundary")


class Event(NamedTuple):
    kind: str
    name: str
    start: int
    end: int
    corr: int = 0


def is_range(name):
    return name in RANGES or name.startswith("k1:")


def kind_of(device_type, name):
    """An event's kind from its device and name (the kineto events of
    torch 2.11 carry no activity type): device events are kernels unless
    named as copies or memsets, or as one of the benchmark's ranges (the
    profiler's projection of a host range onto the device's timeline, no
    work of its own); host events named as CUDA API calls are launches;
    the benchmark's own ranges by name; anything else (aten ops) None."""
    if device_type == "cuda":
        if is_range(name):
            return None
        return "memcpy" if name.startswith("Memcpy") else \
            "memset" if name.startswith("Memset") else "kernel"
    if name.startswith("cuda") or (name.startswith("cu") and name[2:3].isupper()):
        return "runtime"
    if is_range(name):
        return "range"
    return None


def events_of(prof) -> list:
    """The `Event`s of a finished torch.profiler.profile, from its raw
    kineto results (building the profiler's tree of host ops would take far
    longer). A device event carries the correlation id of its launch."""
    import torch

    corr = getattr(torch._C._autograd._KinetoEvent, "correlation_id", lambda e: 0)
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = "cuda" if e.device_type() == torch.autograd.DeviceType.CUDA else "cpu"
        name = e.name()
        kind = kind_of(dev, name)
        if kind is None:
            continue
        out.append(Event(kind, name, e.start_ns(), e.end_ns(), corr(e)))
    return out


def block_span(events):
    """(start, end) of the "block" range, or None."""
    spans = [(e.start, e.end) for e in events if e.kind == "range" and e.name == "block"]
    return spans[0] if spans else None


def device_work(events, span):
    """Device events inside `span`, clipped to it, in start order."""
    lo, hi = span
    out = [e._replace(start=max(e.start, lo), end=min(e.end, hi))
           for e in events if e.kind in ("kernel", "memcpy", "memset")
           and e.end > lo and e.start < hi]
    return sorted(out, key=lambda e: (e.start, e.end))


def busy_intervals(work):
    """The union of the intervals of `work` (sorted), as merged intervals."""
    merged = []
    for e in work:
        if merged and e.start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e.end)
        else:
            merged.append([e.start, e.end])
    return merged


def launcher(events):
    """correlation id -> the runtime event that launched it."""
    return {e.corr: e for e in events if e.kind == "runtime" and e.corr}


def ranges(events):
    return [e for e in events if e.kind == "range" and e.name != "block"]


def enclosing(rngs, t):
    """The innermost range containing time t. Threads are not matched: the
    backward pass launches from autograd's device thread while the range
    that called it is open on the main thread."""
    best = None
    for r in rngs:
        if r.start <= t <= r.end:
            if best is None or r.end - r.start < best.end - best.start:
                best = r
    return best


def label(r):
    if r is None:
        return "outside_ranges"
    if r.name.startswith("k1:"):
        return "k1"
    return r.name


def attributed(events, names):
    """Device events launched inside a range whose name is in `names` (or
    inside a range nested in one), tied to their launch by correlation id."""
    launch = launcher(events)
    rngs = [r for r in ranges(events) if r.name in names]
    out = []
    for e in events:
        if e.kind not in ("kernel", "memcpy", "memset"):
            continue
        rt = launch.get(e.corr)
        if rt is not None and enclosing(rngs, rt.start) is not None:
            out.append(e)
    return out


def idle_gaps(events, span):
    """[(label, seconds)] of the device's idle time in `span`, summed by the
    benchmark range in which the host launched the work that ended each gap
    (the work still to come when the device ran dry)."""
    work = device_work(events, span)
    launch = launcher(events)
    rngs = ranges(events)
    gaps = {}
    t = span[0]
    busy = busy_intervals(work)
    firsts = {}
    for e in work:   # the first device event starting each merged interval
        firsts.setdefault(e.start, e)
    for lo, hi in busy + [[span[1], span[1]]]:
        if lo > t:
            nxt = firsts.get(lo)
            rt = launch.get(nxt.corr) if nxt is not None else None
            where = enclosing(rngs, rt.start if rt is not None else lo)
            name = label(where)
            gaps[name] = gaps.get(name, 0.0) + (lo - t) / 1e9
        t = max(t, hi)
    return sorted(gaps.items(), key=lambda kv: -kv[1])


def device_ops(events, span, top=10):
    """[(kernel name, seconds)] of the device work in `span` that took most
    time, summed by name."""
    total = {}
    for e in device_work(events, span):
        total[e.name] = total.get(e.name, 0.0) + (e.end - e.start) / 1e9
    return sorted(total.items(), key=lambda kv: -kv[1])[:top]
