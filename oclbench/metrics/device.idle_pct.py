"""device.idle_pct: the share of an unprofiled step in which the device
runs nothing, in %: one less the device's busy time a step (the union of
kernel, copy and memset intervals in the traced block, over its steps)
over the mean step interval of the traced run's steps outside the block
(CUDA events, the profiler off). The profiler slows the host, so the
block's own idle share would overstate the gaps; it stays in `device`'s
busy_s and window_s. Near 0, or below it by the profiler's few per cent on
kernel times, where the device paces the step. Layer: device."""

from oclbench import trace


def read(run):
    if run.span is None or not run.block_steps or not run.intervals_s:
        return None
    busy = sum(b - a for a, b in trace.busy_intervals(trace.device_work(run.events, run.span)))
    if not busy:
        return None
    step_s = sum(run.intervals_s) / len(run.intervals_s)
    return 100.0 * (1.0 - busy / 1e9 / run.block_steps / step_s)
