"""step.mfu: the whole step's share of the chip's fp32 peak, in %: the
FLOPs the step's algorithm needs (counted from shapes, oclbench/flops.py,
over every point) times the steps, over their time, for the traced run's
steps outside the profiled block and the step after it. Layer: model step."""

from oclbench import flops


def read(run):
    if not run.step_flops or not run.intervals_s:
        return None
    seconds = sum(run.intervals_s)
    return 100.0 * run.step_flops * len(run.intervals_s) / seconds / flops.PEAK_FP32_FLOPS
