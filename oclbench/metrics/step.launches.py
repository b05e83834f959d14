"""step.launches: kernels the device ran a step in the traced block (the
block's kernel events over its steps). Layer: agent step."""


def read(run):
    if run.span is None or not run.block_steps:
        return None
    lo, hi = run.span
    n = sum(1 for e in run.events if e.kind == "kernel" and lo <= e.start < hi)
    return n / run.block_steps if n else None
