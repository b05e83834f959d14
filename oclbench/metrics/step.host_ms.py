"""step.host_ms: host milliseconds inside each step call (host clock, no
sync), averaged over the traced run's steps outside the profiled block.
Layer: agent step."""


def read(run):
    if not run.host_step_s:
        return None
    return sum(run.host_step_s) / len(run.host_step_s) * 1e3
