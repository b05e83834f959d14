"""aser.device_ms: device milliseconds a step of the work launched inside
ASER's retrieval and update (the benchmark's "aser.retrieve" and
"aser.update" ranges around `agent.retrieve.run` and `agent.update.run`),
each kernel tied to its launch by the profiler's correlation id. Layer:
buffer strategies."""

from oclbench import trace


def read(run):
    if run.span is None or not run.block_steps:
        return None
    lo, hi = run.span
    work = [e for e in trace.attributed(run.events, {"aser.retrieve", "aser.update"})
            if lo <= e.start < hi]
    if not work:
        return None
    return sum(e.end - e.start for e in work) / 1e6 / run.block_steps
