"""k1_roofline: the distance kernel K1's share of its roofline in the traced
block, in %: for each launch the least time (the larger of its operations
over the fp32 peak and its bytes over the memory peak, counted from the
shapes its "k1:<n>x<m>x<d>x<points>" range names), summed, over the traced
kernels' summed durations. Layer: kernel K1."""

from oclbench import flops, trace

KERNEL = "pairwise_sqdist"


def read(run):
    if run.span is None:
        return None
    lo, hi = run.span
    launch = trace.launcher(run.events)
    k1 = [r for r in trace.ranges(run.events) if r.name.startswith("k1:")]
    least = spent = 0.0
    for e in run.events:
        if e.kind != "kernel" or KERNEL not in e.name or not lo <= e.start < hi:
            continue
        rt = launch.get(e.corr)
        r = trace.enclosing(k1, rt.start) if rt is not None else None
        if r is None:
            continue
        n, m, d, points = (int(v) for v in r.name[3:].split("x"))
        least += flops.least_seconds(*flops.sqdist_ops_bytes(n, m, d, points))
        spent += (e.end - e.start) / 1e9
    return 100.0 * least / spent if spent else None
