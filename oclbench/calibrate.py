"""Readings that the correctness limits are set from, on the card at a cell's
own size (no measured window: the checked steps are set-up's):

  sound    the port's checked steps against the reference, one seed each;
  control  the reference in TF32 (the nearest precision below the
           configuration's IEEE fp32) in the port's place;
  <fault>  the port with a fault of oclbench/faults.py planted.

    python3 oclbench/calibrate.py --workload <cell> --seeds <n> ... \
        [--control-seeds <n> ...] [--faults half_batch altered_write leaf_lr] \
        [--fault-seeds <n> ...] [--out file.jsonl]

Prints one JSON line a reading and, last, each number's largest sound
reading and smallest control and fault readings.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path[0] = str(ROOT)


def reading(cell, seed, device, fault=None, control=False):
    import torch

    from oclbench import faults, harness
    from oclbench.loops import arch_of
    from oclbench.reference.replay import replay

    loop = harness.loop_for(cell, seed, device, 1.0)
    loop.setup(faults.FAULTS[fault] if fault else None)
    if loop.undo is not None:
        loop.undo()
    step_fn, record, start = loop.reference_step, loop.record, loop.start
    loop.free()
    torch.cuda.empty_cache()
    arch, cfg = arch_of(cell.config), harness.ref_cfg(cell.config)
    t0 = time.perf_counter()
    if control:
        record, _, _ = replay(step_fn, arch, cfg, start, tf32=True)
    numbers = harness.judge(step_fn, arch, cfg, start, record)
    return numbers, time.perf_counter() - t0


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--faults", nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--out")
    args = p.parse_args(argv)

    import torch

    from oclbench import spec

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    cell = spec.Cell(ROOT, spec.load(ROOT), args.workload)
    runs = [("sound", s, None, False) for s in args.seeds]
    runs += [("control", s, None, True) for s in args.control_seeds]
    runs += [(f, s, f, False) for f in args.faults for s in args.fault_seeds]
    rows = []
    out = open(args.out, "a") if args.out else None
    for what, seed, fault, control in runs:
        numbers, ref_s = reading(cell, seed, "cuda:0", fault, control)
        row = {"workload": args.workload, "what": what, "seed": seed, "ref_s": ref_s, **numbers}
        rows.append(row)
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    summary = {}
    for k in ("loss", "grad1", "change1", "change3_median", "change3_worst", "picks", "exact"):
        by = {}
        for r in rows:
            by.setdefault(r["what"], []).append(r[k])
        summary[k] = {w: (max(v) if w == "sound" else min(v)) for w, v in by.items()}
    print(json.dumps({"workload": args.workload, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
