"""The benchmark of ocl_tpu_torch on one H100: one run of one cell.

    python3 oclbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout. Prints, as the last line of standard
output, one JSON object (`correct`, `attempted`, `failed`, `metrics`,
`device`, with `--trace 1` `breakdown`, and last `checks`: each number the
correctness check compared, beside its limit), and the same numbers as the
last lines of standard error. Exits non-zero with no result where the card
is missing or too few, where the port cannot be imported, or where the
process has loaded JAX or the JAX package by the end of the window.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    # the checkout's root, not this folder, heads the import path: the
    # folder's modules (trace, inputs, ...) would shadow others of their name
    sys.path[0] = str(ROOT)
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "ocl_tpu"}
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton",
          "CUDA_CACHE_PATH": "cuda_cache"}


def forbidden_modules():
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (ocl_tpu_torch is not ocl_tpu)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & FORBIDDEN)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / "oclbench" / sub)
    os.environ["USE_FLAX"] = "0"

    import torch

    from oclbench import harness, spec

    cell = spec.Cell(ROOT, spec.load(ROOT), args.workload)
    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print("oclbench: {} needs {} CUDA device(s); this machine has {}".format(
            args.workload, chips, torch.cuda.device_count() if torch.cuda.is_available() else 0),
            file=sys.stderr)
        return 2
    try:
        import ocl_tpu_torch  # noqa: F401
    except ImportError as e:
        print("oclbench: the port ocl_tpu_torch cannot be imported: {}".format(e), file=sys.stderr)
        return 4
    torch.set_num_threads(2)
    torch.zeros(1, device="cuda:0")   # CUDA's context, counted with the imports
    result, checks = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                                      "cuda:0", T_START)
    found = forbidden_modules()
    if found:
        print("oclbench: the process loaded {}".format(", ".join(found)), file=sys.stderr)
        return 3
    for name, (value, limit) in checks.items():
        print("check {} {!r} limit {!r}".format(name, value, limit), file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
