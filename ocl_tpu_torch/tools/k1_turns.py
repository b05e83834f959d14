"""pairwise_sqdist (K1) against an earlier version of its kernel, in turns on
one card, by device time (CUDA graph replay) at the ASER shapes.

    git show <commit>:ocl_tpu_torch/csrc/pairwise_sqdist.cu > build/k1_old.cu
    python3 -m ocl_tpu_torch.tools.k1_turns --old build/k1_old.cu [--out FILE.json]

The earlier source's C entry is `int ocl_pairwise_sqdist_f32(a, b, out, int n,
int m, int d, stream)`; it is built with the port's nvcc flags under another
library name. Per shape the order is plain, old, new, new, old, plain, so that
a drift of the card over the run falls on both sides. Both kernels are first
held against the plain version (<= 1e-5 relative, <= 1e-3 absolute). Needs
one CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
from pathlib import Path

import torch

from ocl_tpu_torch.ops import _build
from ocl_tpu_torch.ops.distance import pairwise_sqdist, pairwise_sqdist_plain
from ocl_tpu_torch.tools import kernel_timing as kt

SHAPES = [(30, 30, 160), (10, 20, 160), (20, 20, 160),
          (210, 210, 160), (10, 200, 160), (200, 200, 160)]
ORDER = ["plain", "old", "new", "new", "old", "plain"]
MAX_REL, MAX_ABS = 1e-5, 1e-3


def old_kernel(source: Path):
    """The earlier kernel, built from `source`, as fn(a, b) -> out."""
    text = source.read_bytes()
    so = _build.BUILD_DIR / "libpairwise_sqdist_old_{}.so".format(
        hashlib.sha256(text).hexdigest()[:16])
    if not so.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(source)],
                       check=True)
    entry = ctypes.CDLL(str(so)).ocl_pairwise_sqdist_f32
    entry.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    entry.restype = ctypes.c_int

    def call(a, b):
        out = torch.empty((a.shape[0], b.shape[0]), device=a.device)
        err = entry(a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[0], b.shape[0],
                    a.shape[1], torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError("old kernel: CUDA error {}".format(err))
        return out
    return call


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True, type=Path, help="an earlier pairwise_sqdist.cu")
    ap.add_argument("--out", type=Path, default=None, help="write the figures here as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k1_turns: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    old = old_kernel(args.old)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card)
    g = torch.Generator(device="cuda").manual_seed(2)
    floor = kt.device_ms(torch.zeros(1, device="cuda").zero_)
    rows = []
    for n, m, d in SHAPES:
        a = torch.randn(n, d, device="cuda", generator=g)
        b = torch.randn(m, d, device="cuda", generator=g)
        fns = {"plain": lambda: pairwise_sqdist_plain(a, b), "old": lambda: old(a, b),
               "new": lambda: pairwise_sqdist(a, b)}
        want = pairwise_sqdist_plain(a, b)
        for k in ("old", "new"):
            err = (fns[k]() - want).abs()
            e_abs, e_rel = err.max().item(), (err / want.abs().clamp_min(1e-30)).max().item()
            if not (e_abs <= MAX_ABS and e_rel <= MAX_REL):
                raise SystemExit("k1_turns: {} disagrees with plain at {}x{}x{}: abs {} rel {}"
                                 .format(k, n, m, d, e_abs, e_rel))
        times = {k: [] for k in fns}
        for k in ORDER:
            times[k].append(kt.device_ms(fns[k]))
        bound_ms, bound_by = kt.sqdist_bound(n, m, d)
        rows.append({"shape": [n, m, d], "times_ms": times, "floor_ms": floor,
                     "bound_ms": bound_ms, "bound_by": bound_by})
        print("{}x{}x{}: device ms in turns ({}) | {} | floor {:.5f} bound {:.2e} ({})".format(
            n, m, d, ", ".join(ORDER),
            " ".join("{} {}".format(k, "/".join("{:.5f}".format(t) for t in v))
                     for k, v in times.items()),
            floor, bound_ms, bound_by))
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "device": torch.cuda.get_device_name(0),
                                        "shapes": rows}, indent=1))


if __name__ == "__main__":
    main()
