#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (ocl_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure raises and exits non-zero:
  1. device  — require CUDA; print the card and `nvidia-smi` name, power limit;
  2. build   — build the port's CUDA kernel (pairwise_sqdist) from the checkout;
  3. kernel  — the kernel against its plain torch version at the ASER shapes
               (both TF32 switches off): max relative error <= 1e-5 and max
               absolute error <= 1e-3; CUDA-event times (median of 100) of
               both; a non-contiguous input must raise;
  4. main    — ER with ASER update + retrieval through the port's CLI at the
               full width of Reduced ResNet-18 (nf 20), 5 tasks x 100 steps
               of the synthetic stream; the kernel must have launched, and
               Avg_End_Acc must be finite and above 0.5;
  5. er      — one task of plain ER (random update + retrieval, two-pass) on
               the same stream; its accuracy on that task must exceed 0.5.
Then one JSON line of kernel figures, and last the result line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import statistics
import subprocess
import sys
import time

# the ASER shapes: update N = M = 30, retrieval 10 x 20 (adversarial) and
# 20 x 20 (cooperative) on the synthetic stream; 210 x 210, 10 x 200 and
# 200 x 200 on the CIFAR-100 recipe; D = 160 at nf 20
SLICE_SHAPES = [(30, 30, 160), (10, 20, 160), (20, 20, 160), (210, 210, 160), (200, 200, 160)]
CHECK_SHAPES = SLICE_SHAPES + [(13, 37, 50), (1, 1, 1), (1000, 1000, 640)]
MAX_REL, MAX_ABS = 1e-5, 1e-3
MAIN_FLAGS = ["--device", "cuda", "--data", "synthetic", "--agent", "ER",
              "--update", "ASER", "--retrieve", "ASER", "--aser_type", "asvm",
              "--k", "3", "--n_smp_cls", "2.0", "--mem_size", "1000",
              "--eps_mem_batch", "10", "--batch", "10", "--learning_rate", "0.1",
              "--nf", "20", "--num_tasks", "5", "--synthetic_size", "500",
              "--num_runs", "1", "--matmul_precision", "highest"]


class CheckFailed(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise CheckFailed(msg)


def cuda_ms(torch, fn, reps=100, warmup=10):
    """Median over `reps` launches of fn's device time, by CUDA events."""
    for _ in range(warmup):
        fn()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(reps)]
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


class Tee(io.TextIOBase):
    """Write to the real stdout and keep a copy."""

    def __init__(self, out):
        self.out, self.buf = out, io.StringIO()

    def write(self, s):
        self.buf.write(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def main():
    import torch

    # 1. device
    require(torch.cuda.is_available(), "torch.cuda.is_available() is false: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print("[device] {} | count {} | torch {} cuda {}".format(
        kind, torch.cuda.device_count(), torch.__version__, torch.version.cuda))
    print(card)
    device = torch.device("cuda")

    # 2. build
    from ocl_tpu_torch.ops import _build
    from ocl_tpu_torch.ops.distance import pairwise_sqdist, pairwise_sqdist_plain

    t0 = time.time()
    so = _build.build("pairwise_sqdist.cu")
    _build.load_library("pairwise_sqdist.cu")
    print("[build] pairwise_sqdist {} in {:.1f} s".format(so.name, time.time() - t0))
    log = so.with_suffix(".log")
    for line in (log.read_text().splitlines() if log.exists() else []):
        if "registers" in line or "spill" in line:
            print("[build] ptxas: " + line.strip())

    # 3. kernel against plain
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device=device).manual_seed(0)
    max_abs = max_rel = 0.0
    times = {}
    for n, m, d in CHECK_SHAPES:
        a = torch.randn(n, d, device=device, generator=g)
        b = torch.randn(m, d, device=device, generator=g)
        got = pairwise_sqdist(a, b)
        torch.cuda.synchronize()
        want = pairwise_sqdist_plain(a, b)
        torch.cuda.synchronize()
        err = (got - want).abs()
        abs_err = err.max().item()
        rel_err = (err / want.abs().clamp_min(torch.finfo(torch.float32).tiny)).max().item()
        max_abs, max_rel = max(max_abs, abs_err), max(max_rel, rel_err)
        line = "[kernel] {}x{}x{}: max_abs_err {:.3e} max_rel_err {:.3e}".format(
            n, m, d, abs_err, rel_err)
        if (n, m, d) in SLICE_SHAPES:
            times[(n, m, d)] = (cuda_ms(torch, lambda: pairwise_sqdist(a, b)),
                                cuda_ms(torch, lambda: pairwise_sqdist_plain(a, b)))
            line += " | kernel {:.4f} ms plain {:.4f} ms".format(*times[(n, m, d)])
        print(line)
        require(math.isfinite(abs_err) and rel_err <= MAX_REL and abs_err <= MAX_ABS,
                "kernel disagrees with plain at {}x{}x{}".format(n, m, d))
    a = torch.randn(160, 30, device=device, generator=g)
    b = torch.randn(30, 160, device=device, generator=g)
    try:
        pairwise_sqdist(a.t(), b)
    except ValueError as e:
        print("[kernel] non-contiguous input raises: {}".format(e))
    else:
        raise CheckFailed("a non-contiguous input did not raise")

    # 4. main path: ER + ASER through the CLI
    from ocl_tpu_torch.config import build_parser
    from ocl_tpu_torch.general_main import main as cli_main

    tee = Tee(sys.stdout)
    pairwise_sqdist.launches = 0
    t0 = time.time()
    with contextlib.redirect_stdout(tee):
        result = cli_main(build_parser().parse_args(MAIN_FLAGS + ["--verbose", "False"]))
    main_s = time.time() - t0
    launches = pairwise_sqdist.launches
    avg_end_acc = float(result[0][0])
    tput = [line for line in tee.buf.getvalue().splitlines() if "stream throughput" in line]
    print("[main] ER+ASER nf 20, 5 tasks x 100 steps: Avg_End_Acc {:.4f}, pairwise_sqdist "
          "launches {}, wall {:.1f} s".format(avg_end_acc, launches, main_s))
    print("[main] " + tput[0].strip("-"))
    require(launches > 0, "the main path launched no pairwise_sqdist kernel")
    require(math.isfinite(avg_end_acc) and avg_end_acc > 0.5,
            "Avg_End_Acc {} is not above 0.5".format(avg_end_acc))

    # 5. default ER (random update + retrieval, two-pass), one task
    import numpy as np

    from ocl_tpu_torch.config import finalize
    from ocl_tpu_torch.data import continuum, prepare_test_loaders
    from ocl_tpu_torch.registry import agents

    flags = MAIN_FLAGS + ["--update", "random", "--retrieve", "random",
                          "--fused_replay", "False", "--verbose", "False"]
    params = finalize(build_parser().parse_args(flags))
    np.random.seed(params.seed)
    stream = continuum(params.data, params.cl_type, params)
    stream.new_run()
    x, y, labels = next(stream)
    agent = agents["ER"](params)
    state = agent.init_state(params.seed)
    loaders = prepare_test_loaders(stream.test_data(), params, device)
    t0 = time.time()
    state = agent.train_learner(state, x, y)
    torch.cuda.synchronize()
    er_s = time.time() - t0
    acc0 = float(agent.evaluate(state, loaders)[0])
    print("[er] random/random two-pass nf 20, task 0 ({} images, labels {}): accuracy {:.4f}, "
          "{:.1f} images/s".format(len(y), sorted(int(v) for v in labels), acc0,
                                   (len(y) // params.batch) * params.batch / er_s))
    require(math.isfinite(acc0) and acc0 > 0.5, "ER task-0 accuracy {} is not above 0.5".format(acc0))

    ms, plain_ms = times[(30, 30, 160)]
    print(json.dumps({"kernels": [{
        "name": "pairwise_sqdist", "route": "cuda",
        "source": "ocl_tpu_torch/csrc/pairwise_sqdist.cu",
        "replaces": "ocl_tpu/ops/pallas/distance.py:26",
        "launches": launches, "max_abs_err": max_abs,
        "ms": ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
