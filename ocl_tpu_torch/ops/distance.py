"""Pairwise squared euclidean distance: a hand-written CUDA kernel and its
plain torch version.

Replaces the Pallas TPU kernel `_kernel` of ocl_tpu/ops/pallas/distance.py
(launched by `_pairwise_sqdist_pallas`, dispatched by `pairwise_sqdist`). The
CUDA source is ocl_tpu_torch/csrc/pairwise_sqdist.cu; it computes
|a_i|^2 + |b_j|^2 - 2 a_i.b_j with fp32 accumulation (no TF32, no tensor
cores) and masks ragged edges itself. Its caller is the ASER KNN-SV scoring,
at <= 210 x 210 x 160 (about 7 MFLOP): on the H100 it is bound by launch
latency and tiny tiles, not by FLOPs or bytes.

`pairwise_sqdist` takes a CPU tensor to `pairwise_sqdist_plain` and launches
the kernel on a CUDA tensor, or raises.
"""

from __future__ import annotations

import torch


def pairwise_sqdist_plain(a, b):
    """[N, M] squared distances; the torch expression of ocl_tpu's
    `_pairwise_sqdist_jnp` (ocl_tpu/ops/pallas/distance.py:56-59)."""
    a2 = (a * a).sum(1, keepdim=True)
    b2 = (b * b).sum(1, keepdim=True)
    return a2 + b2.T - 2.0 * (a @ b.T)


def _check(a, b):
    if a.device != b.device:
        raise ValueError("pairwise_sqdist: a on {}, b on {}".format(a.device, b.device))
    if a.device.type != "cuda":
        raise ValueError("pairwise_sqdist: no kernel for device {}".format(a.device))
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError("pairwise_sqdist: float32 only, got {} and {}".format(a.dtype, b.dtype))
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError("pairwise_sqdist: 2-D inputs only, got {}-D and {}-D".format(
            a.dim(), b.dim()))
    if a.shape[1] != b.shape[1]:
        raise ValueError("pairwise_sqdist: feature dims differ, {} and {}".format(
            a.shape[1], b.shape[1]))
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("pairwise_sqdist: inputs must be contiguous")
    if max(a.shape[0], b.shape[0]) > 16 * 65535:
        raise ValueError("pairwise_sqdist: more rows than one grid holds")


def pairwise_sqdist(a, b):
    """[N, M] squared distances between the rows of a [N, D] and b [M, D].

    CPU tensors take the plain version; CUDA tensors launch the kernel on the
    current stream (counted in `pairwise_sqdist.launches`) or raise."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return pairwise_sqdist_plain(a, b)
    _check(a, b)
    n, d = a.shape
    m = b.shape[0]
    out = torch.empty((n, m), device=a.device, dtype=torch.float32)
    if n == 0 or m == 0:
        return out
    from ocl_tpu_torch.ops._build import load_library

    lib = load_library("pairwise_sqdist.cu")
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.ocl_pairwise_sqdist_f32(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                          n, m, d, stream)
    if err != 0:
        raise RuntimeError("pairwise_sqdist kernel launch failed: CUDA error {}".format(err))
    pairwise_sqdist.launches += 1
    return out


pairwise_sqdist.launches = 0
