"""The yardstick's arithmetic: the chip's peaks, the operations a step's
algorithm needs, counted from shapes, and a kernel's operations and bytes.

Convolutions and matrix products count 2 FLOPs a multiply-add; the
elementwise work beside them (BatchNorm, ReLU, the loss) is left out, so
figures err low. A backward pass costs the input gradient of every layer
but the first (the images take no gradient) and the weight gradient of
every layer, each as much as the layer's forward.
"""

from __future__ import annotations

from oclbench.reference import model as M

# NVIDIA's data sheet, H100 SXM at its 700 W limit, dense
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def conv_layers(arch: dict):
    """[(multiply-adds of one image, is_first_layer)] of every convolution
    and of the linear head, in order."""
    size, nf, c = arch["image_size"], arch["nf"], arch["channels"]
    out = [(size * size * nf * c * 9, True)]
    side = size
    for _, cin, planes, stride in M.blocks(arch):
        o = (side + 1) // 2 if stride == 2 else side
        out.append((o * o * planes * cin * 9, False))
        out.append((o * o * planes * planes * 9, False))
        if stride != 1 or cin != planes:
            out.append((o * o * planes * cin, False))
        side = o
    out.append((M.feature_dim(arch) * arch["classes"], False))
    return out


def forward_flops(arch: dict, head: bool = True) -> int:
    layers = conv_layers(arch)
    if not head:
        layers = layers[:-1]
    return 2 * sum(macs for macs, _ in layers)


def backward_flops(arch: dict) -> int:
    return 2 * sum(macs * (1 if first else 2) for macs, first in conv_layers(arch))


def step_flops(arch: dict, passes, points: int = 1) -> int:
    """FLOPs of one step of `points` models: each pass of the traffic's
    `step_passes` forwards `rows` images (through the head where "head"),
    and backward too where "backward"."""
    total = 0
    for p in passes:
        f = forward_flops(arch, p.get("head", True))
        if p.get("backward"):
            f += backward_flops(arch)
        total += p["rows"] * f
    return total * points


def sqdist_ops_bytes(n: int, m: int, d: int, points: int = 1):
    """(operations, bytes) of `points` [n, d] x [m, d] -> [n, m] fp32
    squared distances: the products and the row norms, each input read once
    and the output written once."""
    ops = (2 * n * m * d + 2 * (n + m) * d) * points
    nbytes = 4 * (n * d + m * d + n * m) * points
    return ops, nbytes


def least_seconds(ops: int, nbytes: int) -> float:
    return max(ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S)
