"""Reduced ResNet-18 in plain PyTorch: the benchmark's reference model.

The architecture of Lopez-Paz and Ranzato's GEM code as the online continual
learning survey (Mai et al., arXiv:2101.10423) and ASER (Shim et al.,
arXiv:2009.00093) run it: BasicBlocks [2, 2, 2, 2] at widths nf, 2nf, 4nf,
8nf, a 4 x 4 average pool and a biased linear head. BatchNorm follows
torch's BatchNorm2d (biased variance to normalise, unbiased into the running
variance, momentum 0.1, eps 1e-5), with one addition the fixed-shape replay
batches need: a row weight `w` that leaves masked rows out of the batch
statistics, a batch whose weights are all zero folding nothing and
normalising with the running statistics.

Images are NHWC floats; the pooled features are flattened in NHWC order, so
the head's input order is (cell, channel). Parameters live in a dict keyed
by the names `leaves` gives, beside a dict of BN running statistics; nothing
here holds state of its own. Imports torch alone.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

MOMENTUM, EPS = 0.1, 1e-5
STAGES = (2, 2, 2, 2)
POOL = 4


def side_after_trunk(size: int) -> int:
    """Side of the last stage's map: stages 2-4 halve it, rounding up."""
    for _ in range(3):
        size = (size + 1) // 2
    return size


def feature_dim(arch: dict) -> int:
    cells = (side_after_trunk(arch["image_size"]) // POOL) ** 2
    return cells * arch["nf"] * 8


def blocks(arch: dict):
    """(prefix, in_planes, planes, stride) of every BasicBlock in order."""
    nf, in_planes = arch["nf"], arch["nf"]
    for s, n in enumerate(STAGES):
        planes = nf * 2 ** s
        for b in range(n):
            stride = (1, 2, 2, 2)[s] if b == 0 else 1
            yield "stages.{}.{}.".format(s, b), in_planes, planes, stride
            in_planes = planes


def leaves(arch: dict):
    """[(name, shape, kind, fan_in)] of every parameter, kind "conv",
    "linear", "bias" (the head's, drawn like its weight), "bn_weight" or
    "bn_bias"."""
    out = []

    def conv(name, cin, cout, k):
        out.append((name + ".weight", (cout, cin, k, k), "conv", cin * k * k))

    def bn(name, c):
        out.append((name + ".weight", (c,), "bn_weight", 0))
        out.append((name + ".bias", (c,), "bn_bias", 0))

    conv("conv1", arch["channels"], arch["nf"], 3)
    bn("bn1", arch["nf"])
    for prefix, cin, planes, stride in blocks(arch):
        conv(prefix + "conv1", cin, planes, 3)
        bn(prefix + "bn1", planes)
        conv(prefix + "conv2", planes, planes, 3)
        bn(prefix + "bn2", planes)
        if stride != 1 or cin != planes:
            conv(prefix + "short_conv", cin, planes, 1)
            bn(prefix + "short_bn", planes)
    fd = feature_dim(arch)
    out.append(("linear.weight", (arch["classes"], fd), "linear", fd))
    out.append(("linear.bias", (arch["classes"],), "bias", fd))
    return out


def init_running(arch: dict, device) -> dict:
    """BN running statistics at their start: mean 0, variance 1."""
    stats = {}
    for name, shape, kind, _ in leaves(arch):
        if kind == "bn_weight":
            layer = name[: -len(".weight")]
            stats[layer + ".running_mean"] = torch.zeros(shape, device=device)
            stats[layer + ".running_var"] = torch.ones(shape, device=device)
    return stats


def weights_from_uniform(arch: dict, u: torch.Tensor) -> dict:
    """Parameters from `u`, one uniform draw in [0, 1) per random element in
    `leaves` order: conv and linear weights and the head's bias
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (torch's default init), BN scales 1
    and shifts 0."""
    params, at = {}, 0
    for name, shape, kind, fan_in in leaves(arch):
        if kind == "bn_weight":
            params[name] = torch.ones(shape, device=u.device)
        elif kind == "bn_bias":
            params[name] = torch.zeros(shape, device=u.device)
        else:
            n = math.prod(shape)
            bound = 1.0 / math.sqrt(fan_in)
            params[name] = (u[at: at + n] * (2 * bound) - bound).reshape(shape)
            at += n
    return params


def random_elements(arch: dict) -> int:
    return sum(math.prod(s) for _, s, kind, _ in leaves(arch) if kind not in ("bn_weight", "bn_bias"))


def batch_norm(x, weight, bias, stats, name, train, w=None, fold=True):
    xf = x.float()
    rm, rv = stats[name + ".running_mean"], stats[name + ".running_var"]
    if train:
        dims = (0, 2, 3)
        empty = None
        if w is None:
            n = float(x.numel() // x.shape[1])
            mean = xf.mean(dims)
            var = (xf - mean[:, None, None]).square().mean(dims)
        else:
            spatial = x.shape[2] * x.shape[3]
            wf = w.float().reshape(-1, 1, 1, 1)
            tot = torch.cat([(wf.sum() * spatial).reshape(1), (xf * wf).sum(dims)])
            empty = tot[0] == 0
            n = torch.clamp(tot[0], min=1.0)
            mean = tot[1:] / n
            var = ((xf - mean[:, None, None]).square() * wf).sum(dims) / n
        if fold:
            with torch.no_grad():
                if isinstance(n, float):
                    unbiased = var * (n / max(n - 1.0, 1.0))
                else:
                    unbiased = var * (n / torch.clamp(n - 1.0, min=1.0))
                new_mean = (1.0 - MOMENTUM) * rm + MOMENTUM * mean
                new_var = (1.0 - MOMENTUM) * rv + MOMENTUM * unbiased
                if empty is not None:
                    new_mean = torch.where(empty, rm, new_mean)
                    new_var = torch.where(empty, rv, new_var)
                stats[name + ".running_mean"] = new_mean
                stats[name + ".running_var"] = new_var
        if empty is not None:
            mean = torch.where(empty, rm, mean)
            var = torch.where(empty, rv, var)
    else:
        mean, var = rm, rv
    inv = torch.rsqrt(var + EPS) * weight.float()
    return (xf - mean[:, None, None]) * inv[:, None, None] + bias.float()[:, None, None]


def features(params, stats, x, arch, train=False, w=None, fold=True):
    """Pooled trunk features [B, feature_dim] of NHWC images `x`. A
    train-mode call folds the batch statistics into `stats` (replacing its
    tensors) unless `fold` is False."""
    def bn(t, name):
        return batch_norm(t, params[name + ".weight"], params[name + ".bias"], stats, name,
                          train, w, fold)

    out = x.permute(0, 3, 1, 2).contiguous()
    out = F.relu(bn(F.conv2d(out, params["conv1.weight"], padding=1), "bn1"))
    for prefix, cin, planes, stride in blocks(arch):
        h = F.relu(bn(F.conv2d(out, params[prefix + "conv1.weight"], stride=stride, padding=1),
                      prefix + "bn1"))
        h = bn(F.conv2d(h, params[prefix + "conv2.weight"], padding=1), prefix + "bn2")
        if stride != 1 or cin != planes:
            out = bn(F.conv2d(out, params[prefix + "short_conv.weight"], stride=stride),
                     prefix + "short_bn")
        out = F.relu(h + out)
    out = F.avg_pool2d(out, POOL)
    return out.permute(0, 2, 3, 1).reshape(out.shape[0], -1)


def logits(params, stats, x, arch, train=False, w=None, fold=True):
    f = features(params, stats, x, arch, train, w, fold)
    return F.linear(f, params["linear.weight"], params["linear.bias"])


def masked_ce(logit, labels, mask=None):
    """Mean cross-entropy over the rows where `mask` (all rows if None)."""
    v = -F.log_softmax(logit, dim=-1).gather(1, labels[:, None].long())[:, 0]
    if mask is None:
        return v.mean()
    m = mask.to(v.dtype)
    return (v * m).sum() / torch.clamp(m.sum(), min=1.0)
