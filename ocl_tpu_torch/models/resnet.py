"""The ResNet family for online continual learning (counterpart of
ocl_tpu/models/resnet.py).

Reduced ResNet-18: BasicBlock [2,2,2,2], nf=20, bias'd linear head; feature
dim 160 at 32x32. `features` and `logits` stay separate: the ASER KNN-SV
scoring and NCM eval consume `features`. Inputs are NHWC; `features`
permutes them to NCHW. Pooled features are flattened in NHWC order, the JAX
package's, so its Dense kernel maps onto `linear` by a transpose alone
(ocl_tpu_torch/interop.py). SupConResNet (SCR's model) is the same trunk
under a projection head. ResNet18-152 are the full-width (nf 64) trunks,
ResNet50-152 of Bottleneck blocks (expansion 4); flax infers the head's
width at init, so these take the input size and size it by `pooled_cells`.

`compute_dtype` ("fp32" or "bf16") is the model's compute policy, read by
the apply helpers of models/__init__.py, which run the forward under
autocast for "bf16".
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ocl_tpu_torch.models.layers import BatchNorm, Conv1x1, Conv3x3, TorchLinear, avg_pool


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv3x3(in_planes, planes, stride)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv3x3(planes, planes)
        self.bn2 = BatchNorm(planes)
        self.has_shortcut = stride != 1 or in_planes != self.expansion * planes
        if self.has_shortcut:
            self.short_conv = Conv1x1(in_planes, self.expansion * planes, stride)
            self.short_bn = BatchNorm(self.expansion * planes)

    def forward(self, x, train: bool, w=None, fold: bool = True):
        out = F.relu(self.bn1(self.conv1(x), train, w, fold))
        out = self.bn2(self.conv2(out), train, w, fold)
        if self.has_shortcut:
            x = self.short_bn(self.short_conv(x), train, w, fold)
        return F.relu(out + x)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv1x1(in_planes, planes)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv3x3(planes, planes, stride)
        self.bn2 = BatchNorm(planes)
        self.conv3 = Conv1x1(planes, self.expansion * planes)
        self.bn3 = BatchNorm(self.expansion * planes)
        self.has_shortcut = stride != 1 or in_planes != self.expansion * planes
        if self.has_shortcut:
            self.short_conv = Conv1x1(in_planes, self.expansion * planes, stride)
            self.short_bn = BatchNorm(self.expansion * planes)

    def forward(self, x, train: bool, w=None, fold: bool = True):
        out = F.relu(self.bn1(self.conv1(x), train, w, fold))
        out = F.relu(self.bn2(self.conv2(out), train, w, fold))
        out = self.bn3(self.conv3(out), train, w, fold)
        if self.has_shortcut:
            x = self.short_bn(self.short_conv(x), train, w, fold)
        return F.relu(out + x)


_BLOCKS = {"basic": BasicBlock, "bottleneck": Bottleneck}


def pooled_cells(input_size: int, pool_window: int = 4) -> int:
    """Cells the trunk pools an input_size x input_size image to: stages 2-4
    open with a stride-2 convolution (3x3 at padding 1, or 1x1), which takes
    a side s to ceil(s / 2), and the floor-mode pooling drops the remainder
    (1 at 32 and 50 px, 4 at 84, 16 at 128, 49 at 224)."""
    side = input_size
    for _ in range(3):
        side = (side + 1) // 2
    return (side // pool_window) ** 2


class ResNet(nn.Module):
    """GEM/MIR-style ResNet trunk + linear head (reference: models/resnet.py:71-109).

    `block` is "basic" or "bottleneck". The head takes `feature_dim` inputs,
    by default the trunk's width at one pooled cell (a 32- or 50-pixel
    input)."""

    def __init__(self, num_blocks: Sequence[int], num_classes: int | None, nf: int = 20,
                 block: str = "basic", bias: bool = True, pool_window: int = 4,
                 compute_dtype: str = "fp32", in_channels: int = 3,
                 feature_dim: int | None = None):
        super().__init__()
        self.pool_window = pool_window
        self.compute_dtype = compute_dtype
        block_cls = _BLOCKS[block]
        self.conv1 = Conv3x3(in_channels, nf)
        self.bn1 = BatchNorm(nf)
        stages = []
        in_planes = nf
        for stage, (n, stride) in enumerate(zip(num_blocks, (1, 2, 2, 2))):
            planes = nf * (2 ** stage)
            blocks = []
            for i in range(n):
                blocks.append(block_cls(in_planes, planes, stride if i == 0 else 1))
                in_planes = planes * block_cls.expansion
            stages.append(nn.ModuleList(blocks))
        self.stages = nn.ModuleList(stages)
        # no head for num_classes None: SupConResNet's encoder, whose head
        # ocl_tpu never calls and so never creates
        self.linear = None if num_classes is None else \
            TorchLinear(feature_dim or in_planes, num_classes, bias=bias)

    def features(self, x, train: bool = False, w=None, fold: bool = True):
        # NHWC -> contiguous NCHW. The permuted view alone (channels_last
        # memory) crashes the CPU conv backward of PyTorch 2.13 in this trunk.
        out = x.permute(0, 3, 1, 2).contiguous()
        out = F.relu(self.bn1(self.conv1(out), train, w, fold))
        for stage in self.stages:
            for blk in stage:
                out = blk(out, train, w, fold)
        out = avg_pool(out, self.pool_window)
        return out.permute(0, 2, 3, 1).reshape(out.shape[0], -1)

    def logits(self, feats):
        return self.linear(feats)

    def forward(self, x, train: bool = False, w=None, fold: bool = True):
        return self.logits(self.features(x, train, w, fold))


def Reduced_ResNet18(nclasses, nf=20, bias=True, feature_dim=None, compute_dtype="fp32"):
    return ResNet([2, 2, 2, 2], nclasses, nf, "basic", bias, compute_dtype=compute_dtype,
                  feature_dim=feature_dim)


def _full(num_blocks, block, nclasses, nf, bias, input_size, compute_dtype):
    width = nf * 8 * _BLOCKS[block].expansion
    return ResNet(num_blocks, nclasses, nf, block, bias, compute_dtype=compute_dtype,
                  feature_dim=pooled_cells(input_size) * width)


def ResNet18(nclasses, nf=64, bias=True, input_size=32, compute_dtype="fp32"):
    return _full([2, 2, 2, 2], "basic", nclasses, nf, bias, input_size, compute_dtype)


def ResNet34(nclasses, nf=64, bias=True, input_size=32, compute_dtype="fp32"):
    return _full([3, 4, 6, 3], "basic", nclasses, nf, bias, input_size, compute_dtype)


def ResNet50(nclasses, nf=64, bias=True, input_size=32, compute_dtype="fp32"):
    return _full([3, 4, 6, 3], "bottleneck", nclasses, nf, bias, input_size, compute_dtype)


def ResNet101(nclasses, nf=64, bias=True, input_size=32, compute_dtype="fp32"):
    return _full([3, 4, 23, 3], "bottleneck", nclasses, nf, bias, input_size, compute_dtype)


def ResNet152(nclasses, nf=64, bias=True, input_size=32, compute_dtype="fp32"):
    return _full([3, 8, 36, 3], "bottleneck", nclasses, nf, bias, input_size, compute_dtype)


class SupConResNet(nn.Module):
    """Reduced ResNet-18 encoder + projection head, L2-normalised embedding
    (counterpart of ocl_tpu/models/resnet.py:138-169; reference
    models/resnet.py:140-168). `head` is "mlp" (dim_in -> dim_in, ReLU,
    -> feat_dim), "linear" (dim_in -> feat_dim) or "None" (the encoder's
    features); `features` are the encoder's features."""

    def __init__(self, dim_in: int = 160, head: str = "mlp", feat_dim: int = 128, nf: int = 20,
                 compute_dtype: str = "fp32"):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.encoder = ResNet([2, 2, 2, 2], None, nf, compute_dtype=compute_dtype)
        if head == "linear":
            layers = [TorchLinear(dim_in, feat_dim)]
        elif head == "mlp":
            layers = [TorchLinear(dim_in, dim_in), TorchLinear(dim_in, feat_dim)]
        elif head == "None":
            layers = []
        else:
            raise NotImplementedError("head not supported: {}".format(head))
        self.head_layers = nn.ModuleList(layers)

    def features(self, x, train: bool = False, w=None, fold: bool = True):
        return self.encoder.features(x, train, w, fold)

    def forward(self, x, train: bool = False, w=None, fold: bool = True):
        feat = self.features(x, train, w, fold)
        for i, layer in enumerate(self.head_layers):
            feat = layer(F.relu(feat) if i else feat)
        return feat / torch.clamp(feat.norm(dim=1, keepdim=True), min=1e-12)
