"""ResNet V1.5 image stem, truncated after layer3 (stride 16, 1024 channels).

Mirrors models/segofa/resnet.py (torchvision-style bottlenecks, stride on the
3x3 conv) as the JAX package's ``models/resnet.py`` computes it: the frozen
batch-norm affine is folded into each convolution, scale into the weight
(fp32, then cast to the compute dtype) and shift as the conv bias.

The public input is NHWC (B, H, W, 3) as in the JAX package; inside, the
tensors are NCHW views in channels_last memory, the layout cuDNN prefers on
the card, and the output is NHWC (B, H/16, W/16, 1024) again.
"""

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

RESNET_LAYERS = {
    "resnet50": (3, 4, 6),
    "resnet101": (3, 4, 23),
    "resnet152": (3, 8, 36),
}


class FrozenBN(nn.Module):
    """BatchNorm with fixed statistics and affine (frozen_bn.py:28-57); the
    four vectors are buffers under the reference names."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        # the reference initialises running_var = 1 - eps: a fresh FrozenBN is identity
        self.register_buffer("running_var", torch.ones(features) - eps)

    def scale_shift(self):
        scale = self.weight * torch.reciprocal(torch.sqrt(self.running_var + self.eps))
        return scale, self.bias - self.running_mean * scale


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)


def fold(conv: nn.Conv2d, bn: FrozenBN, dtype: torch.dtype):
    """(weight, bias) of ``bn(conv(x))`` as one convolution in ``dtype``."""
    scale, shift = bn.scale_shift()
    w = (conv.weight * scale[:, None, None, None]).to(dtype)
    return w.contiguous(memory_format=torch.channels_last), shift.to(dtype)


def conv_bn(x, conv: nn.Conv2d, bn: FrozenBN):
    """bn(conv(x)) with the folded weights: those the stem cached by
    ``ResNetStem.fold`` when their dtype matches, else folded here."""
    cached = getattr(conv, "folded", None)
    w, b = cached if cached is not None and cached[0].dtype == x.dtype else fold(conv, bn, x.dtype)
    return F.conv2d(x, w, b, conv.stride, conv.padding)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 1)
        self.bn1 = FrozenBN(planes)
        self.conv2 = _conv(planes, planes, 3, stride)
        self.bn2 = FrozenBN(planes)
        self.conv3 = _conv(planes, planes * 4, 1)
        self.bn3 = FrozenBN(planes * 4)
        self.downsample = (
            nn.Sequential(_conv(inplanes, planes * 4, 1, stride), FrozenBN(planes * 4))
            if downsample else None
        )

    def pairs(self):
        out = [(self.conv1, self.bn1), (self.conv2, self.bn2), (self.conv3, self.bn3)]
        if self.downsample is not None:
            out.append((self.downsample[0], self.downsample[1]))
        return out

    def forward(self, x):
        out = F.relu(conv_bn(x, self.conv1, self.bn1))
        out = F.relu(conv_bn(out, self.conv2, self.bn2))
        out = conv_bn(out, self.conv3, self.bn3)
        identity = x if self.downsample is None else conv_bn(x, *self.downsample)
        return F.relu(identity + out)


class ResNetStem(nn.Module):
    """conv1 -> maxpool -> layer1..layer3 (models/segofa/resnet.py:140-226)."""

    def __init__(self, layers: Sequence[int] = (3, 4, 23)):
        super().__init__()
        self.conv1 = _conv(3, 64, 7, 2)
        self.bn1 = FrozenBN(64)
        inplanes = 64
        for stage, (blocks, planes, stride) in enumerate(
            zip(layers, (64, 128, 256), (1, 2, 2)), start=1
        ):
            mods = []
            for i in range(blocks):
                mods.append(Bottleneck(inplanes, planes, stride if i == 0 else 1, i == 0))
                inplanes = planes * 4
            setattr(self, f"layer{stage}", nn.Sequential(*mods))

    def fold(self, dtype: torch.dtype):
        """Cache every conv's folded weights in ``dtype``, once (serving);
        call again after the weights or the device change."""
        pairs = [(self.conv1, self.bn1)]
        for stage in (self.layer1, self.layer2, self.layer3):
            for block in stage:
                pairs += block.pairs()
        with torch.no_grad():
            for conv, bn in pairs:
                conv.folded = fold(conv, bn, dtype)

    def forward(self, x):
        """x (B, H, W, 3) -> (B, H/16, W/16, 1024), in x's dtype."""
        x = x.permute(0, 3, 1, 2)  # NCHW view, channels_last memory
        x = F.relu(conv_bn(x, self.conv1, self.bn1))
        x = F.max_pool2d(x, 3, 2, 1)
        x = self.layer3(self.layer2(self.layer1(x)))
        return x.permute(0, 2, 3, 1).contiguous()
