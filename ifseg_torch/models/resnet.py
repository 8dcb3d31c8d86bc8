"""ResNet V1.5 image stem, truncated after layer3 (stride 16, 1024 channels).

Mirrors models/segofa/resnet.py (torchvision-style bottlenecks, stride on the
3x3 conv) as the JAX package's ``models/resnet.py`` computes it: the frozen
batch-norm affine is folded into each convolution, scale into the weight
(fp32, then cast to the compute dtype) and shift as the conv bias.

The public input is NHWC (B, H, W, 3) as in the JAX package; inside, the
tensors are NCHW views in channels_last memory, the layout cuDNN prefers on
the card, and the output is NHWC (B, H/16, W/16, 1024) again.

``valid_hw`` marks the top-left valid pixel region of a zero-padded input
(native-resolution evaluation).  Features outside the stage-wise
ceil-halved region are zeroed after every stage and before every 3x3
convolution, so the valid outputs equal an unpadded forward's: zeros beyond
the valid edge are exactly a convolution's zero padding at the true border,
and a max-pool window only ever adds ReLU-nonnegative zeros.  With the batch
norm folded into a convolution *bias*, the padded region of a convolution's
output is that bias and not 0, so each mask is applied after bias and ReLU,
where the JAX package applies it.
"""

from typing import Optional, Sequence

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


def _ceil2(v):
    return -(-v // 2)


def valid_mask(h: int, w: int, valid_hw, dtype, device) -> torch.Tensor:
    """(B or 1, 1, h, w) mask in ``dtype``: 1 inside the top-left ``valid_hw``
    region, 0 outside.  Each extent is an int (one region for the batch) or
    a (B,) integer tensor (one per row)."""
    vh, vw = (torch.as_tensor(v, device=device).reshape(-1, 1, 1, 1) for v in valid_hw)
    r = torch.arange(h, device=device).reshape(1, 1, h, 1)
    c = torch.arange(w, device=device).reshape(1, 1, 1, w)
    return ((r < vh) & (c < vw)).to(dtype)


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

    def forward(self, x, mask_in: Optional[torch.Tensor] = None,
                mask_out: Optional[torch.Tensor] = None):
        """``mask_in`` zeroes the padded region before the 3x3 convolution
        (its zero padding must see zeros beyond the valid edge); ``mask_out``
        zeroes it in the block's output."""
        out = F.relu(conv_bn(x, self.conv1, self.bn1))
        if mask_in is not None:
            out = out * mask_in
        out = F.relu(conv_bn(out, self.conv2, self.bn2))
        out = conv_bn(out, self.conv3, self.bn3)
        identity = x if self.downsample is None else conv_bn(x, *self.downsample)
        out = F.relu(identity + out)
        return out if mask_out is None else out * mask_out


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

    def forward(self, x, valid_hw=None):
        """x (B, H, W, 3) -> (B, H/16, W/16, 1024), in x's dtype.
        ``valid_hw = (h, w)``, ints or (B,) integer tensors: the valid pixel
        extents of a zero-padded ``x`` (see the module docstring)."""
        x = x.permute(0, 3, 1, 2)  # NCHW view, channels_last memory
        valid = None
        if valid_hw is not None:
            valid = tuple(torch.as_tensor(v, device=x.device) for v in valid_hw)

        def halve():
            """The next resolution's valid extents and mask (None unmasked);
            one mask per resolution, shared by all of its blocks."""
            nonlocal valid
            if valid is None:
                return None
            valid = tuple(_ceil2(v) for v in valid)
            return valid_mask(_ceil2(x.shape[2]), _ceil2(x.shape[3]), valid, x.dtype, x.device)

        masked = lambda y, mask: y if mask is None else y * mask
        mask = halve()
        x = masked(F.relu(conv_bn(x, self.conv1, self.bn1)), mask)
        mask = halve()
        x = masked(F.max_pool2d(x, 3, 2, 1), mask)
        for stage in (self.layer1, self.layer2, self.layer3):
            for block in stage:
                mask_in = mask
                if block.conv2.stride[0] == 2:
                    mask = halve()
                x = block(x, mask_in, mask)
        return x.permute(0, 2, 3, 1).contiguous()
