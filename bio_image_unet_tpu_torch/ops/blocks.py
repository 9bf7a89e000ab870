"""PyTorch building blocks with the reference's state-dict schema
(counterpart of ``bio_image_unet_tpu/ops/blocks.py``).

The JAX package builds ``ConvBlock`` as flax modules in NHWC; here they are
``nn.Sequential(Conv2d, BatchNorm2d, LeakyReLU, Dropout2d)`` in NCHW, so a
reference ``.pt`` state dict (keys ``<block>.0.*`` for the conv, ``<block>.1.*``
for the BatchNorm) loads with ``load_state_dict(strict=True)``; the UNet++
grid's ``VGGBlock`` keeps the reference's ``conv1``/``bn1``/``conv2``/``bn2``
names.  In train mode
``BatchNorm2d(momentum=0.1, eps=1e-5)`` has the JAX ``TorchBatchNorm``
semantics: biased batch variance to normalize, unbiased ``n/(n-1)`` for the
running variance.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

_BN_EPS = 1e-5
# torch's kaiming_normal_(nonlinearity='leaky_relu') default slope
_KAIMING_SLOPE = 0.01


def conv_bn(x: torch.Tensor, conv: nn.Conv2d, bn: nn.BatchNorm2d,
            compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``bn(conv(x))``; with ``compute_dtype`` (bfloat16) the JAX blocks'
    casts (``ops/blocks.py:143-148, 266-270``): the conv on bf16 copies of
    ``x`` and of the float32 parameters, the BatchNorm on a float32 copy of
    the conv output (its statistics and running averages stay float32), the
    result back in bf16.  The casts are explicit, not left to autocast."""
    if compute_dtype is None:
        return bn(conv(x))
    dt = compute_dtype
    x = F.conv2d(x.to(dt), conv.weight.to(dt), conv.bias.to(dt),
                 padding=conv.padding, dilation=conv.dilation)
    return bn(x.float()).to(dt)


class ConvBlock(nn.Sequential):
    """Conv(k3, padding=dilation, dilation) + BatchNorm(eps 1e-5) +
    LeakyReLU + channel Dropout (``ops/blocks.py:107 ConvBlock``).

    With ``compute_dtype`` set (bfloat16, the Trainer's ``half_precision``)
    the block mirrors the JAX block's casts (:func:`conv_bn`)."""

    def __init__(self, in_ch: int, out_ch: int, dilation: int = 1,
                 dropout: float = 0.0, negative_slope: float = 0.1):
        super().__init__(
            nn.Conv2d(in_ch, out_ch, 3, padding=dilation, dilation=dilation),
            nn.BatchNorm2d(out_ch, eps=_BN_EPS, momentum=0.1),
            nn.LeakyReLU(negative_slope),
            nn.Dropout2d(dropout),
        )
        self.compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv, bn, act, drop = self
        return drop(act(conv_bn(x, conv, bn, self.compute_dtype)))


class ConvTranspose(nn.ConvTranspose2d):
    """ConvTranspose2d(kernel 2, stride 2) upsampling
    (``ops/blocks.py:165 ConvTranspose``); with ``compute_dtype`` set it runs
    on bf16 copies of input and parameters, as the JAX module does."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__(in_ch, out_ch, 2, stride=2)
        self.compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt), self.bias.to(dt), stride=2)


class VGGBlock(nn.Module):
    """Two stages of Conv3×3 (padding and dilation ``d``) + BatchNorm(eps
    1e-5) + LeakyReLU(0.1) + channel Dropout, with a middle width
    (``ops/blocks.py:243 VGGBlock``).  The attributes ``conv1``, ``bn1``,
    ``conv2``, ``bn2`` give the reference's keys (``conv<i>_<j>.conv1.weight``,
    ``…bn1.running_var``), so a reference ``.pt`` loads with ``strict=True``.

    ``compute_dtype`` (bfloat16) mirrors the JAX block's casts
    (:func:`conv_bn`) in both stages; LeakyReLU and the result in bf16."""

    def __init__(self, in_ch: int, middle_ch: int, out_ch: int, dilation: int = 1,
                 dropout: float = 0.0):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, middle_ch, 3, padding=dilation, dilation=dilation)
        self.bn1 = nn.BatchNorm2d(middle_ch, eps=_BN_EPS, momentum=0.1)
        self.conv2 = nn.Conv2d(middle_ch, out_ch, 3, padding=dilation, dilation=dilation)
        self.bn2 = nn.BatchNorm2d(out_ch, eps=_BN_EPS, momentum=0.1)
        self.act = nn.LeakyReLU(0.1)
        self.drop = nn.Dropout2d(dropout)
        self.compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x = self.drop(self.act(conv_bn(x, self.conv1, self.bn1, dt)))
        return self.drop(self.act(conv_bn(x, self.conv2, self.bn2, dt)))


def he_normal_leaky_(weight: torch.Tensor,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Kaiming-normal, fan_in, leaky_relu gain with slope 0.01, drawn from
    ``generator`` (``ops/blocks.py:32 he_normal_leaky``)."""
    fan_in = weight.shape[1] * math.prod(weight.shape[2:])
    gain = math.sqrt(2.0 / (1.0 + _KAIMING_SLOPE ** 2))
    with torch.no_grad():
        weight.normal_(0.0, gain / math.sqrt(fan_in), generator=generator)
    return weight


def init_weights_(model: nn.Module, generator: Optional[torch.Generator] = None,
                  random_bn_stats: bool = False) -> nn.Module:
    """Re-draw every weight from ``generator``: He-normal conv kernels,
    torch's default U(±1/√fan_in) biases and transposed-conv kernels.  With
    ``random_bn_stats`` the BatchNorm affine parameters and running stats are
    drawn too, so a BN fold has something to fold."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                he_normal_leaky_(m.weight, generator)
                fan_in = m.weight.shape[1] * math.prod(m.weight.shape[2:])
                if m.bias is not None:
                    b = 1.0 / math.sqrt(fan_in)
                    m.bias.uniform_(-b, b, generator=generator)
            elif isinstance(m, nn.ConvTranspose2d):
                # torch counts dim 1 of (in, out, kh, kw) as fan_in here
                fan_in = m.weight.shape[1] * math.prod(m.weight.shape[2:])
                b = 1.0 / math.sqrt(fan_in)
                m.weight.uniform_(-b, b, generator=generator)
                m.bias.uniform_(-b, b, generator=generator)
            elif isinstance(m, nn.BatchNorm2d) and random_bn_stats:
                m.weight.uniform_(0.8, 1.2, generator=generator)
                m.bias.uniform_(-0.1, 0.1, generator=generator)
                m.running_mean.normal_(0.0, 0.1, generator=generator)
                m.running_var.uniform_(0.5, 1.5, generator=generator)
    return model
