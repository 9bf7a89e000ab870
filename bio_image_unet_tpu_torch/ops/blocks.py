"""PyTorch building blocks with the reference's state-dict schema
(counterpart of ``bio_image_unet_tpu/ops/blocks.py``).

The JAX package builds ``ConvBlock`` as flax modules in NHWC; here they are
``nn.Sequential(Conv2d, BatchNorm2d, LeakyReLU, Dropout2d)`` in NCHW, so a
reference ``.pt`` state dict (keys ``<block>.0.*`` for the conv, ``<block>.1.*``
for the BatchNorm) loads with ``load_state_dict(strict=True)``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

_BN_EPS = 1e-5
# torch's kaiming_normal_(nonlinearity='leaky_relu') default slope
_KAIMING_SLOPE = 0.01


def conv_block(in_ch: int, out_ch: int, dilation: int = 1,
               dropout: float = 0.0, negative_slope: float = 0.1) -> nn.Sequential:
    """Conv(k3, padding=dilation, dilation) + BatchNorm(eps 1e-5) +
    LeakyReLU + channel Dropout (``ops/blocks.py:107 ConvBlock``)."""
    return nn.Sequential(
        nn.Conv2d(in_ch, out_ch, 3, padding=dilation, dilation=dilation),
        nn.BatchNorm2d(out_ch, eps=_BN_EPS),
        nn.LeakyReLU(negative_slope),
        nn.Dropout2d(dropout),
    )


def conv_transpose(in_ch: int, out_ch: int) -> nn.ConvTranspose2d:
    """ConvTranspose2d(kernel 2, stride 2) upsampling
    (``ops/blocks.py:165 ConvTranspose``)."""
    return nn.ConvTranspose2d(in_ch, out_ch, 2, stride=2)


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
