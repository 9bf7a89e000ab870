"""PyTorch building blocks with the reference's state-dict schema
(counterpart of ``bio_image_unet_tpu/ops/blocks.py``).

The JAX package builds ``ConvBlock`` as flax modules in NHWC (NDHWC in 3D,
the rank taken from the input); here they are ``nn.Sequential(Conv2d,
BatchNorm2d, LeakyReLU, Dropout2d)`` in NCHW, or with ``ndim=3`` the
``Conv3d``/``BatchNorm3d``/``Dropout3d`` block in NCDHW, so a reference
``.pt`` state dict (keys ``<block>.0.*`` for the conv, ``<block>.1.*`` for the
BatchNorm) loads with ``load_state_dict(strict=True)``; the UNet++
grid's ``VGGBlock`` keeps the reference's ``conv1``/``bn1``/``conv2``/``bn2``
names and the ``AttentionBlock`` gate its ``W_gate``/``W_x``/``psi``.  In train mode
``BatchNorm2d/3d(momentum=0.1, eps=1e-5)`` has the JAX ``TorchBatchNorm``
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


def conv_bn(x: torch.Tensor, conv: nn.Module, bn: nn.Module,
            compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``bn(conv(x))``; with ``compute_dtype`` (bfloat16) the JAX blocks'
    casts (``ops/blocks.py:143-148, 266-270``): the conv on bf16 copies of
    ``x`` and of the float32 parameters, the BatchNorm on a float32 copy of
    the conv output (its statistics and running averages stay float32), the
    result back in bf16.  The casts are explicit, not left to autocast."""
    if compute_dtype is None:
        return bn(conv(x))
    dt = compute_dtype
    conv_fn = F.conv2d if conv.weight.dim() == 4 else F.conv3d
    x = conv_fn(x.to(dt), conv.weight.to(dt), conv.bias.to(dt),
                padding=conv.padding, dilation=conv.dilation)
    return bn(x.float()).to(dt)


_LAYERS = {2: (nn.Conv2d, nn.BatchNorm2d, nn.Dropout2d),
           3: (nn.Conv3d, nn.BatchNorm3d, nn.Dropout3d)}


class ConvBlock(nn.Sequential):
    """Conv(k3, padding=dilation, dilation) + BatchNorm(eps 1e-5) +
    LeakyReLU + channel Dropout (``ops/blocks.py:107 ConvBlock``), 2D or,
    with ``ndim=3``, 3D (the reference's ``conv3D`` block,
    unet3d/unet3d.py:52-58).

    With ``compute_dtype`` set (bfloat16, the Trainer's ``half_precision``)
    the block mirrors the JAX block's casts (:func:`conv_bn`)."""

    def __init__(self, in_ch: int, out_ch: int, dilation: int = 1,
                 dropout: float = 0.0, negative_slope: float = 0.1, ndim: int = 2):
        conv, bn, drop = _LAYERS[ndim]
        super().__init__(
            conv(in_ch, out_ch, 3, padding=dilation, dilation=dilation),
            bn(out_ch, eps=_BN_EPS, momentum=0.1),
            nn.LeakyReLU(negative_slope),
            drop(dropout),
        )
        self.compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv, bn, act, drop = self
        return drop(act(conv_bn(x, conv, bn, self.compute_dtype)))


class _CastTranspose:
    """The forward of the kernel-2 stride-2 transposed convs: with
    ``compute_dtype`` set it runs on bf16 copies of input and parameters, as
    the JAX module does."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        fn = F.conv_transpose2d if x.dim() == 4 else F.conv_transpose3d
        return fn(x.to(dt), self.weight.to(dt), self.bias.to(dt), stride=2)


class ConvTranspose(_CastTranspose, nn.ConvTranspose2d):
    """ConvTranspose2d(kernel 2, stride 2) upsampling
    (``ops/blocks.py:165 ConvTranspose``)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__(in_ch, out_ch, 2, stride=2)


class ConvTranspose3D(_CastTranspose, nn.ConvTranspose3d):
    """ConvTranspose3d(kernel 2, stride 2) upsampling, the 3D form of
    ``ops/blocks.py:165 ConvTranspose`` (reference unet3d/unet3d.py:61-63)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__(in_ch, out_ch, 2, stride=2)


# AttentionBlock's three 1×1 conv + BatchNorm pairs, by attribute name
GATES = ("W_gate", "W_x", "psi")


class AttentionBlock(nn.Module):
    """Additive attention gate (``ops/blocks.py:212 AttentionBlock``,
    reference unet/attention_unet.py:112-181): ``psi = σ(BN(1×1(relu(BN(1×1(
    gate)) + BN(1×1(skip))))))``, returns ``skip·psi``.  ``W_gate``, ``W_x``
    and ``psi`` are ``Sequential(Conv2d 1×1, BatchNorm2d[, Sigmoid])`` with
    the reference's keys (``W_gate.0.weight``, ``psi.1.running_var``, …), so
    a reference ``.pt`` loads with ``strict=True``."""

    def __init__(self, gate_ch: int, skip_ch: int, n_coefficients: int):
        super().__init__()
        self.W_gate = nn.Sequential(nn.Conv2d(gate_ch, n_coefficients, 1),
                                    nn.BatchNorm2d(n_coefficients, eps=_BN_EPS, momentum=0.1))
        self.W_x = nn.Sequential(nn.Conv2d(skip_ch, n_coefficients, 1),
                                 nn.BatchNorm2d(n_coefficients, eps=_BN_EPS, momentum=0.1))
        self.psi = nn.Sequential(nn.Conv2d(n_coefficients, 1, 1),
                                 nn.BatchNorm2d(1, eps=_BN_EPS, momentum=0.1), nn.Sigmoid())

    def forward(self, gate: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        psi = self.psi(torch.relu(self.W_gate(gate) + self.W_x(skip)))
        return skip * psi


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
    """Re-draw every weight from ``generator`` (2D and 3D layers alike):
    He-normal conv kernels, torch's default U(±1/√fan_in) biases and
    transposed-conv kernels.  With ``random_bn_stats`` the BatchNorm affine
    parameters and running stats are drawn too, so a BN fold has something
    to fold."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Conv3d)):
                he_normal_leaky_(m.weight, generator)
                fan_in = m.weight.shape[1] * math.prod(m.weight.shape[2:])
                if m.bias is not None:
                    b = 1.0 / math.sqrt(fan_in)
                    m.bias.uniform_(-b, b, generator=generator)
            elif isinstance(m, (nn.ConvTranspose2d, nn.ConvTranspose3d)):
                # torch counts dim 1 of (in, out, *k) as fan_in here
                fan_in = m.weight.shape[1] * math.prod(m.weight.shape[2:])
                b = 1.0 / math.sqrt(fan_in)
                m.weight.uniform_(-b, b, generator=generator)
                m.bias.uniform_(-b, b, generator=generator)
            elif isinstance(m, (nn.BatchNorm2d, nn.BatchNorm3d)) and random_bn_stats:
                m.weight.uniform_(0.8, 1.2, generator=generator)
                m.bias.uniform_(-0.1, 0.1, generator=generator)
                m.running_mean.normal_(0.0, 0.1, generator=generator)
                m.running_var.uniform_(0.5, 1.5, generator=generator)
    return model
