"""The legacy 2D variants ``Unet_v0`` and ``BabyUnet`` (counterpart of
``bio_image_unet_tpu/models/legacy.py``; reference unet/unet_v0.py:5-106 and
unet/baby_unet.py:5-93).

Kept for old checkpoints: the reference's ``Predict(network='Unet_v0')``
rebuilds them.  Unlike ``Unet`` they use ReLU blocks, channel dropout 0.5 in
the bottleneck's second block only, skips from the *first* block of each
level (e1/e3/e5/e7, or e1/e3/e5 for the 3-level ``BabyUnet``), one more
conv block down to a single channel (``decode9`` / ``decode7``) and a 1×1
``final`` conv.  ``forward`` returns ``(sigmoid(logits), logits)``.

The blocks are ``Sequential(Conv2d, BatchNorm2d, ReLU, ChannelDropout2d)``
and ``final`` a ``Sequential`` around its conv, so the reference's keys
(``encode1.0.weight``, ``decode9.1.running_var``, ``final.0.bias``, ``up1.*``)
load with ``strict=True``.  The models have no compute dtype: they are
float32 always, as the JAX package's ``get_model`` drops ``dtype`` for them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.blocks import ConvTranspose

_BN_EPS = 1e-5


class ChannelDropout2d(nn.Module):
    """``Dropout2d``: in training, each (sample, channel) plane is kept with
    probability ``1 - p`` and scaled by ``1 / (1 - p)``, else zeroed, as
    flax's ``nn.Dropout(broadcast_dims=(1, 2))`` computes it
    (``where(keep, x / (1 - p), 0)``).  The draws come from ``generator``
    when one is set (the Trainer sets its own each epoch), else from torch's
    default generator of the input's device; the identity in eval.  With
    ``part = (n, i)`` the batch is share ``i`` of a global batch of ``n``
    shares (a rank of a data mesh): the global batch's mask is drawn and its
    rows kept."""

    def __init__(self, p: float = 0.5):
        super().__init__()
        self.p = float(p)
        self.generator: Optional[torch.Generator] = None
        self.part: Optional[tuple] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = 1.0 - self.p
        n, i = self.part or (1, 0)
        b = x.shape[0]
        mask = torch.empty((n * b,) + x.shape[1:2] + (1,) * (x.dim() - 2), device=x.device)
        mask = mask.bernoulli_(keep, generator=self.generator).bool()[i * b:(i + 1) * b]
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))

    def extra_repr(self) -> str:
        return f"p={self.p}"


class ReluBlock(nn.Sequential):
    """Conv(k3, padding 1) + BatchNorm(eps 1e-5) + ReLU + channel dropout:
    the legacy block (``ConvBlock(activation='relu')``, reference
    unet/unet_v0.py:56-62)."""

    def __init__(self, in_ch: int, out_ch: int, dropout: float = 0.0):
        super().__init__(nn.Conv2d(in_ch, out_ch, 3, padding=1),
                         nn.BatchNorm2d(out_ch, eps=_BN_EPS, momentum=0.1),
                         nn.ReLU(), ChannelDropout2d(dropout))


class _LegacyUnet(nn.Module):
    """``levels`` encoder levels of two ``ReluBlock``s (widths nf·2^k), a
    16·nf (8·nf) bottleneck whose second block drops channels, transposed-conv
    upsampling concatenated with the *first* block of each level (up, skip),
    then the extra 1-channel block ``decode<2·levels+1>`` and ``final``."""

    levels = 4

    def __init__(self, n_filter: int, in_channels: int = 1):
        super().__init__()
        nf, L = n_filter, self.levels
        self.n_filter = n_filter
        self.in_channels = in_channels
        ch = in_channels
        for k in range(L):
            setattr(self, f"encode{2 * k + 1}", ReluBlock(ch, nf << k))
            setattr(self, f"encode{2 * k + 2}", ReluBlock(nf << k, nf << k))
            ch = nf << k
        self.middle_conv1 = ReluBlock(ch, nf << L)
        self.middle_conv2 = ReluBlock(nf << L, nf << L, dropout=0.5)
        for i in range(1, L + 1):
            out = nf << (L - i)
            setattr(self, f"up{i}", ConvTranspose(2 * out, out))
            setattr(self, f"decode{2 * i - 1}", ReluBlock(2 * out, out))
            setattr(self, f"decode{2 * i}", ReluBlock(out, out))
        setattr(self, f"decode{2 * L + 1}", ReluBlock(nf, 1))
        self.final = nn.Sequential(nn.Conv2d(1, 1, 1))

    def forward(self, x: torch.Tensor):
        if x.shape[1] != self.in_channels:
            raise ValueError(f"expected {self.in_channels} input channels (NCHW), "
                             f"got {x.shape[1]}")
        L, skips, h = self.levels, [], x
        for k in range(1, L + 1):
            a = getattr(self, f"encode{2 * k - 1}")(h)
            skips.append(a)
            h = F.max_pool2d(getattr(self, f"encode{2 * k}")(a), 2)
        h = self.middle_conv2(self.middle_conv1(h))
        for i in range(1, L + 1):
            h = torch.cat([getattr(self, f"up{i}")(h), skips[L - i]], dim=1)
            h = getattr(self, f"decode{2 * i}")(getattr(self, f"decode{2 * i - 1}")(h))
        logits = self.final(getattr(self, f"decode{2 * L + 1}")(h))
        return torch.sigmoid(logits), logits


class Unet_v0(_LegacyUnet):
    """reference unet/unet_v0.py:5-106: 4 levels, n_filter 32 by default."""

    levels = 4

    def __init__(self, n_filter: int = 32, in_channels: int = 1):
        super().__init__(n_filter, in_channels)


class BabyUnet(_LegacyUnet):
    """reference unet/baby_unet.py:5-93: a 3-level mini U-Net, n_filter 4 by
    default."""

    levels = 3

    def __init__(self, n_filter: int = 4, in_channels: int = 1):
        super().__init__(n_filter, in_channels)
