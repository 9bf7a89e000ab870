"""The plain 2D U-Net (counterpart of ``bio_image_unet_tpu/models/unet2d.py``
``UNet2DBase`` without the attention, siamese and multi-head options, which
later slices port).

NCHW at the boundary; submodule names follow the reference schema
(``encode1..8``, ``middle_conv1/2``, ``up1..4``, ``decode1..8``, ``final.0``),
so reference ``.pt`` state dicts load with ``strict=True``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.blocks import conv_block, conv_transpose


def normalize_dilation(dilation) -> int:
    """False/None/True all mean "no dilation" (``unet2d.py:30``)."""
    return 1 if dilation in (False, None, True) else int(dilation)


class Unet(nn.Module):
    """4-level encoder / 16·nf bottleneck / transposed-conv decoder trunk.
    ``forward`` returns ``(sigmoid(logits), logits)`` with logits in float32."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 n_filter: int = 32, dilation: int = 1, dropout: float = 0.0):
        super().__init__()
        nf = n_filter
        d = normalize_dilation(dilation)
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.n_filter = n_filter
        self.dilation = d
        self.encode1 = conv_block(in_channels, nf, d, dropout)
        self.encode2 = conv_block(nf, nf, d, dropout)
        self.encode3 = conv_block(nf, 2 * nf, d, dropout)
        self.encode4 = conv_block(2 * nf, 2 * nf, d, dropout)
        self.encode5 = conv_block(2 * nf, 4 * nf, d, dropout)
        self.encode6 = conv_block(4 * nf, 4 * nf, d, dropout)
        self.encode7 = conv_block(4 * nf, 8 * nf, d, dropout)
        self.encode8 = conv_block(8 * nf, 8 * nf, d, dropout)
        self.middle_conv1 = conv_block(8 * nf, 16 * nf, d, dropout)
        self.middle_conv2 = conv_block(16 * nf, 16 * nf, d, dropout)
        # decode blocks keep dilation 1 (unet2d.py:91)
        self.up1 = conv_transpose(16 * nf, 8 * nf)
        self.decode1 = conv_block(16 * nf, 8 * nf, 1, dropout)
        self.decode2 = conv_block(8 * nf, 8 * nf, 1, dropout)
        self.up2 = conv_transpose(8 * nf, 4 * nf)
        self.decode3 = conv_block(8 * nf, 4 * nf, 1, dropout)
        self.decode4 = conv_block(4 * nf, 4 * nf, 1, dropout)
        self.up3 = conv_transpose(4 * nf, 2 * nf)
        self.decode5 = conv_block(4 * nf, 2 * nf, 1, dropout)
        self.decode6 = conv_block(2 * nf, 2 * nf, 1, dropout)
        self.up4 = conv_transpose(2 * nf, nf)
        self.decode7 = conv_block(2 * nf, nf, 1, dropout)
        self.decode8 = conv_block(nf, nf, 1, dropout)
        self.final = nn.Sequential(nn.Conv2d(nf, out_channels, 1))

    def forward(self, x: torch.Tensor):
        if x.shape[1] != self.in_channels:
            raise ValueError(f"expected {self.in_channels} input channels "
                             f"(NCHW), got {x.shape[1]}")
        e2 = self.encode2(self.encode1(x))
        e4 = self.encode4(self.encode3(F.max_pool2d(e2, 2)))
        e6 = self.encode6(self.encode5(F.max_pool2d(e4, 2)))
        e8 = self.encode8(self.encode7(F.max_pool2d(e6, 2)))
        h = self.middle_conv2(self.middle_conv1(F.max_pool2d(e8, 2)))
        # concat order is (up, skip) (unet2d.py:176)
        for i, skip in zip(range(1, 5), (e8, e6, e4, e2)):
            u = getattr(self, f"up{i}")(h)
            h = torch.cat([u, skip], dim=1)
            h = getattr(self, f"decode{2 * i}")(getattr(self, f"decode{2 * i - 1}")(h))
        logits = self.final(h).float()
        return torch.sigmoid(logits), logits
