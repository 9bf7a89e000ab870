"""The 2D U-Net trunk with a single or a multi-head output, the attention
gates and the siamese join (counterpart of
``bio_image_unet_tpu/models/unet2d.py`` ``UNet2DBase``).

- ``Unet``            — plain 4-level U-Net, ``(sigmoid, logits)`` output
- ``AttentionUnet``   — + an additive attention gate on every skip
                        (``unet2d.py:218``)
- ``Siam_UNet``       — shared-weight twin encoder over (current, previous)
                        frames, joined at the bottleneck by ``mode`` ∈
                        {concat, corr, max, control} (``unet2d.py:225``)
- ``MultiOutputUnet`` — per-head 1×1 conv outputs from ``output_heads``,
                        ``{head: activated float32}`` output

NCHW at the boundary; submodule names follow the reference schema
(``encode1..8``, ``middle_conv1/2``, ``up1..4``, ``decode1..8``, ``final.0``
or ``output_layers.<head>``, ``conv_concat`` of the ``concat`` join,
``attention1..4`` of the gates), so
reference ``.pt`` state dicts load with ``strict=True``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.blocks import AttentionBlock, ConvBlock, ConvTranspose
from ..ops.functional import depthwise_xcorr

SIAM_MODES = ("concat", "corr", "max", "control")


def normalize_dilation(dilation) -> int:
    """False/None/True all mean "no dilation" (``unet2d.py:30``)."""
    return 1 if dilation in (False, None, True) else int(dilation)


def apply_activation(x: torch.Tensor, activation: Optional[str]) -> torch.Tensor:
    """Per-head activation (``unet2d.py:38``); anything else is the identity."""
    if activation == "sigmoid":
        return torch.sigmoid(x)
    if activation == "tanh":
        return torch.tanh(x)
    if activation in ("relu", "ReLU"):
        return torch.relu(x)
    return x


class Unet(nn.Module):
    """4-level encoder / 16·nf bottleneck / transposed-conv decoder trunk.
    ``forward`` returns ``(sigmoid(logits), logits)`` with logits in float32,
    or, with heads (``output_heads``, or the default single sigmoid head when
    ``multi_output`` is set; ``unet2d.py:62-70``), ``{head: activated
    float32}`` from one 1×1 conv per head (``unet2d.py:207-211``).

    ``dtype=torch.bfloat16`` is the Trainer's ``half_precision``
    (``unet2d.py:60``): parameters stay float32, every conv, transposed conv,
    pool and concat runs in bf16, BatchNorm in float32 (``ConvBlock``), and
    the final 1×1 conv in float32 on the bf16 features cast up, as flax
    promotes a bf16 input against float32 parameters.

    ``mode`` (None, or a join of ``SIAM_MODES``) makes the trunk siamese
    (``unet2d.py:150-164``): ``forward(x, prev_x)`` encodes both frames with
    the same weights and feeds the middle block the join of their pooled
    bottlenecks — elementwise max, ``conv_concat`` (a 16·nf → 8·nf
    ``ConvBlock``) over the channel concat, the depthwise cross-correlation
    of cur with prev as its kernel, or cur's alone (``control``).  The
    skips are cur's.

    ``attention`` (``AttentionUnet``) gates every skip with an
    ``AttentionBlock`` of ``4nf, 2nf, nf, max(nf // 2, 1)`` coefficients
    (``unet2d.py:104-109``), the up path as its gate; the decoder then
    concatenates (attended skip, up) (``unet2d.py:170-201``).  In bf16 the
    gates compute in float32, as flax promotes JAX's dtype-less gate convs
    (``ops/blocks.py:212-240``): their 1×1 convs, BatchNorms, σ and ``skip·psi``
    on the bf16 skip and up path cast up exactly; the concat with the bf16 up
    path is float32, and the next ``ConvBlock`` casts it to bf16."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 n_filter: int = 32, dilation: int = 1, dropout: float = 0.0,
                 dtype: Optional[torch.dtype] = None, multi_output: bool = False,
                 output_heads: Optional[Dict[str, dict]] = None,
                 mode: Optional[str] = None, attention: bool = False):
        super().__init__()
        if mode is not None and mode not in SIAM_MODES:
            raise NotImplementedError(f"Unknown mode: {mode}")
        nf = n_filter
        d = normalize_dilation(dilation)
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.n_filter = n_filter
        self.dilation = d
        self.encode1 = ConvBlock(in_channels, nf, d, dropout)
        self.encode2 = ConvBlock(nf, nf, d, dropout)
        self.encode3 = ConvBlock(nf, 2 * nf, d, dropout)
        self.encode4 = ConvBlock(2 * nf, 2 * nf, d, dropout)
        self.encode5 = ConvBlock(2 * nf, 4 * nf, d, dropout)
        self.encode6 = ConvBlock(4 * nf, 4 * nf, d, dropout)
        self.encode7 = ConvBlock(4 * nf, 8 * nf, d, dropout)
        self.encode8 = ConvBlock(8 * nf, 8 * nf, d, dropout)
        # the concat join's block keeps dilation 1 (unet2d.py:86-87)
        self.mode = mode
        if mode == "concat":
            self.conv_concat = ConvBlock(16 * nf, 8 * nf, 1, dropout)
        self.middle_conv1 = ConvBlock(8 * nf, 16 * nf, d, dropout)
        self.middle_conv2 = ConvBlock(16 * nf, 16 * nf, d, dropout)
        # decode blocks keep dilation 1 (unet2d.py:91)
        self.up1 = ConvTranspose(16 * nf, 8 * nf)
        self.decode1 = ConvBlock(16 * nf, 8 * nf, 1, dropout)
        self.decode2 = ConvBlock(8 * nf, 8 * nf, 1, dropout)
        self.up2 = ConvTranspose(8 * nf, 4 * nf)
        self.decode3 = ConvBlock(8 * nf, 4 * nf, 1, dropout)
        self.decode4 = ConvBlock(4 * nf, 4 * nf, 1, dropout)
        self.up3 = ConvTranspose(4 * nf, 2 * nf)
        self.decode5 = ConvBlock(4 * nf, 2 * nf, 1, dropout)
        self.decode6 = ConvBlock(2 * nf, 2 * nf, 1, dropout)
        self.up4 = ConvTranspose(2 * nf, nf)
        self.decode7 = ConvBlock(2 * nf, nf, 1, dropout)
        self.decode8 = ConvBlock(nf, nf, 1, dropout)
        self.attention = bool(attention)
        if self.attention:
            for i, k in enumerate((4 * nf, 2 * nf, nf, max(nf // 2, 1)), start=1):
                ch = 8 * nf >> (i - 1)
                setattr(self, f"attention{i}", AttentionBlock(ch, ch, k))
        self.heads = (output_heads if output_heads is not None else
                      {"default": {"channels": 1, "activation": "sigmoid"}}
                      if multi_output else None)
        if self.heads is None:
            self.final = nn.Sequential(nn.Conv2d(nf, out_channels, 1))
        else:
            self.output_layers = nn.ModuleDict(
                {name: nn.Conv2d(nf, cfg["channels"], 1) for name, cfg in self.heads.items()})
        self.dtype = dtype
        for m in self.modules():
            if isinstance(m, (ConvBlock, ConvTranspose)):
                m.compute_dtype = dtype

    def encode(self, x: torch.Tensor):
        """The encoder's skips and pooled bottleneck ``(e2, e4, e6, e8, m4)``."""
        e2 = self.encode2(self.encode1(x))
        e4 = self.encode4(self.encode3(F.max_pool2d(e2, 2)))
        e6 = self.encode6(self.encode5(F.max_pool2d(e4, 2)))
        e8 = self.encode8(self.encode7(F.max_pool2d(e6, 2)))
        return e2, e4, e6, e8, F.max_pool2d(e8, 2)

    def join(self, m4: torch.Tensor, mm4: torch.Tensor) -> torch.Tensor:
        """The siamese bottleneck join of cur's ``m4`` and prev's ``mm4``."""
        if self.mode == "max":
            return torch.maximum(m4, mm4)
        if self.mode == "concat":
            return self.conv_concat(torch.cat([m4, mm4], dim=1))
        if self.mode == "corr":
            return depthwise_xcorr(m4, mm4)
        return m4  # control

    def forward(self, x: torch.Tensor, prev_x: Optional[torch.Tensor] = None):
        if x.shape[1] != self.in_channels and self.mode is None:
            raise ValueError(f"expected {self.in_channels} input channels "
                             f"(NCHW), got {x.shape[1]}")
        e2, e4, e6, e8, m4 = self.encode(x)
        if self.mode is not None:
            if prev_x is None:
                raise ValueError("Siam mode requires prev_x")
            m4 = self.join(m4, self.encode(prev_x)[-1])
        h = self.middle_conv2(self.middle_conv1(m4))
        # concat order is (up, skip), (attended skip, up) with the gates
        # (unet2d.py:170-201)
        for i, skip in zip(range(1, 5), (e8, e6, e4, e2)):
            u = getattr(self, f"up{i}")(h)
            if self.attention:
                # a float32 gate (bf16 inputs cast up); cat promotes u to it
                gate = getattr(self, f"attention{i}")(u.float(), skip.float())
                h = torch.cat([gate, u], dim=1)
            else:
                h = torch.cat([u, skip], dim=1)
            h = getattr(self, f"decode{2 * i}")(getattr(self, f"decode{2 * i - 1}")(h))
        if self.heads is None:
            logits = self.final(h.float())
            return torch.sigmoid(logits), logits
        return {name: apply_activation(self.output_layers[name](h.float()), cfg.get("activation"))
                for name, cfg in self.heads.items()}


class AttentionUnet(Unet):
    """U-Net with additive attention gates on each skip (``unet2d.py:218``,
    reference unet/attention_unet.py:5-181); ``forward(x)`` returns
    ``(sigmoid(logits), logits)``, or the head dict with ``output_heads``."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 n_filter: int = 32, dilation: int = 1, dropout: float = 0.0,
                 dtype: Optional[torch.dtype] = None, multi_output: bool = False,
                 output_heads: Optional[Dict[str, dict]] = None):
        super().__init__(in_channels, out_channels, n_filter, dilation, dropout, dtype,
                         multi_output, output_heads, attention=True)


class Siam_UNet(Unet):
    """Siamese U-Net (``unet2d.py:225``, reference siam_unet/siam_unet.py):
    shared-weight twin encoder over (current, previous) frames with the
    bottleneck join ``mode`` ∈ {concat, corr, max, control}, ``concat`` by
    default as in the JAX class.  Fixed 1-in/1-out; ``forward(x, prev_x)``
    returns ``(sigmoid(logits), logits)``."""

    def __init__(self, n_filter: int = 32, mode: str = "concat", dilation: int = 1,
                 dropout: float = 0.0, dtype: Optional[torch.dtype] = None):
        super().__init__(1, 1, n_filter, dilation, dropout, dtype, mode=mode)


class MultiOutputUnet(Unet):
    """The U-Net trunk with per-head 1×1 conv outputs and in-model
    activations (``unet2d.py:233 MultiOutputUnet``)."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 n_filter: int = 32, dilation: int = 1, dropout: float = 0.0,
                 dtype: Optional[torch.dtype] = None, multi_output: bool = True,
                 output_heads: Optional[Dict[str, dict]] = None):
        super().__init__(in_channels, out_channels, n_filter, dilation, dropout, dtype,
                         multi_output, output_heads)
