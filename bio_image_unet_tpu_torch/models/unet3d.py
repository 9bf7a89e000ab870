"""The 3-level volumetric U-Nets (counterpart of
``bio_image_unet_tpu/models/unet3d.py``).

- ``UNet3D``            — channels nf/2 → nf → nf → 2nf → 2nf → 4nf, middle
                          4nf → 8nf; decoder by ``ConvTranspose3d(k2, s2)``
                          or, with ``use_interpolation``, trilinear ×2
                          (``align_corners=False``); decoder concats of
                          12nf, 6nf and 3nf; ``(sigmoid(logits), logits)``
                          (reference unet3d/unet3d.py:6-99)
- ``MultiOutputUnet3D`` — the same trunk; with ``use_interpolation`` (the
                          default) nearest ×0.5 downsampling replaces the max
                          pools and nearest ×2 + a conv block
                          (``up<i>_conv``) the transposed convs; 1×1×1 heads
                          with in-model activations, ``{head: activated
                          float32}`` (multi_output_unet3d.py:7-170)

NCDHW at the boundary.  Submodule names follow the reference schema, so
reference ``.pt`` state dicts load with ``strict=True``; ``UNet3D``'s
``final`` is a bare ``Conv3d`` (``final.*``, not ``final.0.*``:
``interop/torch_export.py:12-14``).

``dtype=torch.bfloat16`` is the Trainer's ``half_precision``, as in the 2D
models: convs, pools, resampling and concats in bf16, BatchNorm in float32
(``ConvBlock``), the 1×1×1 output convs in float32 on the features cast up.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..ops.blocks import ConvBlock, ConvTranspose3D
from ..ops.functional import downsample_nearest, max_pool, upsample_linear, upsample_nearest
from .unet2d import apply_activation


class _Trunk3D(nn.Module):
    """The encoder, middle and decoder blocks both 3D models share."""

    def __init__(self, in_channels: int, n_filter: int, use_interpolation: bool,
                 up_convs: bool, dtype: Optional[torch.dtype]):
        super().__init__()
        nf = n_filter
        self.in_channels = in_channels
        self.n_filter = n_filter
        self.use_interpolation = use_interpolation

        def block(ci, co):
            return ConvBlock(ci, co, ndim=3)

        self.encode1 = block(in_channels, nf // 2)
        self.encode2 = block(nf // 2, nf)
        self.encode3 = block(nf, nf)
        self.encode4 = block(nf, 2 * nf)
        self.encode5 = block(2 * nf, 2 * nf)
        self.encode6 = block(2 * nf, 4 * nf)
        self.middle_conv1 = block(4 * nf, 4 * nf)
        self.middle_conv2 = block(4 * nf, 8 * nf)
        ups = ((8 * nf, 8 * nf), (4 * nf, 4 * nf), (2 * nf, 2 * nf))
        for i, (ci, co) in enumerate(ups, start=1):
            if not use_interpolation:
                setattr(self, f"up{i}", ConvTranspose3D(ci, co))
            elif up_convs:
                setattr(self, f"up{i}_conv", block(ci, co))
        self.decode1 = block(12 * nf, 4 * nf)
        self.decode2 = block(4 * nf, 4 * nf)
        self.decode3 = block(6 * nf, 2 * nf)
        self.decode4 = block(2 * nf, 2 * nf)
        self.decode5 = block(3 * nf, nf)
        self.decode6 = block(nf, nf // 2)
        self.dtype = dtype

    def _set_dtype(self) -> None:
        for m in self.modules():
            if isinstance(m, (ConvBlock, ConvTranspose3D)):
                m.compute_dtype = self.dtype

    def _down(self, x: torch.Tensor) -> torch.Tensor:
        return max_pool(x)

    def _up(self, h: torch.Tensor, i: int) -> torch.Tensor:
        if not self.use_interpolation:
            return getattr(self, f"up{i}")(h)
        return upsample_linear(h)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """``decode6``'s output in the working dtype."""
        if x.shape[1] != self.in_channels:
            raise ValueError(f"expected {self.in_channels} input channels "
                             f"(NCDHW), got {x.shape[1]}")
        e2 = self.encode2(self.encode1(x))
        e4 = self.encode4(self.encode3(self._down(e2)))
        e6 = self.encode6(self.encode5(self._down(e4)))
        h = self.middle_conv2(self.middle_conv1(self._down(e6)))
        # concat order is (up, skip) (unet3d.py:81-87)
        for i, skip in zip(range(1, 4), (e6, e4, e2)):
            h = torch.cat([self._up(h, i), skip], dim=1)
            h = getattr(self, f"decode{2 * i}")(getattr(self, f"decode{2 * i - 1}")(h))
        return h


class UNet3D(_Trunk3D):
    """Volumetric segmentation U-Net (``unet3d.py:30 UNet3D``)."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1, n_filter: int = 16,
                 use_interpolation: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__(in_channels, n_filter, use_interpolation, False, dtype)
        self.out_channels = out_channels
        self.heads = None
        self.final = nn.Conv3d(n_filter // 2, out_channels, 1)
        self._set_dtype()

    def forward(self, x: torch.Tensor):
        logits = self.final(self.features(x).float())
        return torch.sigmoid(logits), logits


class MultiOutputUnet3D(_Trunk3D):
    """3D U-Net with per-head 1×1×1 outputs (``unet3d.py:93
    MultiOutputUnet3D``); without ``output_heads`` one sigmoid head
    ``default``."""

    def __init__(self, in_channels: int = 1, output_heads: Optional[Dict[str, dict]] = None,
                 n_filter: int = 16, use_interpolation: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(in_channels, n_filter, use_interpolation, True, dtype)
        self.heads = output_heads or {"default": {"channels": 1, "activation": "sigmoid"}}
        self.output_layers = nn.ModuleDict(
            {name: nn.Conv3d(n_filter // 2, cfg["channels"], 1)
             for name, cfg in self.heads.items()})
        self._set_dtype()

    def _down(self, x: torch.Tensor) -> torch.Tensor:
        return downsample_nearest(x) if self.use_interpolation else max_pool(x)

    def _up(self, h: torch.Tensor, i: int) -> torch.Tensor:
        if not self.use_interpolation:
            return getattr(self, f"up{i}")(h)
        return getattr(self, f"up{i}_conv")(upsample_nearest(h))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        h = self.features(x).float()
        return {name: apply_activation(self.output_layers[name](h), cfg.get("activation"))
                for name, cfg in self.heads.items()}
