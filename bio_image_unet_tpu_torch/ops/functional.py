"""Pure-function primitives of the U-Net trunks, channels first, at any
spatial rank: (N, C, H, W) or (N, C, D, H, W) (counterpart of
``bio_image_unet_tpu/ops/functional.py:31-92``).

- ``max_pool``           ≙ nn.MaxPool2d/3d(kernel_size=2, stride=2) (floor for odd sizes)
- ``upsample_nearest``   ≙ F.interpolate(scale_factor=2, mode='nearest')
- ``downsample_nearest`` ≙ F.interpolate(scale_factor=0.5, mode='nearest'):
                           every second element from 0 (``x[..., ::2, ::2(, ::2)]``)
- ``upsample_linear``    ≙ bilinear / trilinear F.interpolate with either
                           ``align_corners`` convention; the reference's UNet++
                           (multi_output_nested_unet.py:73) takes ``True``, its
                           UNet3D (unet3d.py:78-92) ``False``

Rounding: JAX builds the ``align_corners=True`` weights ``t`` in the
activation dtype (``functional.py:81``) and blends axis by axis, so in bf16
its weights are rounded to bf16; ``F.interpolate`` blends in float32 and
rounds once.  The two agree to float32 rounding in float32 and differ by a
bf16 ulp in bf16.  JAX's ``align_corners=False`` form is
``jax.image.resize(method="linear")``: half-pixel centres, edge weights
renormalised, which at ×2 is the same interpolation as torch's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_LINEAR_MODE = {4: "bilinear", 5: "trilinear"}


def max_pool(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    """Max pooling over the spatial axes, stride = window, VALID."""
    return (F.max_pool2d if x.dim() == 4 else F.max_pool3d)(x, window)


def upsample_nearest(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Nearest-neighbour ×factor upsampling of every spatial axis."""
    return F.interpolate(x, scale_factor=factor, mode="nearest")


def downsample_nearest(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Nearest-neighbour 1/factor downsampling: every ``factor``-th element
    of each spatial axis, starting at 0 (a strided view)."""
    return x[(slice(None), slice(None)) + (slice(None, None, factor),) * (x.dim() - 2)]


def upsample_linear(x: torch.Tensor, factor: int = 2,
                    align_corners: bool = False) -> torch.Tensor:
    """×factor bilinear (4-D input) or trilinear (5-D) upsampling."""
    return F.interpolate(x, scale_factor=factor, mode=_LINEAR_MODE[x.dim()],
                         align_corners=align_corners)
