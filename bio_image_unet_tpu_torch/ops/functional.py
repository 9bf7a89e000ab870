"""Pure-function primitives of the UNet++ grid, NCHW (counterpart of
``bio_image_unet_tpu/ops/functional.py:31 max_pool`` and ``:55-92
resize_linear``/``upsample_linear``).

- ``max_pool``        ≙ nn.MaxPool2d(kernel_size=2, stride=2) (floor for odd sizes)
- ``upsample_linear`` ≙ nn.Upsample(scale_factor, mode='bilinear',
                        align_corners=...) of the reference
                        (multi_output_nested_unet.py:73)

Rounding: JAX builds the ``align_corners=True`` weights ``t`` in the
activation dtype (``functional.py:81``) and blends axis by axis, so in bf16
its weights are rounded to bf16; ``F.interpolate`` blends in float32 and
rounds once.  The two agree to float32 rounding in float32 and differ by a
bf16 ulp in bf16.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def max_pool(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    """Max pooling over the spatial axes, stride = window, VALID."""
    return F.max_pool2d(x, window)


def upsample_linear(x: torch.Tensor, factor: int = 2,
                    align_corners: bool = False) -> torch.Tensor:
    """×factor bilinear upsampling of an (N, C, H, W) tensor."""
    return F.interpolate(x, scale_factor=factor, mode="bilinear",
                         align_corners=align_corners)
