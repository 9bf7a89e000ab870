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
- ``depthwise_xcorr``    ≙ ``functional.py:95``: K6, the ``corr`` join of
                           ``Siam_UNet`` (``csrc/depthwise_xcorr.cu``)

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

from . import _cuda

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


# --- K6 -------------------------------------------------------------------------

# shared memory a block may take (the card's 227 KB opt-in limit) and the most
# channels a block stages
_SMEM_BYTES = 232448
_MAX_GROUP = 32
_XCORR_DTYPES = (torch.float32, torch.bfloat16)


def _check_xcorr(cur: torch.Tensor, prev: torch.Tensor) -> None:
    if cur.dim() != 4 or prev.dim() != 4 or cur.shape[:2] != prev.shape[:2]:
        raise ValueError(f"depthwise_xcorr takes (B, C, H, W) and (B, C, kh, kw) with the same "
                         f"B and C, got {tuple(cur.shape)} and {tuple(prev.shape)}")
    if cur.dtype != prev.dtype or cur.dtype not in _XCORR_DTYPES:
        raise ValueError(f"depthwise_xcorr takes two float32 or two bfloat16 tensors, got "
                         f"{cur.dtype} and {prev.dtype}")


def depthwise_xcorr_plain(cur: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K6: float32 products summed over the kernel rows, then
    columns, in the kernel's order; the result in the input dtype."""
    _check_xcorr(cur, prev)
    h, w = cur.shape[2:]
    kh, kw = prev.shape[2:]
    ph, pw = (kh - 1) // 2, (kw - 1) // 2
    x = F.pad(cur.float(), (pw, kw - 1 - pw, ph, kh - 1 - ph))
    k = prev.float()
    acc = torch.zeros(cur.shape, dtype=torch.float32, device=cur.device)
    for u in range(kh):
        for v in range(kw):
            acc = acc + x[:, :, u:u + h, v:v + w] * k[:, :, u:u + 1, v:v + 1]
    return acc.to(cur.dtype)


def xcorr_group(hw: int, khw: int) -> int:
    """Channels a K6 block stages: the most (a power of two, up to 32) whose
    two float32 planes fit half the block's shared memory; 0 when not even
    one channel fits the whole of it."""
    for cg in (32, 16, 8, 4, 2):
        if cg * (hw + khw) * 4 <= _SMEM_BYTES // 2:
            return cg
    return 1 if (hw + khw) * 4 <= _SMEM_BYTES else 0


def depthwise_xcorr(cur: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """K6: correlate each (batch, channel) plane of ``cur`` (B, C, H, W) with
    the same plane of ``prev`` (B, C, kh, kw) as the kernel, torch ``'same'``
    padding ((k-1)//2 before, k//2 after) → (B, C, H, W) in ``cur``'s dtype
    and memory format (NCHW or channels_last).  On a CUDA tensor it launches
    ``csrc/depthwise_xcorr.cu`` or raises; on a CPU tensor it takes the plain
    version.  The kernel has no backward: on the card it refuses tensors
    that require a gradient (Siam training is not ported yet)."""
    _check_xcorr(cur, prev)
    if cur.device.type == "cpu" and prev.device.type == "cpu":
        return depthwise_xcorr_plain(cur, prev)
    if torch.is_grad_enabled() and (cur.requires_grad or prev.requires_grad):
        raise NotImplementedError("depthwise_xcorr has no backward on the card yet (the Siam "
                                  "training slice ports it)")
    if not (cur.is_cuda and prev.is_cuda and cur.device == prev.device):
        raise ValueError(f"depthwise_xcorr: expected two CUDA tensors on one device, got "
                         f"{cur.device} and {prev.device}")
    b, c, h, w = cur.shape
    kh, kw = prev.shape[2:]
    cg = xcorr_group(h * w, kh * kw)
    if cg == 0:
        raise ValueError(f"depthwise_xcorr: planes of {h}x{w} and {kh}x{kw} do not fit one "
                         f"block's shared memory ({_SMEM_BYTES} bytes)")
    out = torch.empty_like(cur)
    A = _cuda
    fn = A.function("depthwise_xcorr", "k6_depthwise_xcorr",
                    [A.P, A.P, A.P] + [A.I32] * 8 + [A.I64] * 12 + [A.P])
    A.launch(fn, cur.device, cur.data_ptr(), prev.data_ptr(), out.data_ptr(),
             int(cur.dtype == torch.bfloat16), b, c, h, w, kh, kw, cg,
             *cur.stride(), *prev.stride(), *out.stride())
    depthwise_xcorr.launches += 1
    return out


depthwise_xcorr.launches = 0
