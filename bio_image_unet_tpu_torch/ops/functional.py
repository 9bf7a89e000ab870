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
                           ``Siam_UNet`` (``csrc/depthwise_xcorr.cu``), with
                           its backward: K6b, ``depthwise_xcorr_grad_input``
                           and ``depthwise_xcorr_grad_kernel`` (what
                           ``jax.grad`` takes of the grouped conv)

Rounding: JAX builds the ``align_corners=True`` weights ``t`` in the
activation dtype (``functional.py:81``) and blends axis by axis, so in bf16
its weights are rounded to bf16; ``F.interpolate`` blends in float32 and
rounds once.  The two agree to float32 rounding in float32 and differ by a
bf16 ulp in bf16.  JAX's ``align_corners=False`` form is
``jax.image.resize(method="linear")``: half-pixel centres, edge weights
renormalised, which at ×2 is the same interpolation as torch's.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

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

# shared memory a block may take (the card's 227 KB opt-in limit), and what
# of it the tiled kernel's staging may take (less its static arrays)
_SMEM_OPTIN = 232448
_SMEM_BYTES = _SMEM_OPTIN - 1024
_XCORR_DTYPES = (torch.float32, torch.bfloat16)
# a K6 thread's outputs (rows × columns of one plane) and a block's threads:
# the constants of csrc/depthwise_xcorr.cu
XCORR_R, XCORR_S, XCORR_THREADS = 4, 4, 512


class XcorrGeometry(NamedTuple):
    """How K6 stages and walks a (h, w) plane with a (kh, kw) kernel: every
    length in float32 elements, ``smem`` in bytes (see the kernel's notes)."""
    cg: int      # planes a block stages (a power of two)
    n: int       # tiles a warp takes side by side in one tile row: 32 // cg
    tpr: int     # tile columns of a plane, a multiple of n (the last may be past w)
    tiles: int   # tiles of a plane: tile rows × tpr
    pad_t: int   # zero rows staged above the plane (as many below)
    pad_l: int   # zero columns staged left of it (pad_l ≡ (kw - 1) // 2 mod 4)
    xp: int      # a staged plane's row pitch, a multiple of 4
    xplane: int  # between two staged planes: 4 mod 32 (no bank conflicts)
    kwp: int     # a staged kernel's row pitch: kw rounded up to 4, zeros past kw
    kplane: int  # between two staged kernels (in the input type): 4 mod 128 bytes' worth
    threads: int
    smem: int


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _bank_stride(v: int, per_128: int = 32) -> int:
    """The least stride ≥ v that is 4 mod ``per_128`` elements (those of 128
    bytes): the lanes of a 16-byte (8-byte) shared-memory access that read
    the same offset of consecutive planes then hit different banks."""
    return v + (4 - v) % per_128


def xcorr_geometry(h: int, w: int, kh: int, kw: int,
                   kbytes: int = 4) -> Optional[XcorrGeometry]:
    """K6's staging for (h, w) planes and (kh, kw) kernels of ``kbytes``
    bytes an element (4: float32, 2: bf16, staged as such): the most planes
    a block (32, 16, ..., 1) whose zero-haloed float32 planes and kernels fit
    its shared memory; None when not even one does (planes above ~112² with
    kernels as large: the wrapper then takes the plane form,
    ``xcorr_plane_fits``).

    A warp takes ``cg`` planes × ``n`` tiles of one tile row (its region, R
    rows × n·S columns); the tap range it walks is the region's (rows
    exact, columns rounded out to 4), so every tap it skips lies on the zero
    pad for all the region's outputs, and the halo holds what the region
    reads past the plane: R - 1 rows above and below, n·S + 2..5 columns
    left and n·S + 3 right."""
    r, s = XCORR_R, XCORR_S
    pw = (kw - 1) // 2
    for cg in (32, 16, 8, 4, 2, 1):
        n = 32 // cg
        tpr = _round_up(-(-w // s), n)
        sw = n * s
        pad_l = sw + 2 + (pw - sw - 2) % 4
        xp = _round_up(pad_l + w + sw - s + 7, 4)
        xplane = _bank_stride((h + 2 * (r - 1)) * xp)
        kwp = _round_up(kw, 4)
        kplane = _bank_stride(kh * kwp, 128 // kbytes)
        smem = _round_up(cg * (4 * xplane + kbytes * kplane), 16)
        if smem <= _SMEM_BYTES:
            tiles = -(-h // r) * tpr
            return XcorrGeometry(cg, n, tpr, tiles, r - 1, pad_l, xp, xplane, kwp, kplane,
                                 min(XCORR_THREADS, cg * tiles), smem)
    return None


def xcorr_plane_fits(h: int, w: int, kh: int, kw: int) -> bool:
    """Whether K6's plane form (one block a plane, for planes whose haloed
    staging ``xcorr_geometry`` refuses) takes (h, w) planes with (kh, kw)
    kernels: the plane and its kernel in float32, without a halo, within a
    block's shared memory."""
    return 4 * (h * w + kh * kw) <= _SMEM_OPTIN


def xcorr_stage_vector(t: torch.Tensor, cg: int) -> int:
    """Elements one staging load of K6 moves from ``t`` (B, C, h, w): a
    16-byte vector where the fastest axis (channels of a channels_last
    tensor, else the row) is contiguous, a block's run of ``cg`` channels or
    a row fills whole vectors, and every vector is 16-byte aligned; else 1."""
    v = 16 // t.element_size()
    sb, sc, sh, sw = t.stride()
    if t.data_ptr() % 16:
        return 1
    if sc < sw:  # the kernel stages a pixel's channels together
        ok = sc == 1 and t.shape[1] % cg == 0 and cg % v == 0
        strides = (sb, sh, sw)
    else:  # a row's columns
        ok = sw == 1 and t.shape[3] % v == 0
        strides = (sb, sc, sh)
    return v if ok and all(x % v == 0 for x in strides) else 1


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


def _xcorr_forward(cur: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """K6 on checked tensors: the plain version on the CPU, else a launch."""
    if cur.device.type == "cpu" and prev.device.type == "cpu":
        return depthwise_xcorr_plain(cur, prev)
    if not (cur.is_cuda and prev.is_cuda and cur.device == prev.device):
        raise ValueError(f"depthwise_xcorr: expected two CUDA tensors on one device, got "
                         f"{cur.device} and {prev.device}")
    b, c, h, w = cur.shape
    kh, kw = prev.shape[2:]
    geo = xcorr_geometry(h, w, kh, kw, cur.element_size())
    if geo is None and not xcorr_plane_fits(h, w, kh, kw):
        raise ValueError(f"depthwise_xcorr: planes of {h}x{w} and {kh}x{kw} do not fit one "
                         f"block's shared memory ({_SMEM_OPTIN} bytes)")
    out = torch.empty_like(cur)
    A = _cuda
    args = (cur.data_ptr(), prev.data_ptr(), out.data_ptr(), int(cur.dtype == torch.bfloat16),
            b, c, h, w, kh, kw)
    strides = (*cur.stride(), *prev.stride(), *out.stride())
    if geo is None:  # large planes: the plane form
        fn = A.function("depthwise_xcorr", "k6_depthwise_xcorr_plane",
                        [A.P, A.P, A.P] + [A.I32] * 7 + [A.I64] * 12 + [A.P])
        A.launch(fn, cur.device, *args, *strides)
    else:
        fn = A.function("depthwise_xcorr", "k6_depthwise_xcorr",
                        [A.P, A.P, A.P] + [A.I32] * 21 + [A.I64] * 12 + [A.P])
        A.launch(fn, cur.device, *args, *geo, xcorr_stage_vector(cur, geo.cg),
                 xcorr_stage_vector(prev, geo.cg), *strides)
    depthwise_xcorr.launches += 1
    return out


class _DepthwiseXcorr(torch.autograd.Function):
    """K6 with its backward: the forward as ``depthwise_xcorr`` runs it, the
    backward K6b's two forms (their plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, cur, prev):
        ctx.save_for_backward(cur, prev)
        return _xcorr_forward(cur, prev)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        cur, prev = ctx.saved_tensors
        d_cur = depthwise_xcorr_grad_input(g, prev) if ctx.needs_input_grad[0] else None
        d_prev = (depthwise_xcorr_grad_kernel(g, cur, prev.shape[2:])
                  if ctx.needs_input_grad[1] else None)
        return d_cur, d_prev


def depthwise_xcorr(cur: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """K6: correlate each (batch, channel) plane of ``cur`` (B, C, H, W) with
    the same plane of ``prev`` (B, C, kh, kw) as the kernel, torch ``'same'``
    padding ((k-1)//2 before, k//2 after) → (B, C, H, W) in ``cur``'s dtype
    and memory format (NCHW or channels_last).  On a CUDA tensor it launches
    ``csrc/depthwise_xcorr.cu`` or raises; on a CPU tensor it takes the plain
    version.  Where a gradient is needed the call goes through an autograd
    Function whose backward is K6b (``depthwise_xcorr_grad_input``,
    ``depthwise_xcorr_grad_kernel``)."""
    _check_xcorr(cur, prev)
    if torch.is_grad_enabled() and (cur.requires_grad or prev.requires_grad):
        return _DepthwiseXcorr.apply(cur, prev)
    return _xcorr_forward(cur, prev)


depthwise_xcorr.launches = 0


# --- K6b --------------------------------------------------------------------------


def depthwise_xcorr_grad_input_plain(g: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K6b (grad input): ``dcur[y, x] = Σ_{u,v} g[y+ph-u,
    x+pw-v] · prev[u, v]``, ``g`` (B, C, H, W) correlated with the flipped
    kernel, its zero padding swapped (kh//2 before, (kh-1)//2 after); float32
    products summed over the kernel rows, then columns; the result in the
    input dtype."""
    _check_xcorr(g, prev)
    h, w = g.shape[2:]
    kh, kw = prev.shape[2:]
    ph, pw = (kh - 1) // 2, (kw - 1) // 2
    x = F.pad(g.float(), (kw - 1 - pw, pw, kh - 1 - ph, ph))
    k = prev.float()
    acc = torch.zeros(g.shape, dtype=torch.float32, device=g.device)
    for u in range(kh):
        for v in range(kw):
            acc = acc + x[:, :, kh - 1 - u:kh - 1 - u + h, kw - 1 - v:kw - 1 - v + w] \
                * k[:, :, u:u + 1, v:v + 1]
    return acc.to(g.dtype)


def depthwise_xcorr_grad_kernel_plain(g: torch.Tensor, cur: torch.Tensor,
                                      kernel_size) -> torch.Tensor:
    """Plain PyTorch K6b (grad kernel): ``dprev[u, v] = Σ_{y,x} g[y, x] ·
    cur[y+u-ph, x+v-pw]`` → (B, C, kh, kw), float32 products summed over the
    plane's rows, then columns; the result in the input dtype."""
    _check_xcorr(g, cur)
    if g.shape != cur.shape:
        raise ValueError(f"depthwise_xcorr_grad_kernel: g {tuple(g.shape)} and cur "
                         f"{tuple(cur.shape)} differ")
    h, w = g.shape[2:]
    kh, kw = (int(v) for v in kernel_size)
    ph, pw = (kh - 1) // 2, (kw - 1) // 2
    x = F.pad(cur.float(), (pw, kw - 1 - pw, ph, kh - 1 - ph))
    gf = g.float()
    acc = torch.zeros(g.shape[:2] + (kh, kw), dtype=torch.float32, device=g.device)
    for y in range(h):
        for xx in range(w):
            acc = acc + x[:, :, y:y + kh, xx:xx + kw] * gf[:, :, y:y + 1, xx:xx + 1]
    return acc.to(g.dtype)


def xcorr_grad_fits(h: int, w: int, kh: int, kw: int) -> bool:
    """Whether K6b takes (h, w) planes with (kh, kw) kernels: g and the other
    operand (the kernel, or cur) staged in float32 within a block's shared
    memory."""
    return 4 * (h * w + max(h * w, kh * kw)) <= _SMEM_OPTIN


def _channels_last(t: torch.Tensor) -> bool:
    return t.is_contiguous(memory_format=torch.channels_last) and not t.is_contiguous()


def _xcorr_grad_launch(kernel_grad: int, g: torch.Tensor, other: torch.Tensor,
                       out: torch.Tensor) -> None:
    if not (g.is_cuda and other.is_cuda and g.device == other.device):
        raise ValueError(f"depthwise_xcorr's backward: expected two CUDA tensors on one "
                         f"device, got {g.device} and {other.device}")
    b, c, h, w = g.shape
    kh, kw = (out if kernel_grad else other).shape[2:]
    if not xcorr_grad_fits(h, w, kh, kw):
        raise ValueError(f"depthwise_xcorr's backward: planes of {h}x{w} and {kh}x{kw} do not "
                         f"fit one block's shared memory ({_SMEM_OPTIN} bytes)")
    A = _cuda
    fn = A.function("depthwise_xcorr", "k6b_depthwise_xcorr_grad",
                    [A.I32, A.P, A.P, A.P] + [A.I32] * 7 + [A.I64] * 12 + [A.P])
    A.launch(fn, g.device, kernel_grad, g.data_ptr(), other.data_ptr(), out.data_ptr(),
             int(g.dtype == torch.bfloat16), b, c, h, w, kh, kw, *g.stride(), *other.stride(),
             *out.stride())


def depthwise_xcorr_grad_input(g: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """K6b (grad input): ∂L/∂cur (B, C, H, W) of K6 from ``g`` = ∂L/∂out
    and the kernel ``prev``, in ``g``'s dtype and memory format.  On a CUDA
    tensor it launches ``csrc/depthwise_xcorr.cu`` or raises; on a CPU
    tensor it takes the plain version."""
    _check_xcorr(g, prev)
    if g.device.type == "cpu" and prev.device.type == "cpu":
        return depthwise_xcorr_grad_input_plain(g, prev)
    out = torch.empty(g.shape, dtype=g.dtype, device=g.device,
                      memory_format=torch.channels_last if _channels_last(g)
                      else torch.contiguous_format)
    _xcorr_grad_launch(0, g, prev, out)
    depthwise_xcorr_grad_input.launches += 1
    return out


depthwise_xcorr_grad_input.launches = 0


def depthwise_xcorr_grad_kernel(g: torch.Tensor, cur: torch.Tensor,
                                kernel_size) -> torch.Tensor:
    """K6b (grad kernel): ∂L/∂prev (B, C, kh, kw) of K6 from ``g`` = ∂L/∂out
    and ``cur``, in ``g``'s dtype and ``cur``'s memory format.  On a CUDA
    tensor it launches ``csrc/depthwise_xcorr.cu`` or raises; on a CPU
    tensor it takes the plain version."""
    _check_xcorr(g, cur)
    if g.shape != cur.shape:
        raise ValueError(f"depthwise_xcorr_grad_kernel: g {tuple(g.shape)} and cur "
                         f"{tuple(cur.shape)} differ")
    if g.device.type == "cpu" and cur.device.type == "cpu":
        return depthwise_xcorr_grad_kernel_plain(g, cur, kernel_size)
    kh, kw = (int(v) for v in kernel_size)
    out = torch.empty(g.shape[:2] + (kh, kw), dtype=g.dtype, device=g.device,
                      memory_format=torch.channels_last if _channels_last(cur)
                      else torch.contiguous_format)
    _xcorr_grad_launch(1, g, cur, out)
    depthwise_xcorr_grad_kernel.launches += 1
    return out


depthwise_xcorr_grad_kernel.launches = 0
