"""K7–K10: the int8 kernels of the w8a8 2D trunk, K7v, K8v, K10v: those of
the 3D trunks (``csrc/int8_trunk.cu``; counterparts of
``bio_image_unet_tpu/predict/quant.py:417 qconv``, ``:428 qtconv``, ``:223
_requant``, ``:278 _maxpool_i8`` and ``predict/quant3d.py:269 qconv``, ``:277
qtconv``, ``:75 _maxpool_i8_3d``), and K11, K11v: the ×2 linear upsample of
int8 values into a concat buffer (``csrc/int8_resample.cu``; counterparts of
``predict/quant_nested.py:249-253`` and ``predict/quant3d.py:305-310``).

Activations are NHWC (NDHWC) int8 tensors.  Weights come packed by
:class:`..predict.quant.Int8Weights`: a 3×3 (3×3×3) conv's codes as (O, 3, 3,
I_pad) ((O, 3, 3, 3, I_pad)), a 2×2 (2×2×2) transposed conv's as (2, 2, O,
I_pad) ((2, 2, 2, O, I_pad); tap (a, b) makes output pixel (2i+a, 2j+b), as
``F.conv_transpose2d`` / ``3d`` do), I_pad a multiple of 32 with zeros past
I; the float32 per-output-channel weight scale ``sw`` (the transposed conv's
one scale repeated) and bias beside them.

- ``qconv3x3``  (K7): SAME 3×3 conv at dilation d → int32 → ``a =
  fma(float(acc), s_in·sw[o], bias[o])`` → LeakyReLU 0.1 → ``rint(a / s_out)``
  clipped to ±127, from a channel range of a wider tensor if need be, into
  channels [offset, offset + O) of ``out`` when one is given;
- ``qconvt2x2`` (K8): the 2×2 stride-2 transposed conv with the same
  dequant and requant (no activation), written into channels [offset,
  offset + O) of a concat buffer;
- ``requant``   (K9): ``rint(x·s_a / s_b)`` clipped to ±127 from int8,
  bfloat16 or float32 into int8 (channels [offset, offset + C) of ``out``),
  or, with ``s_b=None``, the dequant ``bf16(x·s_a)``; ``x`` may be a channel
  range of a wider tensor (``buf[..., a:b]``);
- ``maxpool_i8`` (K10): 2×2 stride-2 max (of a channel range, too);
- ``qconv3x3x3``, ``qconvt2x2x2`` (K7v, K8v): K7 and K8 on volumes, the
  activation scales folded into the weights (``s_in = 1``: the dequant is
  ``fma(float(acc), sw[o], bias[o])``), each into channels [offset, offset
  + O) of an output buffer when one is given;
- ``maxpool_i8_3d`` (K10v): 2×2×2 stride-2 max;
- ``upsample2x_i8`` (K11): the UNet++ grid's ×2 bilinear, ``align_corners=
  True``, of int8 values in float32 in JAX's arithmetic, rounded half to even
  and clipped to ±127 at the same scale, into channels [offset, offset + C)
  of a concat buffer; ``upsample2x_i8_3d`` (K11v): the same ×2 trilinear with
  half-pixel centres (the trilinear 3D decoder).

Each has a plain PyTorch version beside it (the wrapper takes it for CPU
tensors only; a CUDA tensor launches the kernel or raises).  The plain
convolutions sum the int8 products in float64, where every partial sum is an
integer below 127²·27·1024 < 2^53 and so exact; the epilogue is float32 in the
kernel's order, its multiply-add fused and rounded once (``stitch._fma_f32``)
as XLA's CPU backend contracts it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import _cuda
from .stitch import _fma_f32

_F32 = torch.float32
# output elements a plain version computes at once (its float64 temporaries
# are some 8 bytes an element each)
_PLAIN_STEP = 1 << 25


def _f32(v: float, device) -> torch.Tensor:
    return torch.tensor(float(v), dtype=_F32, device=device)


def _dequant_requant(y: torch.Tensor, sw: torch.Tensor, bias: torch.Tensor, s_in: float,
                     s_out: float, leaky: bool) -> torch.Tensor:
    """The K7/K8 epilogue on float32 sums ``y`` (..., O)."""
    dev = y.device
    a = _fma_f32(y, _f32(s_in, dev) * sw, bias)
    if leaky:
        a = torch.where(a >= 0, a, a * _f32(0.1, dev))
    return torch.clamp(torch.round(a / _f32(s_out, dev)), -127, 127).to(torch.int8)


def _batched(fn, x: torch.Tensor, per_item: int) -> torch.Tensor:
    step = max(1, _PLAIN_STEP // max(1, per_item))
    outs = [fn(x[s:s + step]) for s in range(0, x.shape[0], step)]
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def _check_conv(x: torch.Tensor, w: torch.Tensor, sw: torch.Tensor, bias: torch.Tensor,
                taps: tuple, transposed: bool, what: str) -> int:
    nd = len(taps)
    layout = "NHWC" if nd == 2 else "NDHWC"
    if x.dim() != nd + 2 or x.dtype != torch.int8:
        raise ValueError(f"{what}: expected {layout} int8 activations, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if w.dtype != torch.int8 or w.dim() != nd + 2:
        raise ValueError(f"{what}: expected packed int8 weights, got {w.dtype} {tuple(w.shape)}")
    cin, cin_pad = x.shape[-1], w.shape[-1]
    if cin > cin_pad or cin_pad % 32:
        raise ValueError(f"{what}: {cin} input channels for weights padded to {cin_pad} "
                         "(a multiple of 32 at least the input's)")
    cout = w.shape[nd] if transposed else w.shape[0]
    if tuple(w.shape[:nd] if transposed else w.shape[1:nd + 1]) != taps:
        raise ValueError(f"{what}: weights {tuple(w.shape)} do not hold {taps} taps")
    if sw.shape != (cout,) or bias.shape != (cout,) or sw.dtype != _F32 or bias.dtype != _F32:
        raise ValueError(f"{what}: sw and bias must be ({cout},) float32")
    return cout


def _in_vec(x: torch.Tensor, stride: Optional[int] = None) -> int:
    """Bytes one asynchronous copy of K7/K8's input may move: 16, 8 or 4
    where every pixel's channels start on such a boundary (pixels ``stride``
    bytes apart, the channel count by default), else 1 (byte loads)."""
    stride = x.shape[-1] if stride is None else stride
    return next((v for v in (16, 8, 4) if x.shape[-1] % v == 0 and stride % v == 0
                 and x.data_ptr() % v == 0), 1)


def _out_vec(out: torch.Tensor, cout: int, offset: int) -> int:
    """Bytes one store of K7/K8's output may write: the widest of 16, 8, 4, 2
    and 1 that divides the channel count, the row stride, the channel offset
    and the address."""
    return next(v for v in (16, 8, 4, 2, 1) if cout % v == 0 and out.shape[-1] % v == 0
                and offset % v == 0 and out.data_ptr() % v == 0)


def _on_card(what: str, *ts: torch.Tensor) -> torch.device:
    dev = ts[0].device
    for t in ts:
        _cuda.require_cuda(t, what, dev)
    return dev


def _rows_on_card(what: str, x: torch.Tensor, device=None) -> int:
    """The row stride of ``x``, a CUDA tensor (on ``device`` if given) of
    rows of channels, contiguous or a channel range of a wider one
    (:func:`_row_stride`)."""
    if not x.is_cuda or (device is not None and x.device != device):
        raise ValueError(f"{what}: expected a CUDA tensor on {device or 'the card'}, got "
                         f"{x.device}")
    return _row_stride(x, what)


# --- K7 -----------------------------------------------------------------------

def qconv3x3_plain(x: torch.Tensor, w: torch.Tensor, sw: torch.Tensor, bias: torch.Tensor,
                   s_in: float, s_out: float, dilation: int = 1,
                   out: Optional[torch.Tensor] = None, offset: int = 0) -> torch.Tensor:
    """Plain PyTorch K7: (n, h, w, I) int8 → channels [offset, offset + O) of
    ``out`` (n, h, w, C_out), or a new (n, h, w, O) int8 tensor."""
    cout = _check_conv(x, w, sw, bias, (3, 3), False, "qconv3x3")
    target = _concat_target(out, tuple(x.shape[:-1]), offset, cout, x.device, "qconv3x3")
    k = w[..., :x.shape[-1]].permute(0, 3, 1, 2).double()

    def one(xs):
        with torch.backends.cudnn.flags(enabled=False):  # the direct sum, exact in float64
            y = F.conv2d(xs.permute(0, 3, 1, 2).double(), k, padding=dilation,
                         dilation=dilation)
        return _dequant_requant(y.permute(0, 2, 3, 1).float(), sw, bias, s_in, s_out, True)

    target[..., offset:offset + cout] = _batched(one, x, x.shape[1] * x.shape[2] * cout)
    return target


def qconv3x3(x: torch.Tensor, w: torch.Tensor, sw: torch.Tensor, bias: torch.Tensor,
             s_in: float, s_out: float, dilation: int = 1, out: Optional[torch.Tensor] = None,
             offset: int = 0) -> torch.Tensor:
    """K7 (see the module docstring); ``x`` may be a channel range of a wider
    NHWC tensor, and the output goes to channels [offset, offset + O) of
    ``out`` when one is given."""
    cout = _check_conv(x, w, sw, bias, (3, 3), False, "qconv3x3")
    if x.device.type == "cpu":
        return qconv3x3_plain(x, w, sw, bias, s_in, s_out, dilation, out, offset)
    dev = _on_card("qconv3x3", w, sw, bias)
    in_stride = _rows_on_card("qconv3x3", x, dev)
    n, h, wd, cin = x.shape
    target = _concat_target(out, (n, h, wd), offset, cout, dev, "qconv3x3")
    _cuda.require_cuda(target, "qconv3x3 out", dev)
    A = _cuda
    fn = A.function("int8_trunk", "k7_qconv3x3",
                    [A.P] * 5 + [A.I32] * 12 + [A.F32, A.F32, A.P])
    A.launch(fn, dev, x.data_ptr(), w.data_ptr(), sw.data_ptr(), bias.data_ptr(),
             target.data_ptr(), n, h, wd, cin, w.shape[-1], cout, int(dilation),
             _in_vec(x, in_stride), _out_vec(target, cout, offset), in_stride,
             target.shape[-1], int(offset), float(s_in), float(s_out))
    qconv3x3.launches += 1
    return target


qconv3x3.launches = 0


# --- K8 -----------------------------------------------------------------------

def _concat_target(out: Optional[torch.Tensor], shape: tuple, offset: int, c: int, dev,
                   what: str) -> torch.Tensor:
    if out is None:
        if offset:
            raise ValueError(f"{what}: a channel offset needs an output buffer")
        return torch.empty(shape + (c,), dtype=torch.int8, device=dev)
    if (out.dtype != torch.int8 or tuple(out.shape[:-1]) != shape
            or offset < 0 or offset + c > out.shape[-1]):
        raise ValueError(f"{what}: output buffer {out.dtype} {tuple(out.shape)} cannot take "
                         f"{c} channels at offset {offset} of {shape}")
    return out


def qconvt2x2_plain(x: torch.Tensor, w: torch.Tensor, sw: torch.Tensor, bias: torch.Tensor,
                    s_in: float, s_out: float, out: Optional[torch.Tensor] = None,
                    offset: int = 0) -> torch.Tensor:
    """Plain PyTorch K8: (n, h, w, I) int8 → channels [offset, offset + O) of
    ``out`` (n, 2h, 2w, C_out), or a new (n, 2h, 2w, O) tensor."""
    cout = _check_conv(x, w, sw, bias, (2, 2), True, "qconvt2x2")
    n, h, wd, cin = x.shape
    target = _concat_target(out, (n, 2 * h, 2 * wd), offset, cout, x.device, "qconvt2x2")
    k = w[..., :cin].double()

    def one(xs):
        y = torch.einsum("nijc,aboc->niajbo", xs.double(), k)
        y = y.reshape(xs.shape[0], 2 * h, 2 * wd, cout).float()
        return _dequant_requant(y, sw, bias, s_in, s_out, False)

    target[..., offset:offset + cout] = _batched(one, x, 4 * h * wd * cout)
    return target


def qconvt2x2(x: torch.Tensor, w: torch.Tensor, sw: torch.Tensor, bias: torch.Tensor,
              s_in: float, s_out: float, out: Optional[torch.Tensor] = None,
              offset: int = 0) -> torch.Tensor:
    """K8 (see the module docstring)."""
    cout = _check_conv(x, w, sw, bias, (2, 2), True, "qconvt2x2")
    if x.device.type == "cpu":
        return qconvt2x2_plain(x, w, sw, bias, s_in, s_out, out, offset)
    dev = _on_card("qconvt2x2", x, w, sw, bias)
    n, h, wd, cin = x.shape
    target = _concat_target(out, (n, 2 * h, 2 * wd), offset, cout, dev, "qconvt2x2")
    _cuda.require_cuda(target, "qconvt2x2 out", dev)
    A = _cuda
    fn = A.function("int8_trunk", "k8_qconvt2x2",
                    [A.P] * 5 + [A.I32] * 10 + [A.F32, A.F32, A.P])
    A.launch(fn, dev, x.data_ptr(), w.data_ptr(), sw.data_ptr(), bias.data_ptr(),
             target.data_ptr(), n, h, wd, cin, w.shape[-1], cout, _in_vec(x),
             _out_vec(target, cout, offset), target.shape[-1], int(offset), float(s_in),
             float(s_out))
    qconvt2x2.launches += 1
    return target


qconvt2x2.launches = 0


# --- K9 -----------------------------------------------------------------------

_REQUANT_IN = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}


def _requant_target(x: torch.Tensor, s_b: Optional[float], out: Optional[torch.Tensor],
                    offset: int) -> torch.Tensor:
    if x.dtype not in _REQUANT_IN:
        raise ValueError(f"requant takes int8, bfloat16 or float32, got {x.dtype}")
    if s_b is None:
        if out is not None or offset:
            raise ValueError("requant: the bf16 dequant writes a new tensor")
        return torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
    return _concat_target(out, tuple(x.shape[:-1]), offset, x.shape[-1], x.device, "requant")


def requant_plain(x: torch.Tensor, s_a: float, s_b: Optional[float] = None,
                  out: Optional[torch.Tensor] = None, offset: int = 0) -> torch.Tensor:
    """Plain PyTorch K9: ``rint((x·s_a) / s_b)`` clipped to ±127 into
    channels [offset, offset + C) of ``out`` (or a new int8 tensor); with
    ``s_b=None`` the dequant ``bf16(x·s_a)``."""
    target = _requant_target(x, s_b, out, offset)
    v = x.float() * _f32(s_a, x.device)
    if s_b is None:
        target.copy_(v.to(torch.bfloat16))
    else:
        q = torch.clamp(torch.round(v / _f32(s_b, x.device)), -127, 127).to(torch.int8)
        target[..., offset:offset + x.shape[-1]] = q
    return target


def _row_stride(x: torch.Tensor, what: str) -> int:
    """Elements between two rows of ``x`` (..., C): C for a contiguous tensor,
    more for a channel range of a wider one (``buf[..., a:b]``); raises for
    any other layout."""
    lead = [d for d in range(x.dim() - 1) if x.shape[d] > 1]  # size-1 dims: any stride
    stride = x.stride(lead[-1]) if lead else x.shape[-1]
    rows = 1
    ok = x.shape[-1] <= 1 or x.stride(-1) == 1
    for d in range(x.dim() - 2, -1, -1):
        ok = ok and (x.shape[d] == 1 or x.stride(d) == stride * rows)
        rows *= x.shape[d]
    if not ok or stride < x.shape[-1]:
        raise ValueError(f"{what}: expected a contiguous tensor or a channel range of one "
                         f"(rows of channels, one row stride), got strides {x.stride()} for "
                         f"{tuple(x.shape)}")
    return stride


def requant(x: torch.Tensor, s_a: float, s_b: Optional[float] = None,
            out: Optional[torch.Tensor] = None, offset: int = 0) -> torch.Tensor:
    """K9 (see the module docstring); ``x`` is (..., C) with C innermost: NHWC
    or NDHWC, contiguous or a channel range of a wider such tensor."""
    target = _requant_target(x, s_b, out, offset)
    if x.device.type == "cpu":
        return requant_plain(x, s_a, s_b, out, offset)
    dev = _on_card("requant", target)
    in_stride = _rows_on_card("requant", x, dev)
    A = _cuda
    fn = A.function("int8_trunk", "k9_requant",
                    [A.P, A.I32, A.P, A.I64] + [A.I32] * 5 + [A.F32, A.F32, A.P])
    A.launch(fn, dev, x.data_ptr(), _REQUANT_IN[x.dtype], target.data_ptr(), x.numel(),
             x.shape[-1], in_stride, int(s_b is None), target.shape[-1], int(offset),
             float(s_a), float(1.0 if s_b is None else s_b))
    requant.launches += 1
    return target


requant.launches = 0


# --- K10 ----------------------------------------------------------------------

def maxpool_i8_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K10 (``F.max_pool2d`` takes no int8): a reshape and
    ``amax`` over each 2×2 window; odd extents are floored."""
    n, h, w, c = x.shape
    x = x[:, :2 * (h // 2), :2 * (w // 2)]
    return x.reshape(n, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def maxpool_i8(x: torch.Tensor) -> torch.Tensor:
    """K10: (n, h, w, C) int8 → (n, h//2, w//2, C); ``x`` may be a channel
    range of a wider NHWC tensor."""
    if x.dim() != 4 or x.dtype != torch.int8:
        raise ValueError(f"maxpool_i8 takes NHWC int8, got {x.dtype} {tuple(x.shape)}")
    if x.device.type == "cpu":
        return maxpool_i8_plain(x)
    in_stride = _rows_on_card("maxpool_i8", x)
    dev = x.device
    n, h, w, c = x.shape
    out = torch.empty((n, h // 2, w // 2, c), dtype=torch.int8, device=dev)
    A = _cuda
    fn = A.function("int8_trunk", "k10_maxpool_i8", [A.P, A.P] + [A.I32] * 5 + [A.P])
    A.launch(fn, dev, x.data_ptr(), out.data_ptr(), n, h, w, c, in_stride)
    maxpool_i8.launches += 1
    return out


maxpool_i8.launches = 0


# --- K7v ----------------------------------------------------------------------

def qconv3x3x3_plain(x: torch.Tensor, w: torch.Tensor, sw: torch.Tensor, bias: torch.Tensor,
                     s_out: float, out: Optional[torch.Tensor] = None,
                     offset: int = 0) -> torch.Tensor:
    """Plain PyTorch K7v: (n, d, h, w, I) int8 → channels [offset, offset + O)
    of ``out`` (n, d, h, w, C_out), or a new (n, d, h, w, O) tensor."""
    cout = _check_conv(x, w, sw, bias, (3, 3, 3), False, "qconv3x3x3")
    target = _concat_target(out, tuple(x.shape[:-1]), offset, cout, x.device, "qconv3x3x3")
    k = w[..., :x.shape[-1]].permute(0, 4, 1, 2, 3).double()

    def one(xs):
        with torch.backends.cudnn.flags(enabled=False):  # the direct sum, exact in float64
            y = F.conv3d(xs.permute(0, 4, 1, 2, 3).double(), k, padding=1)
        return _dequant_requant(y.permute(0, 2, 3, 4, 1).float(), sw, bias, 1.0, s_out, True)

    n, d, h, wd, _ = x.shape
    target[..., offset:offset + cout] = _batched(one, x, d * h * wd * cout)
    return target


def qconv3x3x3(x: torch.Tensor, w: torch.Tensor, sw: torch.Tensor, bias: torch.Tensor,
               s_out: float, out: Optional[torch.Tensor] = None, offset: int = 0) -> torch.Tensor:
    """K7v (see the module docstring)."""
    cout = _check_conv(x, w, sw, bias, (3, 3, 3), False, "qconv3x3x3")
    if x.device.type == "cpu":
        return qconv3x3x3_plain(x, w, sw, bias, s_out, out, offset)
    dev = _on_card("qconv3x3x3", x, w, sw, bias)
    target = _concat_target(out, tuple(x.shape[:-1]), offset, cout, dev, "qconv3x3x3")
    _cuda.require_cuda(target, "qconv3x3x3 out", dev)
    n, d, h, wd, cin = x.shape
    A = _cuda
    fn = A.function("int8_trunk", "k7v_qconv3x3x3", [A.P] * 5 + [A.I32] * 11 + [A.F32, A.P])
    A.launch(fn, dev, x.data_ptr(), w.data_ptr(), sw.data_ptr(), bias.data_ptr(),
             target.data_ptr(), n, d, h, wd, cin, w.shape[-1], cout, _in_vec(x),
             _out_vec(target, cout, offset), target.shape[-1], int(offset), float(s_out))
    qconv3x3x3.launches += 1
    return target


qconv3x3x3.launches = 0


# --- K8v ----------------------------------------------------------------------

def qconvt2x2x2_plain(x: torch.Tensor, w: torch.Tensor, sw: torch.Tensor, bias: torch.Tensor,
                      s_out: float, out: Optional[torch.Tensor] = None,
                      offset: int = 0) -> torch.Tensor:
    """Plain PyTorch K8v: (n, d, h, w, I) int8 → channels [offset, offset + O)
    of ``out`` (n, 2d, 2h, 2w, C_out), or a new (n, 2d, 2h, 2w, O) tensor."""
    cout = _check_conv(x, w, sw, bias, (2, 2, 2), True, "qconvt2x2x2")
    n, d, h, wd, cin = x.shape
    target = _concat_target(out, (n, 2 * d, 2 * h, 2 * wd), offset, cout, x.device,
                            "qconvt2x2x2")
    k = w[..., :cin].double()

    def one(xs):
        y = torch.einsum("nzijc,abeoc->nzaibjeo", xs.double(), k)
        y = y.reshape(xs.shape[0], 2 * d, 2 * h, 2 * wd, cout).float()
        return _dequant_requant(y, sw, bias, 1.0, s_out, False)

    target[..., offset:offset + cout] = _batched(one, x, 8 * d * h * wd * cout)
    return target


def qconvt2x2x2(x: torch.Tensor, w: torch.Tensor, sw: torch.Tensor, bias: torch.Tensor,
                s_out: float, out: Optional[torch.Tensor] = None,
                offset: int = 0) -> torch.Tensor:
    """K8v (see the module docstring)."""
    cout = _check_conv(x, w, sw, bias, (2, 2, 2), True, "qconvt2x2x2")
    if x.device.type == "cpu":
        return qconvt2x2x2_plain(x, w, sw, bias, s_out, out, offset)
    dev = _on_card("qconvt2x2x2", x, w, sw, bias)
    n, d, h, wd, cin = x.shape
    target = _concat_target(out, (n, 2 * d, 2 * h, 2 * wd), offset, cout, dev, "qconvt2x2x2")
    _cuda.require_cuda(target, "qconvt2x2x2 out", dev)
    A = _cuda
    fn = A.function("int8_trunk", "k8v_qconvt2x2x2", [A.P] * 5 + [A.I32] * 11 + [A.F32, A.P])
    A.launch(fn, dev, x.data_ptr(), w.data_ptr(), sw.data_ptr(), bias.data_ptr(),
             target.data_ptr(), n, d, h, wd, cin, w.shape[-1], cout, _in_vec(x),
             _out_vec(target, cout, offset), target.shape[-1], int(offset), float(s_out))
    qconvt2x2x2.launches += 1
    return target


qconvt2x2x2.launches = 0


# --- K10v ---------------------------------------------------------------------

def maxpool_i8_3d_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K10v: a reshape and ``amax`` over each 2×2×2 window;
    odd extents are floored (VALID)."""
    n, d, h, w, c = x.shape
    x = x[:, :2 * (d // 2), :2 * (h // 2), :2 * (w // 2)]
    return x.reshape(n, d // 2, 2, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4, 6))


def maxpool_i8_3d(x: torch.Tensor) -> torch.Tensor:
    """K10v: (n, d, h, w, C) int8 → (n, d//2, h//2, w//2, C)."""
    if x.dim() != 5 or x.dtype != torch.int8:
        raise ValueError(f"maxpool_i8_3d takes NDHWC int8, got {x.dtype} {tuple(x.shape)}")
    if x.device.type == "cpu":
        return maxpool_i8_3d_plain(x)
    dev = _on_card("maxpool_i8_3d", x)
    n, d, h, w, c = x.shape
    out = torch.empty((n, d // 2, h // 2, w // 2, c), dtype=torch.int8, device=dev)
    A = _cuda
    fn = A.function("int8_trunk", "k10v_maxpool_i8_3d", [A.P, A.P] + [A.I32] * 6 + [A.P])
    # 16-byte loads where every voxel's channels start on a 16-byte boundary
    v16 = int(c % 16 == 0 and x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    A.launch(fn, dev, x.data_ptr(), out.data_ptr(), n, d, h, w, c, v16)
    maxpool_i8_3d.launches += 1
    return out


maxpool_i8_3d.launches = 0


# --- K11, K11v ----------------------------------------------------------------------

def _aligned_axis(n: int):
    """JAX's ``align_corners=True`` ×2 gather indices and weights of an axis
    of n (``functional.py:74-84``), float32 as XLA computes them: ``(lo, hi,
    t, 1 - t)``, and the float32 ratio the kernel takes."""
    ratio = np.float32((n - 1) / (2 * n - 1)) if n > 1 else np.float32(0.0)
    coords = np.arange(2 * n, dtype=np.float32) * ratio
    lo = np.clip(np.floor(coords).astype(np.int64), 0, n - 1)
    hi = np.clip(lo + 1, 0, n - 1)
    t = coords - lo.astype(np.float32)
    return (torch.from_numpy(lo), torch.from_numpy(hi), torch.from_numpy(t),
            torch.from_numpy(np.float32(1.0) - t), float(ratio))


def _blend_axis(v: torch.Tensor, axis: int) -> torch.Tensor:
    """One axis of K11: ``fma(v_lo, 1 - t, v_hi·t)`` in float32, the form
    XLA's CPU backend contracts ``v_lo·(1-t) + v_hi·t`` to."""
    lo, hi, t, omt, _ = _aligned_axis(v.shape[axis])
    shape = [1] * v.dim()
    shape[axis] = -1
    dev = v.device
    b = v.index_select(axis, hi.to(dev)) * t.to(dev).view(shape)
    return _fma_f32(v.index_select(axis, lo.to(dev)), omt.to(dev).view(shape), b)


def _vec_bytes(x: torch.Tensor, in_stride: int, out: torch.Tensor, offset: int) -> int:
    """Bytes one K11 thread moves: the widest of 16, 8, 4, 2, 1 that divides
    the channel count, both row strides, the offset and both addresses."""
    c = x.shape[-1]
    return next(v for v in (16, 8, 4, 2, 1) if c % v == 0 and in_stride % v == 0
                and out.shape[-1] % v == 0 and offset % v == 0 and x.data_ptr() % v == 0
                and out.data_ptr() % v == 0)


def _check_upsample(x: torch.Tensor, rank: int, what: str) -> None:
    if x.dim() != rank + 2 or x.dtype != torch.int8:
        layout = "NHWC" if rank == 2 else "NDHWC"
        raise ValueError(f"{what}: expected {layout} int8, got {x.dtype} {tuple(x.shape)}")


def upsample2x_i8_plain(x: torch.Tensor, out: Optional[torch.Tensor] = None,
                        offset: int = 0) -> torch.Tensor:
    """Plain PyTorch K11: (n, h, w, C) int8 → ×2 ``align_corners=True``
    bilinear of the int8 values in float32 (axis H, then W), rounded half to
    even and clipped to ±127, into channels [offset, offset + C) of ``out``
    (n, 2h, 2w, C_out), or a new (n, 2h, 2w, C) tensor."""
    _check_upsample(x, 2, "upsample2x_i8")
    n, h, w, c = x.shape
    target = _concat_target(out, (n, 2 * h, 2 * w), offset, c, x.device, "upsample2x_i8")

    def one(xs):
        v = _blend_axis(_blend_axis(xs.float(), 1), 2)
        return torch.clamp(torch.round(v), -127, 127).to(torch.int8)

    target[..., offset:offset + c] = _batched(one, x, 4 * h * w * c)
    return target


def upsample2x_i8(x: torch.Tensor, out: Optional[torch.Tensor] = None,
                  offset: int = 0) -> torch.Tensor:
    """K11: the UNet++ grid's ×2 bilinear (``align_corners=True``) of int8
    values, into a channel range of the consumer's concat buffer (see
    :func:`upsample2x_i8_plain`); ``x`` may be a channel range of a wider
    NHWC tensor."""
    _check_upsample(x, 2, "upsample2x_i8")
    if x.device.type == "cpu":
        return upsample2x_i8_plain(x, out, offset)
    in_stride = _rows_on_card("upsample2x_i8", x)
    dev = x.device
    n, h, w, c = x.shape
    target = _concat_target(out, (n, 2 * h, 2 * w), offset, c, dev, "upsample2x_i8")
    _cuda.require_cuda(target, "upsample2x_i8 out", dev)
    A = _cuda
    fn = A.function("int8_resample", "k11_upsample2x_i8",
                    [A.P, A.P] + [A.I32] * 9 + [A.F32, A.F32, A.P])
    A.launch(fn, dev, x.data_ptr(), target.data_ptr(), n, 0, h, w, c, in_stride,
             target.shape[-1], int(offset), _vec_bytes(x, in_stride, target, offset),
             _aligned_axis(h)[4], _aligned_axis(w)[4])
    upsample2x_i8.launches += 1
    return target


upsample2x_i8.launches = 0


def upsample2x_i8_3d_plain(x: torch.Tensor, out: Optional[torch.Tensor] = None,
                           offset: int = 0) -> torch.Tensor:
    """Plain PyTorch K11v: (n, d, h, w, C) int8 → ×2 trilinear with
    half-pixel centres (``F.interpolate``, ``align_corners=False``) of the
    int8 values in float32, rounded half to even and clipped to ±127, into
    channels [offset, offset + C) of ``out`` (n, 2d, 2h, 2w, C_out), or a new
    tensor.  Every weight is 0, 1/4, 3/4 or 1, so the float32 result is exact
    in any order of the sums."""
    _check_upsample(x, 3, "upsample2x_i8_3d")
    n, d, h, w, c = x.shape
    target = _concat_target(out, (n, 2 * d, 2 * h, 2 * w), offset, c, x.device,
                            "upsample2x_i8_3d")

    def one(xs):
        u = F.interpolate(xs.permute(0, 4, 1, 2, 3).float(), scale_factor=2, mode="trilinear",
                          align_corners=False)
        return torch.clamp(torch.round(u), -127, 127).to(torch.int8).permute(0, 2, 3, 4, 1)

    target[..., offset:offset + c] = _batched(one, x, 8 * d * h * w * c)
    return target


def upsample2x_i8_3d(x: torch.Tensor, out: Optional[torch.Tensor] = None,
                     offset: int = 0) -> torch.Tensor:
    """K11v: the trilinear 3D decoder's ×2 of int8 values, into a channel
    range of the decoder's concat buffer (see :func:`upsample2x_i8_3d_plain`)."""
    _check_upsample(x, 3, "upsample2x_i8_3d")
    if x.device.type == "cpu":
        return upsample2x_i8_3d_plain(x, out, offset)
    dev = _on_card("upsample2x_i8_3d", x)
    n, d, h, w, c = x.shape
    target = _concat_target(out, (n, 2 * d, 2 * h, 2 * w), offset, c, dev, "upsample2x_i8_3d")
    _cuda.require_cuda(target, "upsample2x_i8_3d out", dev)
    A = _cuda
    fn = A.function("int8_resample", "k11_upsample2x_i8",
                    [A.P, A.P] + [A.I32] * 9 + [A.F32, A.F32, A.P])
    A.launch(fn, dev, x.data_ptr(), target.data_ptr(), n, d, h, w, c, c, target.shape[-1],
             int(offset), _vec_bytes(x, c, target, offset), 0.0, 0.0)
    upsample2x_i8_3d.launches += 1
    return target


upsample2x_i8_3d.launches = 0
