"""K1 / K1f: exact per-frame percentile clip bounds
(counterpart of ``bio_image_unet_tpu/ops/histogram.py``).

``clip_bounds(frames, q_lo, q_hi)`` returns per-frame ``(lo, hi, fmin, fmax)``
as a (4, N) float32 tensor: lo/hi are numpy-'linear' percentiles found from
exact order statistics, fmin/fmax the frame min/max clamped into [lo, hi].
uint8 and uint16 frames take K1 (``int_clip_bounds``), NaN-free float32 frames
K1f (``float_clip_bounds``).  ``pair_clip_bounds(block, q_lo, q_hi)`` is their
Siam pair-row form (``predictor.py:987-992``, ``'all'`` mode): row i is frames
i and i+1 of a (k+1, h, w) block as one row of 2·h·w values, read in place.
``u8_counts``, ``u8_percentile`` and ``u8_clip_bounds`` are the JAX
package's 256-bin histogram oracle, in plain PyTorch (no path runs them).

On a CUDA tensor the wrapper launches the hand-written kernel
(``csrc/clip_bounds.cu``: a radix select, one launch a digit of the key,
``DIGITS[dtype]``; the block that finishes a frame's pass last selects, so
no other launch runs) and raises if it cannot;
on a CPU tensor it takes the plain PyTorch version below, which repeats the
JAX package's bitwise binary search step for step.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

from . import _cuda

_KEY_BITS = {torch.uint8: 8, torch.uint16: 16, torch.float32: 32}


def _quantile_plan(p: int, q_lo: float, q_hi: float):
    """Order-statistic positions and float32 blend fractions of the two
    percentiles (numpy's 'linear' rule; the fraction is rounded to float32
    once, as JAX's weak typing does, ``histogram.py:121-139``)."""
    ks: List[int] = []
    fracs: List[float] = []
    for q in (q_lo, q_hi):
        pos = (p - 1) * (float(q) / 100.0)
        lo_k, hi_k = int(math.floor(pos)), int(math.ceil(pos))
        ks.extend((lo_k, hi_k))
        fracs.append(float(np.float32(pos - lo_k)))
    return ks, fracs


# --- plain PyTorch version -------------------------------------------------

def _sortable(flat_f32: torch.Tensor) -> torch.Tensor:
    """float32 → int64 holding the uint32 key whose order is the floats'
    numeric order (``histogram.py:91 _f32_sortable``)."""
    bits = flat_f32.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    neg = (bits >> 31) == 1
    return torch.where(neg, (~bits) & 0xFFFFFFFF, bits | 0x80000000)


def _unsortable(keys: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_sortable` (``histogram.py:101``)."""
    bits = torch.where((keys >> 31) == 1, keys ^ 0x80000000, (~keys) & 0xFFFFFFFF)
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32)


def _order_stats_bitsearch(keys: torch.Tensor, ks, n_bits: int) -> torch.Tensor:
    """Per-row order statistics of non-negative int64 keys by bitwise binary
    search over the value space (``histogram.py:62``)."""
    n = keys.shape[0]
    ks_t = torch.as_tensor(ks, dtype=torch.int64, device=keys.device)[None, :]
    val = torch.zeros((n, len(ks)), dtype=torch.int64, device=keys.device)
    for bit in range(n_bits - 1, -1, -1):
        step = 1 << bit
        cand = val + (step - 1)
        cnt = torch.stack([(keys <= cand[:, j:j + 1]).sum(1)
                           for j in range(len(ks))], dim=1)
        val = torch.where(cnt < ks_t + 1, val + step, val)
    return val


def _interp(stats: torch.Tensor, ks, fracs, i: int) -> torch.Tensor:
    lo_v, hi_v = stats[:, 2 * i], stats[:, 2 * i + 1]
    if ks[2 * i] == ks[2 * i + 1]:
        return lo_v
    frac = torch.tensor(fracs[i], dtype=torch.float32, device=stats.device)
    return lo_v + frac * (hi_v - lo_v)


def clip_bounds_plain(frames: torch.Tensor, q_lo: float, q_hi: float) -> torch.Tensor:
    """Plain PyTorch K1/K1f: (N, ...) uint8/uint16/float32 → (4, N) float32."""
    n = frames.shape[0]
    flat = frames.reshape(n, -1)
    ks, fracs = _quantile_plan(flat.shape[1], q_lo, q_hi)
    if flat.dtype == torch.float32:
        stats = _unsortable(_order_stats_bitsearch(_sortable(flat), ks, 32))
        vmin, vmax = flat.amin(1), flat.amax(1)
    elif flat.dtype in (torch.uint8, torch.uint16):
        keys = flat.to(torch.int64)
        stats = _order_stats_bitsearch(keys, ks, _KEY_BITS[flat.dtype]).to(torch.float32)
        vmin, vmax = keys.amin(1).to(torch.float32), keys.amax(1).to(torch.float32)
    else:
        raise ValueError(f"clip bounds take uint8/uint16/float32 frames, got {flat.dtype}")
    lo, hi = _interp(stats, ks, fracs, 0), _interp(stats, ks, fracs, 1)
    return torch.stack([lo, hi, torch.maximum(vmin, lo), torch.minimum(vmax, hi)])


# --- the 256-bin histogram oracle (B3) ---------------------------------------
#
# The JAX package's exact uint8 percentiles by value counts
# (``histogram.py:20 u8_counts``, ``:40 u8_percentile``, ``:174
# u8_clip_bounds``), kept there as the reference form of K1's uint8 bounds.
# No path of either package runs them; here they are plain PyTorch on the
# input's device, for callers that want full per-frame histograms and as a
# second oracle for K1.

def u8_counts(flat: torch.Tensor) -> torch.Tensor:
    """(N, P) uint8 → (N, 256) int32 value counts, one ``bincount`` over
    the values offset by 256 a row."""
    if flat.dtype != torch.uint8 or flat.dim() != 2:
        raise ValueError(f"u8_counts takes (N, P) uint8, got {tuple(flat.shape)} {flat.dtype}")
    n = flat.shape[0]
    rows = torch.arange(n, device=flat.device, dtype=torch.int64)[:, None] * 256
    keys = (flat.to(torch.int64) + rows).reshape(-1)
    return torch.bincount(keys, minlength=256 * n).reshape(n, 256).to(torch.int32)


def _u8_order_stat(cum: torch.Tensor, k: int) -> torch.Tensor:
    """The k-th (0-based) order statistic of each row of an (N, 256)
    cumulative histogram: the least value v with cum[v] ≥ k + 1."""
    want = torch.full((cum.shape[0], 1), k + 1, dtype=cum.dtype, device=cum.device)
    return torch.searchsorted(cum, want).squeeze(1).to(torch.float32)


def _u8_percentiles(cum: torch.Tensor, p: int, q_lo: float, q_hi: float):
    """numpy's 'linear'-rule percentiles ``q_lo`` and ``q_hi`` from per-row
    cumulative counts, blended as K1's plain version blends them."""
    ks, fracs = _quantile_plan(p, q_lo, q_hi)
    stats = torch.stack([_u8_order_stat(cum, k) for k in ks], dim=1)
    return _interp(stats, ks, fracs, 0), _interp(stats, ks, fracs, 1)


def _u8_cumulative(frames: torch.Tensor):
    if frames.dtype != torch.uint8:
        raise ValueError(f"the histogram oracle takes uint8 frames, got {frames.dtype}")
    flat = frames.reshape(frames.shape[0], -1)
    return torch.cumsum(u8_counts(flat).to(torch.int64), dim=1), flat.shape[1]


def u8_percentile(frames: torch.Tensor, qs) -> List[torch.Tensor]:
    """Exact per-frame percentiles ``qs`` (0–100) of (N, *spatial) uint8
    frames: one (N,) float32 tensor a percentile, numpy's 'linear' rule."""
    cum, p = _u8_cumulative(frames)
    return [_u8_percentiles(cum, p, q, q)[0] for q in qs]


def u8_clip_bounds(frames: torch.Tensor, q_lo: float, q_hi: float):
    """Per-frame ``(lo, hi, fmin, fmax)`` of uint8 frames from one histogram:
    the clip percentiles and the extremes clamped into [lo, hi], each (N,)
    float32 — what K1 (:func:`int_clip_bounds`) returns as rows of a (4, N)
    tensor, bit for bit."""
    cum, p = _u8_cumulative(frames)
    lo, hi = _u8_percentiles(cum, p, q_lo, q_hi)
    vmin, vmax = _u8_order_stat(cum, 0), _u8_order_stat(cum, p - 1)
    return lo, hi, torch.maximum(vmin, lo), torch.minimum(vmax, hi)


# --- CUDA kernel -----------------------------------------------------------

# the kernel's digits of the key, from the top (csrc/clip_bounds.cu
# digit_bits), and its launches a call: one radix pass a digit
DIGITS = {torch.uint8: (8,), torch.uint16: (8, 8), torch.float32: (11, 11, 10)}
LAUNCHES = {dtype: len(digits) for dtype, digits in DIGITS.items()}

_THREADS = 256          # csrc/clip_bounds.cu K1_THREADS
_FRAME_WORDS = 8224     # K1_FRAME_WORDS: int32 scratch a frame, zero at rest
_SCRATCH = {}           # (device index, stream) -> int32 scratch, zero at rest


def _blocks_per_frame(n_frames: int, n_items: int) -> int:
    """Blocks of a pass over each row: about four per SM over the whole call,
    never more than the row has loads (``n_items``: 16-byte loads, or
    values) for a 256-thread block."""
    target = -(-4 * 132 // max(n_frames, 1))
    return max(1, min(target, -(-n_items // _THREADS)))


def _scratch(dev: torch.device, n_frames: int) -> torch.Tensor:
    """The kernel's per-frame scratch on the current stream of ``dev``: zero
    at rest, and zero again after each call's last launch; kept per stream,
    since launches on one stream never overlap."""
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < n_frames * _FRAME_WORDS:
        buf = torch.zeros(max(n_frames, 16) * _FRAME_WORDS, dtype=torch.int32, device=dev)
        _SCRATCH[key] = buf
    return buf


def _clip_bounds_cuda(flat: torch.Tensor, q_lo: float, q_hi: float, counter,
                      pairs: bool = False) -> torch.Tensor:
    """The launches over the rows of ``flat`` (N, P); with ``pairs`` over
    its N - 1 overlapping rows of 2·P values (row i starts at row i of
    ``flat``)."""
    _cuda.require_cuda(flat, "clip_bounds")
    n, stride = flat.shape
    p = stride
    if pairs:
        n, p = n - 1, 2 * stride
    ks, fracs = _quantile_plan(p, q_lo, q_hi)
    dev = flat.device
    out = torch.empty((4, n), dtype=torch.float32, device=dev)
    scratch = _scratch(dev, n)
    vec_len = 16 // flat.element_size()
    vec = int(stride % vec_len == 0 and flat.data_ptr() % 16 == 0)
    items = p // vec_len if vec else p
    A = _cuda
    fn = A.function("clip_bounds", "k1_clip_pass",
                    [A.P, A.I32, A.I64, A.I64, A.I32, A.I32] + [A.I32] * 4
                    + [A.F32, A.F32, A.I32, A.I32, A.P, A.I32, A.P, A.I32, A.I32, A.P])
    bpf = _blocks_per_frame(n, items)
    for d in range(LAUNCHES[flat.dtype]):
        A.launch(fn, dev, flat.data_ptr(), A.DTYPE_CODE[flat.dtype], p, stride, n, d, *ks,
                 fracs[0], fracs[1], int(ks[0] != ks[1]), int(ks[2] != ks[3]),
                 scratch.data_ptr(), _FRAME_WORDS, out.data_ptr(), bpf, vec)
        counter.launches += 1
    return out


def int_clip_bounds(frames: torch.Tensor, q_lo: float, q_hi: float) -> torch.Tensor:
    """K1: per-frame (lo, hi, fmin, fmax) of uint8/uint16 frames as a (4, N)
    float32 tensor (``histogram.py:110``)."""
    if frames.dtype not in (torch.uint8, torch.uint16):
        raise ValueError(f"int_clip_bounds takes uint8/uint16, got {frames.dtype}")
    flat = frames.reshape(frames.shape[0], -1)
    if flat.device.type == "cpu":
        return clip_bounds_plain(flat, q_lo, q_hi)
    return _clip_bounds_cuda(flat, q_lo, q_hi, int_clip_bounds)


def float_clip_bounds(frames: torch.Tensor, q_lo: float, q_hi: float) -> torch.Tensor:
    """K1f: the same for NaN-free float32 frames (``histogram.py:142``);
    callers screen NaNs, which would sort above +inf."""
    if frames.dtype != torch.float32:
        raise ValueError(f"float_clip_bounds takes float32, got {frames.dtype}")
    flat = frames.reshape(frames.shape[0], -1)
    if flat.device.type == "cpu":
        return clip_bounds_plain(flat, q_lo, q_hi)
    return _clip_bounds_cuda(flat, q_lo, q_hi, float_clip_bounds)


def pair_clip_bounds(block: torch.Tensor, q_lo: float, q_hi: float) -> torch.Tensor:
    """K1 / K1f over the Siam pair rows of a (k+1, h, w) uint8/uint16/float32
    block: (4, k) float32 bounds of each pair's two planes taken as one row
    (``predictor.py:987-992``).  On the card the kernel reads the rows in
    place, one frame apart; the plain version concatenates them."""
    if block.dtype not in _KEY_BITS or block.shape[0] < 2:
        raise ValueError(f"pair_clip_bounds takes a (k+1, ...) uint8/uint16/float32 block with "
                         f"k >= 1, got {tuple(block.shape)} {block.dtype}")
    flat = block.reshape(block.shape[0], -1)
    if flat.device.type == "cpu":
        return clip_bounds_plain(torch.cat([flat[:-1], flat[1:]], dim=1), q_lo, q_hi)
    return _clip_bounds_cuda(flat, q_lo, q_hi, pair_clip_bounds, pairs=True)


int_clip_bounds.launches = 0
float_clip_bounds.launches = 0
pair_clip_bounds.launches = 0


def clip_bounds(frames: torch.Tensor, q_lo: float, q_hi: float) -> torch.Tensor:
    """Dispatch on dtype: K1 for uint8/uint16, K1f for float32."""
    if frames.dtype == torch.float32:
        return float_clip_bounds(frames, q_lo, q_hi)
    return int_clip_bounds(frames, q_lo, q_hi)

