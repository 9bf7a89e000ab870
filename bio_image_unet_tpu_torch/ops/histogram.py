"""K1 / K1f: exact per-frame percentile clip bounds
(counterpart of ``bio_image_unet_tpu/ops/histogram.py``).

``clip_bounds(frames, q_lo, q_hi)`` returns per-frame ``(lo, hi, fmin, fmax)``
as a (4, N) float32 tensor: lo/hi are numpy-'linear' percentiles found from
exact order statistics, fmin/fmax the frame min/max clamped into [lo, hi].
uint8 and uint16 frames take K1 (``int_clip_bounds``), NaN-free float32 frames
K1f (``float_clip_bounds``).  ``pair_clip_bounds(block, q_lo, q_hi)`` is their
Siam pair-row form (``predictor.py:987-992``, ``'all'`` mode): row i is frames
i and i+1 of a (k+1, h, w) block as one row of 2·h·w values, read in place.

On a CUDA tensor the wrapper launches the hand-written kernel
(``csrc/clip_bounds.cu``: a byte-wise radix select) and raises if it cannot;
on a CPU tensor it takes the plain PyTorch version below, which repeats the
JAX package's bitwise binary search step for step.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

from . import _cuda

_N_STAT = 6  # min, floor/ceil of q_lo, floor/ceil of q_hi, max
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


# --- CUDA kernel -----------------------------------------------------------

def _blocks_per_frame(n_frames: int, n_vec: int) -> int:
    """About four blocks per SM over the whole chunk, never more blocks than
    a frame has 16-byte loads for a 256-thread block."""
    target = -(-4 * 132 // max(n_frames, 1))
    return max(1, min(target, -(-n_vec // 256)))


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
    ranks = [0, *ks, p - 1]
    n_digits = _KEY_BITS[flat.dtype] // 8
    dev = flat.device
    hist = torch.zeros((n_digits, n, _N_STAT, 256), dtype=torch.int32, device=dev)
    out = torch.empty((4, n), dtype=torch.float32, device=dev)
    vec_len = 16 // flat.element_size()
    vec = int(stride % vec_len == 0 and flat.data_ptr() % 16 == 0)
    bpf = _blocks_per_frame(n, p // vec_len if vec else p)
    A = _cuda
    hist_fn = A.function("clip_bounds", "k1_hist_pass",
                         [A.P, A.I32, A.I64, A.I64, A.I32, A.I32, A.I32] + [A.I32] * 6
                         + [A.P, A.I32, A.I32, A.P])
    fin_fn = A.function("clip_bounds", "k1_finalize",
                        [A.P, A.I32, A.I32] + [A.I32] * 6
                        + [A.F32, A.F32, A.I32, A.I32, A.I32, A.P, A.P])
    for d in range(n_digits):
        A.launch(hist_fn, dev, flat.data_ptr(), A.DTYPE_CODE[flat.dtype], p, stride, n, d,
                 n_digits, *ranks, hist.data_ptr(), bpf, vec)
        counter.launches += 1
    A.launch(fin_fn, dev, hist.data_ptr(), n, n_digits, *ranks, fracs[0], fracs[1],
             int(ks[0] != ks[1]), int(ks[2] != ks[3]), int(flat.dtype == torch.float32),
             out.data_ptr())
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

