"""Percentile normalization: the host version and K2, the fused
normalize → reflect pad → uint8 → tile stage of the device pipeline.

Host side (numpy, counterpart of ``predictor.py:30-84``): ``_int_percentile``,
``_percentile`` and ``_normalize_stack`` are copies of the JAX package's
host-staged normalization, percentiles in float64.

K2 (counterpart of ``predictor.py:742-755``: ``:203 _normalize_clip``, the
reflect pad, ``astype(uint8)``, ``:102 _extract_tiles`` and the batch padded
by the last tile): ``normalize_tile(frames, bounds, plan, n_total, invert)``
maps (F, H, W) uint8/uint16/float32 frames and (4, F) or (4, 1) float32
``(lo, hi, fmin, fmax)`` bounds to (n_total, th, tw) uint8 tiles in
frame-major grid order; tiles past the chunk's F·nx·ny repeat the last one.
On a CUDA tensor the wrapper launches ``csrc/normalize_tile.cu`` (a block a
strip of one tile, 16 outputs a thread, uint8 frames through a per-frame
table of their 256 levels; ``_k2_geometry`` lays out the launch) or raises;
on a CPU tensor it takes the plain PyTorch version.

K2h (counterpart of ``predictor.py:1101-1117``, the multi-head fused
program): ``normalize_tile_float(frames, bounds, plan, n_total, dtype)`` is
K2's float-tile mode — the same clip, min-max, reflect pad and gather with
``scale=1.0`` and no uint8 truncation, the float32 tile cast to the working
``dtype`` (float32, or bfloat16 rounded to nearest even, as the forward's
``astype`` does at ``:455``).  Same kernel source, its own entry point and
launch counter.

K2v (counterpart of ``predictor.py:1222-1235`` in ``Predict3D``'s fused
program and ``:1324-1340`` in ``PredictMultiOutput3D``'s: ``:203
_normalize_clip``, the 3D reflect pad, ``:158 _extract_tiles_3d`` over the
``:143 _tile_plan_3d`` grid and the batch padded by the last tile):
``normalize_tile_3d(vols, bounds, plan, n_total, invert, out_dtype)`` maps
(V, D, H, W) uint8/uint16/float32 volumes and (4, V) or (4, 1) float32
bounds to (n_total, tz, tx, ty) tiles in volume-major z/x/y grid order.
``out_dtype`` uint8 is ``Predict3D``'s mode (scale 255, ``invert``,
truncation); float32 or bfloat16 is ``PredictMultiOutput3D``'s (scale 1, the
tile cast to the working dtype).  The reflect pad acts only on an axis whose
tile exceeds the volume, by less than the volume's extent.  K2's kernel with
a 3D row map (a tile is tz stacked (tx, ty) tiles, its rows the planes'
rows; ``_k2_geometry`` of tz · tx rows of ty lays out the launch), its own
entry point and launch counter.

K2p (counterpart of the pair stage of ``predictor.py:995-1010`` in
``fused_predict_pairs``: ``_normalize_clip`` of the prev planes ``block[:-1]``
and the cur planes ``block[1:]`` with their pair bounds, ``jnp.pad`` with
zeros after the normalization, ``astype(uint8)``, ``_extract_tiles`` of both
and each set padded by its last tile): ``normalize_tile_pairs(block, bounds,
plan, n_total, invert)`` maps a (k+1, H, W) uint8/uint16/float32 block of
Siam pairs (pair i = frames i, i+1) and (4, k+1) per-frame (``'single'``) or
(4, k) per-pair (``'first'``, ``'all'``) float32 bounds to (2, n_total, th,
tw) uint8 tiles: the prev set, then the cur set.  A pixel past the frame is
0, inverted or not.  Kernel in the same source, its own entry point and
launch counter.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import _cuda


# --- host normalization (numpy) ---------------------------------------------

def _int_percentile(img: np.ndarray, q: float) -> float:
    """Exact percentile of an integer array via bincount (numpy's 'linear'
    rule without the sort)."""
    flat = img.reshape(-1)
    lo = int(flat.min())
    counts = np.bincount(flat.astype(np.int64) - lo)
    cum = np.cumsum(counts)
    pos = (flat.size - 1) * (q / 100.0)
    lo_k, hi_k = int(np.floor(pos)), int(np.ceil(pos))
    v_lo = int(np.searchsorted(cum, lo_k + 1))
    if hi_k == lo_k:
        return float(lo + v_lo)
    v_hi = int(np.searchsorted(cum, hi_k + 1))
    return float(lo + v_lo + (pos - lo_k) * (v_hi - v_lo))


def _percentile(img: np.ndarray, q: float) -> float:
    if img.dtype in (np.uint8, np.uint16, np.int8, np.int16):
        return _int_percentile(img, q)
    return float(np.nanpercentile(img, q))


def _normalize_stack(imgs: np.ndarray, mode: str, clip_threshold, invert: bool = False,
                     scale: float = 255.0) -> np.ndarray:
    """Percentile clip + min-max normalize a (N, ...) stack: 'single' per
    frame, 'first' from the first frame, 'all' from the whole stack."""
    raw = imgs
    imgs = imgs.astype(np.float32)
    if mode == "single":
        out = np.empty_like(imgs)
        for i, img in enumerate(imgs):
            img = np.clip(img, _percentile(raw[i], clip_threshold[0]),
                          _percentile(raw[i], clip_threshold[1]))
            img = img - np.min(img)
            peak = np.max(img)
            if peak > 0:
                img = img / peak * scale
            out[i] = scale - img if invert else img
        return out
    if mode in ("first", "all"):
        ref = raw[0] if mode == "first" else raw
        lo = _percentile(ref, clip_threshold[0])
        hi = _percentile(ref, clip_threshold[1])
        imgs = np.clip(imgs, lo, hi)
        imgs = imgs - np.min(imgs)
        peak = np.max(imgs)
        if peak > 0:
            imgs = imgs / peak * scale
        return scale - imgs if invert else imgs
    raise ValueError(f"normalization_mode {mode} not valid!")


# --- K2 ---------------------------------------------------------------------

def _check_bounds(bounds: torch.Tensor, n_frames: int) -> int:
    if bounds.dtype != torch.float32 or bounds.dim() != 2 or bounds.shape[0] != 4 \
            or bounds.shape[1] not in (1, n_frames):
        raise ValueError(f"bounds must be (4, {n_frames}) or (4, 1) float32, "
                         f"got {tuple(bounds.shape)} {bounds.dtype}")
    return bounds.shape[1]


def _normalize_clip(frames: torch.Tensor, bounds: torch.Tensor, invert: bool,
                    scale: float) -> torch.Tensor:
    """Clip to [lo, hi] and min-max to [0, scale] in float32, per frame or
    volume (``predictor.py:203``); ``bounds`` (4, F) or (4, 1)."""
    lo, hi, fmin, fmax = (b.reshape((-1,) + (1,) * (frames.dim() - 1)) for b in bounds)
    f = torch.minimum(torch.maximum(frames.float(), lo), hi)
    f = torch.where(fmax > fmin, (f - fmin) / (fmax - fmin) * scale,
                    torch.zeros((), dtype=torch.float32, device=f.device))
    return scale - f if invert else f


def _pad_frames_to_tile(f: torch.Tensor, plan, mode: str) -> torch.Tensor:
    pad_h, pad_w = max(0, plan.th - plan.h), max(0, plan.tw - plan.w)
    if pad_h or pad_w:
        f = F.pad(f[:, None], (0, pad_w, 0, pad_h), mode=mode)[:, 0]
    return f


def _extract_tiles(f: torch.Tensor, plan, n_total: int) -> torch.Tensor:
    """(F, H', W') padded frames → (n_total, th, tw) frame-major tiles, the
    batch padded by the last tile (``predictor.py:102``)."""
    th, tw = plan.th, plan.tw
    dev = f.device
    rows = torch.as_tensor((plan.xs[:, None] + np.arange(th)[None]).ravel(), device=dev)
    cols = torch.as_tensor((plan.ys[:, None] + np.arange(tw)[None]).ravel(), device=dev)
    tiles = (f.index_select(1, rows).index_select(2, cols)
             .reshape(f.shape[0], plan.nx, th, plan.ny, tw)
             .permute(0, 1, 3, 2, 4)
             .reshape(f.shape[0] * plan.per_frame, th, tw))
    n = tiles.shape[0]
    if n_total > n:
        tiles = torch.cat([tiles, tiles[-1:].expand(n_total - n, th, tw)])
    return tiles.contiguous()


def normalize_tile_plain(frames: torch.Tensor, bounds: torch.Tensor, plan,
                         n_total: int, invert: bool,
                         out_dtype: torch.dtype = torch.uint8) -> torch.Tensor:
    """Plain PyTorch K2 (``out_dtype`` uint8: scale 255, truncated) and K2h
    (float32 or bfloat16: scale 1)."""
    _check_bounds(bounds, frames.shape[0])
    scale = 255.0 if out_dtype == torch.uint8 else 1.0
    f = _normalize_clip(frames, bounds, invert, scale)
    return _extract_tiles(_pad_frames_to_tile(f, plan, "reflect").to(out_dtype), plan, n_total)


def _check_frames(frames: torch.Tensor, plan, n_total: int, what: str) -> None:
    n_frames = frames.shape[0]
    if tuple(frames.shape[1:]) != (plan.h, plan.w):
        raise ValueError(f"frames {tuple(frames.shape[1:])} do not match the "
                         f"plan's frame {(plan.h, plan.w)}")
    if frames.dtype not in _cuda.DTYPE_CODE:
        raise ValueError(f"{what} takes uint8/uint16/float32, got {frames.dtype}")
    if n_total < n_frames * plan.per_frame:
        raise ValueError(f"n_total {n_total} < {n_frames * plan.per_frame} tiles")


_K2_THREADS = 256  # csrc/normalize_tile.cu K2_THREADS
_K2_RUN = 16       # K2_RUN: outputs a thread where 16 divides the tile width
_K2_ITERS = 4      # runs a thread at most


def _k2_geometry(th: int, tw: int, n_total: int):
    """K2's launch geometry: ``(run, blocks_per_tile, iters)``.  A thread makes
    ``run`` consecutive outputs of one tile row (16 where 16 divides ``tw``,
    else 1), ``iters`` runs a block strip apart; a block of 256 threads
    makes one strip of ``iters · 256 · run`` outputs of one tile, the tile's
    ``blocks_per_tile`` strips in order (the last one cut at the tile's end).
    Block b makes strip ``b % blocks_per_tile`` of tile ``b //
    blocks_per_tile``; its thread's runs start at element ``((strip · iters
    + it) · 256 + thread) · run`` of the tile."""
    run = _K2_RUN if tw % _K2_RUN == 0 else 1
    runs = th * tw // run
    iters = min(_K2_ITERS, -(-runs // _K2_THREADS))
    bpt = -(-runs // (_K2_THREADS * iters))
    if n_total * bpt > 2 ** 31 - 1:
        raise ValueError(f"{n_total} tiles of {th}x{tw} take more blocks than one launch has")
    return run, bpt, iters


def _launch(symbol: str, extra_types, frames, bounds, plan, n_total, invert, extra, out) -> None:
    dev = frames.device
    _cuda.require_cuda(frames, symbol)
    _cuda.require_cuda(bounds, f"{symbol} bounds", dev)
    _cuda.require_cuda(plan.xs_t, f"{symbol} plan", dev)
    fb = _check_bounds(bounds, frames.shape[0])
    A = _cuda
    fn = A.function("normalize_tile", symbol,
                    [A.P, A.I32, A.I32, A.I32, A.P, A.I32, A.P, A.P, A.I32, A.I32,
                     A.I32, A.I32, A.I64, A.I64, A.I32] + extra_types + [A.I32] * 3 + [A.P, A.P])
    A.launch(fn, dev, frames.data_ptr(), A.DTYPE_CODE[frames.dtype], plan.h, plan.w,
             bounds.data_ptr(), fb, plan.xs_t.data_ptr(), plan.ys_t.data_ptr(),
             plan.nx, plan.ny, plan.th, plan.tw, frames.shape[0] * plan.per_frame,
             n_total, int(invert), *extra, *_k2_geometry(plan.th, plan.tw, n_total),
             out.data_ptr())


def normalize_tile(frames: torch.Tensor, bounds: torch.Tensor, plan,
                   n_total: int, invert: bool) -> torch.Tensor:
    """K2 (see the module docstring)."""
    _check_frames(frames, plan, n_total, "normalize_tile")
    if frames.device.type == "cpu":
        return normalize_tile_plain(frames, bounds, plan, n_total, invert)
    out = torch.empty((n_total, plan.th, plan.tw), dtype=torch.uint8, device=frames.device)
    _launch("k2_normalize_tile", [], frames, bounds, plan, n_total, invert, (), out)
    normalize_tile.launches += 1
    return out


normalize_tile.launches = 0


def normalize_tile_float(frames: torch.Tensor, bounds: torch.Tensor, plan,
                         n_total: int, dtype: torch.dtype, invert: bool = False) -> torch.Tensor:
    """K2h (see the module docstring): (n_total, th, tw) tiles in ``dtype``
    (float32 or bfloat16) of the frames normalized to [0, 1] (``1 - v``
    under ``invert``: the int8 calibration of an inverted movie)."""
    _check_frames(frames, plan, n_total, "normalize_tile_float")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"normalize_tile_float writes float32/bfloat16 tiles, got {dtype}")
    if frames.device.type == "cpu":
        return normalize_tile_plain(frames, bounds, plan, n_total, invert, dtype)
    out = torch.empty((n_total, plan.th, plan.tw), dtype=dtype, device=frames.device)
    _launch("k2h_normalize_tile_float", [_cuda.I32], frames, bounds, plan, n_total, invert,
            (int(dtype == torch.bfloat16),), out)
    normalize_tile_float.launches += 1
    return out


normalize_tile_float.launches = 0


# --- K2v ----------------------------------------------------------------------

_OUT_CODE = {torch.uint8: 0, torch.float32: 1, torch.bfloat16: 2}


def normalize_tile_3d_plain(vols: torch.Tensor, bounds: torch.Tensor, plan, n_total: int,
                            invert: bool = False,
                            out_dtype: torch.dtype = torch.uint8) -> torch.Tensor:
    """Plain PyTorch K2v."""
    n_vols = vols.shape[0]
    _check_bounds(bounds, n_vols)
    f = _normalize_clip(vols, bounds, invert, 255.0 if out_dtype == torch.uint8 else 1.0)
    pads = [max(0, t - e) for t, e in zip(plan.tile, (plan.d, plan.h, plan.w))]
    if any(pads):
        f = F.pad(f[:, None], (0, pads[2], 0, pads[1], 0, pads[0]), mode="reflect")[:, 0]
    f = f.to(out_dtype)
    for axis, (starts, t) in enumerate(zip((plan.zs, plan.xs, plan.ys), plan.tile), start=1):
        idx = torch.as_tensor((starts[:, None] + np.arange(t)[None]).ravel(), device=f.device)
        f = f.index_select(axis, idx)
    tz, tx, ty = plan.tile
    tiles = (f.reshape(n_vols, plan.nz, tz, plan.nx, tx, plan.ny, ty)
             .permute(0, 1, 3, 5, 2, 4, 6)
             .reshape(n_vols * plan.per_volume, tz, tx, ty))
    n = tiles.shape[0]
    if n_total > n:
        tiles = torch.cat([tiles, tiles[-1:].expand(n_total - n, tz, tx, ty)])
    return tiles.contiguous()


def normalize_tile_3d(vols: torch.Tensor, bounds: torch.Tensor, plan, n_total: int,
                      invert: bool = False,
                      out_dtype: torch.dtype = torch.uint8) -> torch.Tensor:
    """K2v (see the module docstring)."""
    if vols.dim() != 4 or tuple(vols.shape[1:]) != (plan.d, plan.h, plan.w):
        raise ValueError(f"volumes {tuple(vols.shape)} are not (V, {plan.d}, {plan.h}, "
                         f"{plan.w})")
    if vols.dtype not in _cuda.DTYPE_CODE:
        raise ValueError(f"normalize_tile_3d takes uint8/uint16/float32, got {vols.dtype}")
    if out_dtype not in _OUT_CODE:
        raise ValueError(f"normalize_tile_3d writes uint8/float32/bfloat16, got {out_dtype}")
    if n_total < vols.shape[0] * plan.per_volume:
        raise ValueError(f"n_total {n_total} < {vols.shape[0] * plan.per_volume} tiles")
    if any(t - e >= e for t, e in zip(plan.tile, (plan.d, plan.h, plan.w))):
        raise ValueError(f"tile {plan.tile} is 2x or more the volume {(plan.d, plan.h, plan.w)}:"
                         " the reflect pad cannot reach")
    if vols.device.type == "cpu":
        return normalize_tile_3d_plain(vols, bounds, plan, n_total, invert, out_dtype)
    dev = vols.device
    _cuda.require_cuda(vols, "normalize_tile_3d")
    _cuda.require_cuda(bounds, "normalize_tile_3d bounds", dev)
    _cuda.require_cuda(plan.zs_t, "normalize_tile_3d plan", dev)
    fb = _check_bounds(bounds, vols.shape[0])
    out = torch.empty((n_total,) + plan.tile, dtype=out_dtype, device=dev)
    A = _cuda
    tz, tx, ty = plan.tile
    fn = A.function("normalize_tile", "k2v_normalize_tile_3d",
                    [A.P, A.I32, A.I32, A.I32, A.I32, A.P, A.I32, A.P, A.P, A.P]
                    + [A.I32] * 6 + [A.I64, A.I64] + [A.I32] * 5 + [A.P, A.P])
    A.launch(fn, dev, vols.data_ptr(), A.DTYPE_CODE[vols.dtype], plan.d, plan.h, plan.w,
             bounds.data_ptr(), fb, plan.zs_t.data_ptr(), plan.xs_t.data_ptr(),
             plan.ys_t.data_ptr(), plan.nz, plan.nx, plan.ny, tz, tx, ty,
             vols.shape[0] * plan.per_volume, n_total, int(invert), _OUT_CODE[out_dtype],
             *_k2_geometry(tz * tx, ty, n_total), out.data_ptr())
    normalize_tile_3d.launches += 1
    return out


normalize_tile_3d.launches = 0


# --- K2p ----------------------------------------------------------------------

def _pair_bounds(bounds: torch.Tensor, k: int):
    """The prev and cur planes' bounds of k pairs: per source frame from a
    (4, k+1) table, per pair from (4, k), global from (4, 1)."""
    if bounds.dtype != torch.float32 or bounds.dim() != 2 or bounds.shape[0] != 4 \
            or bounds.shape[1] not in (1, k, k + 1):
        raise ValueError(f"pair bounds must be (4, {k + 1}), (4, {k}) or (4, 1) float32, "
                         f"got {tuple(bounds.shape)} {bounds.dtype}")
    if bounds.shape[1] == k + 1:
        return bounds[:, :-1], bounds[:, 1:]
    return bounds, bounds


def normalize_tile_pairs_plain(block: torch.Tensor, bounds: torch.Tensor, plan,
                               n_total: int, invert: bool) -> torch.Tensor:
    """Plain PyTorch K2p, the JAX pair program's steps in order."""
    k = block.shape[0] - 1
    pb, cb = _pair_bounds(bounds, k)
    sets = []
    for planes, b in ((block[:-1], pb), (block[1:], cb)):
        f = _pad_frames_to_tile(_normalize_clip(planes, b, invert, 255.0), plan, "constant")
        sets.append(_extract_tiles(f.to(torch.uint8), plan, n_total))
    return torch.stack(sets)


def normalize_tile_pairs(block: torch.Tensor, bounds: torch.Tensor, plan, n_total: int,
                         invert: bool) -> torch.Tensor:
    """K2p (see the module docstring)."""
    if block.dim() != 3 or block.shape[0] < 2:
        raise ValueError(f"normalize_tile_pairs takes a (k+1, H, W) block with k >= 1, "
                         f"got {tuple(block.shape)}")
    k = block.shape[0] - 1
    _check_frames(block[1:], plan, n_total, "normalize_tile_pairs")
    _pair_bounds(bounds, k)
    if block.device.type == "cpu":
        return normalize_tile_pairs_plain(block, bounds, plan, n_total, invert)
    dev = block.device
    _cuda.require_cuda(block, "normalize_tile_pairs")
    _cuda.require_cuda(bounds, "normalize_tile_pairs bounds", dev)
    _cuda.require_cuda(plan.xs_t, "normalize_tile_pairs plan", dev)
    out = torch.empty((2, n_total, plan.th, plan.tw), dtype=torch.uint8, device=dev)
    A = _cuda
    fn = A.function("normalize_tile", "k2p_normalize_tile_pairs",
                    [A.P, A.I32, A.I32, A.I32, A.P, A.I32, A.I32, A.P, A.P, A.I32, A.I32,
                     A.I32, A.I32, A.I64, A.I64, A.I32, A.P, A.P])
    A.launch(fn, dev, block.data_ptr(), A.DTYPE_CODE[block.dtype], plan.h, plan.w,
             bounds.data_ptr(), bounds.shape[1], k, plan.xs_t.data_ptr(), plan.ys_t.data_ptr(),
             plan.nx, plan.ny, plan.th, plan.tw, k * plan.per_frame, n_total, int(invert),
             out.data_ptr())
    normalize_tile_pairs.launches += 1
    return out


normalize_tile_pairs.launches = 0
