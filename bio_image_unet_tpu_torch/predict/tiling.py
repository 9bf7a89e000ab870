"""Host tile grids and host stitches (counterpart of
``bio_image_unet_tpu/predict/tiling.py``: ``:21 grid_starts``, ``:28
overlap_starts``, ``:38 _accumulate``, ``:58 stitch_mean``, ``:72
_margin_weights``, ``:91 _margin_factors``, ``:113 _blend_factors``, ``:131
stitch_margin``, ``:147 _blend_weights``, ``:183 stitch_blend3d``), plus the
static tile plans the device stages share (frames: :class:`TilePlan`;
volumes: :class:`TilePlan3D`) and the static uncovered mask of a
safe-margin grid."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


def grid_starts(extent: int, tile: int, add: int = 0) -> np.ndarray:
    """``ceil(extent/tile)+add`` linspace-spaced start offsets over
    [0, extent - tile] (reference unet/predict.py:154-172)."""
    n = int(np.ceil(extent / tile)) + add
    return np.linspace(0, max(extent - tile, 0), max(n, 1)).astype(int)


def overlap_starts(extent: int, tile: int, overlap_factor: float) -> List[int]:
    """Stride grid of ``PredictMultiOutput3D`` (``tiling.py:28``): stride
    ``int(tile·(1−overlap))`` (at least 1), plus a flush-right start."""
    stride = max(1, int(tile * (1.0 - overlap_factor)))
    starts = list(range(0, max(extent - tile + 1, 1), stride))
    if starts[-1] + tile < extent:
        starts.append(extent - tile)
    return starts


def stitch_mean(patches: np.ndarray, starts_per_axis: Sequence[np.ndarray],
                out_spatial: Tuple[int, ...]) -> np.ndarray:
    """Plain mean of overlapping (N, *tile, C) patches in grid order →
    (*out_spatial, C) float32 (equals the reference's NaN-stack nanmean)."""
    channels = patches.shape[-1]
    tile = patches.shape[1:-1]
    result = np.zeros(tuple(out_spatial) + (channels,), np.float32)
    weight = np.zeros_like(result)
    grids = np.meshgrid(*[np.asarray(s) for s in starts_per_axis], indexing="ij")
    starts = np.stack([g.ravel() for g in grids], axis=1)
    for patch, st in zip(patches.astype(np.float32), starts):
        sl = tuple(slice(int(s), int(s) + t) for s, t in zip(st, tile))
        result[sl] += patch
        weight[sl] += 1.0
    np.divide(result, weight, out=result, where=weight > 0)
    return result


def _accumulate(patches, weights, starts_per_axis, out_shape):
    """Scatter-add ``patches·weights`` and ``weights`` into float32 (result,
    weight) planes, patches in grid order (``tiling.py:38``)."""
    result = np.zeros(out_shape, dtype=np.float32)
    weight = np.zeros(out_shape, dtype=np.float32)
    tile = patches.shape[1:]
    idx_grids = np.meshgrid(*[np.arange(len(s)) for s in starts_per_axis], indexing="ij")
    flat = [g.ravel() for g in idx_grids]
    for n in range(patches.shape[0]):
        sl = tuple(slice(starts_per_axis[a][flat[a][n]], starts_per_axis[a][flat[a][n]] + tile[a])
                   for a in range(len(starts_per_axis)))
        result[sl] += patches[n] * weights[n]
        weight[sl] += weights[n]
    return result, weight


def _margin_weights(grid_shape: Sequence[int], tile: Sequence[int], margin: int) -> np.ndarray:
    """Binary (n_tiles, *tile, 1) weights: a ``margin``-wide border zeroed on
    the sides that overlap a neighbour (``tiling.py:72``).  ``margin=0`` keeps
    the reference's quirk: ``slice(-0, None)`` is the whole axis, so every
    tile but the last along an axis is zeroed entirely."""
    weights = []
    for idx in np.ndindex(*grid_shape):
        w = np.ones(tuple(tile) + (1,), dtype=np.float32)
        for a, (i, n) in enumerate(zip(idx, grid_shape)):
            sl = [slice(None)] * (len(tile) + 1)
            if i > 0:
                sl[a] = slice(0, margin)
                w[tuple(sl)] = 0
            if i < n - 1:
                sl[a] = slice(-margin, None)
                w[tuple(sl)] = 0
        weights.append(w)
    return np.stack(weights)


def _margin_factors(grid_shape: Sequence[int], tile: Sequence[int],
                    margin: int) -> List[np.ndarray]:
    """Per-axis (n_a, t_a) float32 factor tables whose outer MIN is
    :func:`_margin_weights` (``tiling.py:91``), ``margin=0`` quirk included."""
    factors = []
    for n, t in zip(grid_shape, tile):
        f = np.ones((n, t), np.float32)
        for i in range(n):
            if i > 0:
                f[i, :margin] = 0
            if i < n - 1:
                f[i, (max(t - margin, 0) if margin > 0 else 0):] = 0
        factors.append(f)
    return factors


def _blend_factors(grid_shape: Sequence[int], tile: Sequence[int],
                   margin: int) -> List[np.ndarray]:
    """Per-axis (n_a, t_a) float32 factor tables whose outer MIN is
    :func:`_blend_weights` (``tiling.py:113``): a 0 → (m−1)/margin ramp on
    each side that overlaps a neighbour, m = min(margin, t_a)."""
    factors = []
    for n, t in zip(grid_shape, tile):
        f = np.ones((n, t), np.float32)
        m = min(margin, t)
        ramp = np.arange(m, dtype=np.float32) / margin
        for i in range(n):
            if i > 0:
                f[i, :m] = np.minimum(f[i, :m], ramp)
            if i < n - 1:
                f[i, t - m:] = np.minimum(f[i, t - m:], ramp[::-1])
        factors.append(f)
    return factors


def _blend_weights(grid_shape: Sequence[int], tile: Sequence[int], margin: int) -> np.ndarray:
    """Dense (n_tiles, *tile, 1) linear-blend weights (``tiling.py:147``):
    per axis the symmetric ramp of :func:`_blend_factors`, combined by
    ``np.minimum`` (the JAX package's documented divergence from the
    reference's clobbering loops)."""
    weights = []
    for idx in np.ndindex(*grid_shape):
        w = np.ones(tuple(tile) + (1,), dtype=np.float32)
        for a, (i, n) in enumerate(zip(idx, grid_shape)):
            m = min(margin, tile[a])
            ramp = np.arange(m, dtype=np.float32) / margin
            shape = [1] * (len(tile) + 1)
            shape[a] = m
            if i > 0:
                sl = [slice(None)] * (len(tile) + 1)
                sl[a] = slice(0, m)
                w[tuple(sl)] = np.minimum(w[tuple(sl)], ramp.reshape(shape))
            if i < n - 1:
                sl = [slice(None)] * (len(tile) + 1)
                sl[a] = slice(tile[a] - m, None)
                w[tuple(sl)] = np.minimum(w[tuple(sl)], ramp[::-1].reshape(shape))
        weights.append(w)
    return np.stack(weights)


def stitch_blend3d(patches: np.ndarray, starts_per_axis: Sequence[Sequence[int]],
                   out_spatial: Tuple[int, ...], blend_margin: int = 16) -> np.ndarray:
    """Linear-blend stitch of (N, *tile, C) 3D patches (``tiling.py:183``);
    voxels no tile weighs are 0."""
    channels = patches.shape[-1]
    w = _blend_weights([len(s) for s in starts_per_axis], patches.shape[1:-1], blend_margin)
    result, weight = _accumulate(patches.astype(np.float32), w, starts_per_axis,
                                 tuple(out_spatial) + (channels,))
    np.divide(result, weight, out=result, where=weight > 0)
    result[np.broadcast_to(weight == 0, result.shape)] = 0.0
    return result


def stitch_margin(patches: np.ndarray, starts_per_axis: Sequence[np.ndarray],
                  out_spatial: Tuple[int, ...], safe_margin: int = 20) -> np.ndarray:
    """Safe-margin stitch of (N, *tile, C) patches (``tiling.py:131``):
    overlap borders weigh 0, uncovered pixels take the patch mean."""
    grid_shape = [len(s) for s in starts_per_axis]
    channels = patches.shape[-1]
    w = _margin_weights(grid_shape, patches.shape[1:-1], safe_margin)
    result, weight = _accumulate(patches.astype(np.float32), w, starts_per_axis,
                                 tuple(out_spatial) + (channels,))
    np.divide(result, weight, out=result, where=weight > 0)
    result[np.broadcast_to(weight == 0, result.shape)] = float(patches.mean())
    return result


def uncovered_mask(starts_per_axis: Sequence[np.ndarray], factors: Sequence[np.ndarray],
                   out_spatial: Tuple[int, ...]) -> np.ndarray:
    """The pixels of ``out_spatial`` whose weight sum is 0 under min-combined
    per-axis ``factors`` (the safe-margin weights): a pixel is covered when
    some tile covers it with a positive factor along every axis.  It depends
    on the grid and the margin only, never on the data."""
    covered = None
    for starts, f, n in zip(starts_per_axis, factors, out_spatial):
        t = f.shape[1]
        cov = np.zeros(n, bool)
        for s, row in zip(np.asarray(starts, np.int64), f):
            seg = cov[s:s + t]
            seg |= row[: len(seg)] > 0
        covered = cov if covered is None else np.logical_and.outer(covered, cov)
    return ~covered


def is_exact(h: int, w: int, th: int, tw: int, xs, ys) -> bool:
    """True when the starts are plain stride-th/tw tiling of the (padded)
    frame: each output pixel is covered by exactly one tile
    (``predictor.py:87 _tile_plan``)."""
    return (tuple(int(v) for v in xs) == tuple(range(0, max(h, th), th))
            and tuple(int(v) for v in ys) == tuple(range(0, max(w, tw), tw))
            and max(h, th) == len(xs) * th and max(w, tw) == len(ys) * tw)


def cover_ranges(starts, tile: int, extent: int) -> Tuple[np.ndarray, np.ndarray]:
    """For each position ``p < extent``, the half-open range [lo, hi) of tile
    indices whose [start, start + tile) covers it (starts ascending)."""
    s = np.asarray(starts, np.int64)
    p = np.arange(extent)
    lo = np.searchsorted(s + tile, p, side="right")
    hi = np.searchsorted(s, p, side="right")
    return lo.astype(np.int32), hi.astype(np.int32)


class TilePlan:
    """The static tiling of one (h, w) frame by (th, tw) tiles at starts
    ``xs`` × ``ys``, with the int32 index tables the device stages read,
    uploaded once so that no chunk pays a host-to-device copy for them.

    With ``factors`` — the (nx, th) and (ny, tw) tables of
    :func:`_margin_factors` — the plan also carries them as float32 on the
    device (``fx_t``, ``fy_t``, read by K5) and ``uncovered``, the (h, w)
    mask of pixels no tile weighs."""

    def __init__(self, h: int, w: int, th: int, tw: int, xs, ys, device,
                 factors: Optional[Sequence[np.ndarray]] = None):
        self.h, self.w, self.th, self.tw = int(h), int(w), int(th), int(tw)
        self.xs = np.asarray(xs, np.int64)
        self.ys = np.asarray(ys, np.int64)
        self.nx, self.ny = len(self.xs), len(self.ys)
        self.per_frame = self.nx * self.ny
        self.exact = is_exact(h, w, th, tw, self.xs, self.ys)
        self.device = torch.device(device)
        row_lo, row_hi = cover_ranges(self.xs, th, h)
        col_lo, col_hi = cover_ranges(self.ys, tw, w)

        def dev(a):
            return torch.as_tensor(np.asarray(a, np.int32), device=self.device)

        self.xs_t, self.ys_t = dev(self.xs), dev(self.ys)
        self.row_lo, self.row_hi = dev(row_lo), dev(row_hi)
        self.col_lo, self.col_hi = dev(col_lo), dev(col_hi)
        self.factors = self.fx_t = self.fy_t = self.uncovered = None
        if factors is not None:
            fx, fy = (np.ascontiguousarray(f, np.float32) for f in factors)
            if fx.shape != (self.nx, th) or fy.shape != (self.ny, tw):
                raise ValueError(f"factor tables {fx.shape}, {fy.shape} do not match the "
                                 f"grid {(self.nx, th)}, {(self.ny, tw)}")
            self.factors = (fx, fy)
            self.fx_t = torch.as_tensor(fx, device=self.device)
            self.fy_t = torch.as_tensor(fy, device=self.device)
            self.uncovered = uncovered_mask((self.xs, self.ys), (fx, fy), (self.h, self.w))


class TilePlan3D:
    """The static tiling of (V, d, h, w) volumes by (tz, tx, ty) tiles at
    starts ``zs`` × ``xs`` × ``ys``, grid order z-major, then x, then y
    (``predictor.py:143 _tile_plan_3d``), with the int32 start and cover
    tables the device stages read, uploaded once.  ``exact`` is the
    one-cover grid (stride-tile starts that span the padded volume).

    With ``factors`` — the (nz, tz), (nx, tx), (ny, ty) tables of
    :func:`_blend_factors` — the plan also carries them as float32 on the
    device (``fz_t``, ``fx_t``, ``fy_t``, read by K5v)."""

    def __init__(self, d: int, h: int, w: int, tile: Sequence[int], zs, xs, ys, device,
                 factors: Optional[Sequence[np.ndarray]] = None):
        self.d, self.h, self.w = int(d), int(h), int(w)
        self.tz, self.tx, self.ty = (int(t) for t in tile)
        self.tile = (self.tz, self.tx, self.ty)
        self.zs, self.xs, self.ys = (np.asarray(s, np.int64) for s in (zs, xs, ys))
        self.nz, self.nx, self.ny = len(self.zs), len(self.xs), len(self.ys)
        self.per_volume = self.nz * self.nx * self.ny
        self.exact = all(
            tuple(int(v) for v in s) == tuple(range(0, max(e, t), t)) and max(e, t) == len(s) * t
            for s, e, t in zip((self.zs, self.xs, self.ys), (self.d, self.h, self.w), self.tile))
        self.device = torch.device(device)

        def dev(a):
            return torch.as_tensor(np.asarray(a, np.int32), device=self.device)

        self.zs_t, self.xs_t, self.ys_t = dev(self.zs), dev(self.xs), dev(self.ys)
        self.z_lo, self.z_hi = (dev(a) for a in cover_ranges(self.zs, self.tz, self.d))
        self.row_lo, self.row_hi = (dev(a) for a in cover_ranges(self.xs, self.tx, self.h))
        self.col_lo, self.col_hi = (dev(a) for a in cover_ranges(self.ys, self.ty, self.w))
        self.factors = self.fz_t = self.fx_t = self.fy_t = None
        if factors is not None:
            facs = tuple(np.ascontiguousarray(f, np.float32) for f in factors)
            want = ((self.nz, self.tz), (self.nx, self.tx), (self.ny, self.ty))
            if tuple(f.shape for f in facs) != want:
                raise ValueError(f"factor tables {[f.shape for f in facs]} do not match the "
                                 f"grid {list(want)}")
            self.factors = facs
            self.fz_t, self.fx_t, self.fy_t = (torch.as_tensor(f, device=self.device)
                                               for f in facs)
