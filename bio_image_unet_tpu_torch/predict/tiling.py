"""Host tile grids and the host mean stitch (counterpart of
``bio_image_unet_tpu/predict/tiling.py:21 grid_starts`` and ``:58 stitch_mean``),
plus the static tile plan the device stages share."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def grid_starts(extent: int, tile: int, add: int = 0) -> np.ndarray:
    """``ceil(extent/tile)+add`` linspace-spaced start offsets over
    [0, extent - tile] (reference unet/predict.py:154-172)."""
    n = int(np.ceil(extent / tile)) + add
    return np.linspace(0, max(extent - tile, 0), max(n, 1)).astype(int)


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
    uploaded once so that no chunk pays a host-to-device copy for them."""

    def __init__(self, h: int, w: int, th: int, tw: int, xs, ys, device):
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
