"""Binary morphology for mask preprocessing (the port's copy of
``bio_image_unet_tpu/data/morphology.py``, numpy/scipy only).

The reference depends on ``skimage.morphology`` (skeletonize, binary_erosion,
binary_dilation, disk, square) for its mask-editing options
(bio_image_unet/unet/data.py:124-168, siam_unet/data.py:155-183).  This module
provides the same operations on top of scipy.ndimage plus a vectorized
Zhang–Suen thinning for ``skeletonize`` — all host-side, since these run once
during offline dataset preparation.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage


def disk(radius: int) -> np.ndarray:
    """Circular footprint: True where x²+y² ≤ r² (skimage.morphology.disk)."""
    r = int(radius)
    y, x = np.ogrid[-r : r + 1, -r : r + 1]
    return (x * x + y * y) <= r * r


def square(width: int) -> np.ndarray:
    """Square footprint of ones (skimage.morphology.square)."""
    return np.ones((int(width), int(width)), dtype=bool)


def binary_erosion(mask: np.ndarray, footprint: np.ndarray = None) -> np.ndarray:
    mask = np.asarray(mask) > 0
    if footprint is None:
        footprint = ndimage.generate_binary_structure(mask.ndim, 1)
    return ndimage.binary_erosion(mask, structure=footprint, border_value=1)


def binary_dilation(mask: np.ndarray, footprint: np.ndarray = None) -> np.ndarray:
    mask = np.asarray(mask) > 0
    if footprint is None:
        footprint = ndimage.generate_binary_structure(mask.ndim, 1)
    return ndimage.binary_dilation(mask, structure=footprint, border_value=0)


def erosion(image: np.ndarray, footprint: np.ndarray) -> np.ndarray:
    """Grayscale erosion (minimum filter over the footprint)."""
    return ndimage.grey_erosion(image, footprint=footprint)


def dilation(image: np.ndarray, footprint: np.ndarray) -> np.ndarray:
    """Grayscale dilation (maximum filter over the footprint)."""
    return ndimage.grey_dilation(image, footprint=footprint)


def binary_opening(mask: np.ndarray, footprint: np.ndarray = None) -> np.ndarray:
    mask = np.asarray(mask) > 0
    if footprint is None:
        footprint = ndimage.generate_binary_structure(mask.ndim, 1)
    return ndimage.binary_opening(mask, structure=footprint)


# --- Zhang–Suen thinning ------------------------------------------------------

# Neighbor order P2..P9 clockwise starting from north, as (dy, dx) offsets.
_NEIGHBOR_OFFSETS = [(-1, 0), (-1, 1), (0, 1), (1, 1), (1, 0), (1, -1), (0, -1), (-1, -1)]


def _neighbors(padded: np.ndarray):
    """Stack the 8 neighbor planes of the (padded) binary image, P2..P9."""
    h, w = padded.shape[0] - 2, padded.shape[1] - 2
    return np.stack(
        [padded[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w] for dy, dx in _NEIGHBOR_OFFSETS]
    )


def skeletonize(mask: np.ndarray) -> np.ndarray:
    """Thin a binary mask to a 1-pixel-wide skeleton (Zhang–Suen, 1984).

    Capability equivalent of ``skimage.morphology.skeletonize`` used by the
    reference's ``skeletonize`` mask option (unet/data.py:150-152); the exact
    skeleton may differ by single pixels from skimage's lookup-table thinning.
    """
    img = (np.asarray(mask) > 0).astype(np.uint8)
    if img.ndim != 2:
        raise ValueError(f"skeletonize expects a 2-D mask, got shape {img.shape}")

    while True:
        changed = False
        for sub in (0, 1):
            padded = np.pad(img, 1)
            nb = _neighbors(padded)  # (8, H, W), order P2..P9
            b = nb.sum(axis=0)
            # A(p): number of 0→1 transitions in the circular sequence P2..P9,P2.
            nxt = np.roll(nb, -1, axis=0)
            a = np.sum((nb == 0) & (nxt == 1), axis=0)
            p2, p4, p6, p8 = nb[0], nb[2], nb[4], nb[6]
            if sub == 0:
                cond = (p2 * p4 * p6 == 0) & (p4 * p6 * p8 == 0)
            else:
                cond = (p2 * p4 * p8 == 0) & (p2 * p6 * p8 == 0)
            delete = (img == 1) & (b >= 2) & (b <= 6) & (a == 1) & cond
            if delete.any():
                img[delete] = 0
                changed = True
        if not changed:
            return img.astype(bool)
