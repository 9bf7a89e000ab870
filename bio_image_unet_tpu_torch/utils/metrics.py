"""Segmentation evaluation metrics (counterpart of
``bio_image_unet_tpu/utils/metrics.py``).

The reference has no metric utilities; these score masks by intersection
over union, Dice and pixel accuracy.  Inputs may be numpy arrays or torch
tensors (on any device; they are brought to the host) of probabilities or
binary masks; the results are Python floats.
"""

from __future__ import annotations

import numpy as np
import torch


def _host(x) -> np.ndarray:
    """``x`` as a numpy array; a tensor is detached and copied to the host
    (bfloat16, which numpy lacks, as float32)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def _binarize(x, threshold: float):
    """``threshold`` is on the [0, 1] probability scale; inputs on a wider
    scale rescale it by the VALUE range actually present — [0,1] floats,
    0–255 masks/predictions (any dtype: uint8 masks, the library's float16
    ·255 saved tifs, masks loaded as default int), or 0–65535 code points.
    Dtype width alone is not the scale: an int64 array holding 0/255 is a
    255-scale mask."""
    x = _host(x)
    if x.size == 0:
        return x >= threshold
    mx = float(np.nanmax(x))
    scale = 1.0 if mx <= 1.0 else (255.0 if mx <= 255.0 else 65535.0)
    return x >= threshold * scale


def iou(pred, target, threshold: float = 0.5, eps: float = 1e-9) -> float:
    """Intersection-over-union of binarized masks (Jaccard index)."""
    p = _binarize(pred, threshold)
    t = _binarize(target, threshold)
    inter = np.logical_and(p, t).sum()
    union = np.logical_or(p, t).sum()
    return float((inter + eps) / (union + eps))


def dice_coefficient(pred, target, threshold: float = 0.5, eps: float = 1e-9) -> float:
    """Sørensen–Dice coefficient of binarized masks."""
    p = _binarize(pred, threshold)
    t = _binarize(target, threshold)
    inter = np.logical_and(p, t).sum()
    return float((2.0 * inter + eps) / (p.sum() + t.sum() + eps))


def pixel_accuracy(pred, target, threshold: float = 0.5) -> float:
    """Fraction of pixels whose binarized prediction matches the target."""
    p = _binarize(pred, threshold)
    t = _binarize(target, threshold)
    return float(np.mean(p == t))
