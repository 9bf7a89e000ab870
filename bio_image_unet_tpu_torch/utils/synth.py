"""Synthetic labeled samples for demos, tests and the smoke run (the port's
copy of ``bio_image_unet_tpu/utils/synth.py``: the same recipe draws the same
samples from the same ``np.random.Generator``).

Gaussian blobs of random position and size over a noisy background, labeled
by thresholding the clean signal: learnable but not trivial, so the IoU of a
trained model against the blob truth is a meaningful score."""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["blob_sample"]


def blob_sample(rng: np.random.Generator, shape: Tuple[int, int] = (64, 64),
                n_blobs: int = 6, margin: int = 8,
                radius: Tuple[int, int] = (4, 10), threshold: float = 0.4,
                peak: float = 200.0, noise: float = 8.0):
    """One labeled sample: ``(uint8 image, uint8 mask)`` with mask ∈ {0, 255}.

    ``margin`` keeps blob centers off the borders; ``radius`` is the
    inclusive-exclusive ``rng.integers`` range of blob sigmas; ``threshold``
    binarizes the clean signal into the mask; the image is the signal scaled
    to ``peak`` plus N(0, ``noise``) sensor noise, clipped to uint8."""
    yy, xx = np.mgrid[: shape[0], : shape[1]]
    img = np.zeros(shape, np.float32)
    for _ in range(n_blobs):
        cy = rng.integers(margin, shape[0] - margin)
        cx = rng.integers(margin, shape[1] - margin)
        r = rng.integers(radius[0], radius[1])
        img += np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r ** 2))
    mask = (img > threshold).astype(np.uint8) * 255
    noisy = np.clip(img / max(img.max(), 1e-6) * peak
                    + rng.normal(0, noise, shape), 0, 255)
    return noisy.astype(np.uint8), mask
