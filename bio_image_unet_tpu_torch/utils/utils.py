"""I/O utilities (counterpart of ``bio_image_unet_tpu/utils/utils.py``)."""

from __future__ import annotations

import numpy as np

from ..data import tiff


def save_as_tif(imgs, filename, normalize: bool = False) -> None:
    """Save an array as a float16 TIFF.  ``normalize=True`` rescales the data
    to [0, 255] first (the reference accepts the flag but ignores it)."""
    imgs = np.asarray(imgs)
    if normalize:
        lo, hi = float(np.nanmin(imgs)), float(np.nanmax(imgs))
        scale = 255.0 / (hi - lo) if hi > lo else 0.0
        imgs = (imgs - lo) * scale
    tiff.imwrite(filename, imgs.astype("float16"))
