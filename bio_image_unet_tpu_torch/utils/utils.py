"""I/O utilities (counterpart of ``bio_image_unet_tpu/utils/utils.py``):
``save_as_tif`` and ``png_to_grayscale_tiff``."""

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


def png_to_grayscale_tiff(png_filename, tiff_filename) -> None:
    """Read a PNG, convert to grayscale, normalize by its max to [0, 255]
    uint8, save as TIFF (reference: utils/utils.py:25-53).  PIL is imported
    here, so the package imports without it."""
    from PIL import Image

    image = Image.open(png_filename).convert("L")
    arr = np.array(image).astype(np.float64)
    peak = arr.max()
    if peak > 0:
        arr = arr / peak * 255
    tiff.imwrite(tiff_filename, arr.astype(np.uint8))
