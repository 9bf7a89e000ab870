"""Folder-level image utilities (counterpart of
``bio_image_unet_tpu/tools/imageops.py``; reference
siam_unet/helpers/average_tifs.py, threshold_images.py,
generate_plain_image.py, create_pixel_value_histogram.py).  Host only;
matplotlib is imported when a histogram is drawn."""

from __future__ import annotations

import glob
import os
from typing import Sequence

import numpy as np

from ..data import tiff


def average_tifs(input_paths: Sequence[str], output_path) -> None:
    """Frame-wise average of several equal-length movies
    (reference average_tifs.py)."""
    readers = [tiff.TiffReader(p) for p in input_paths]
    try:
        n_pages = min(r.n_pages for r in readers)
        with tiff.TiffWriter(output_path) as writer:
            for i in range(n_pages):
                acc = np.zeros(readers[0].page_shape(i), dtype=np.float64)
                for r in readers:
                    acc += r.read_page(i)
                writer.write((acc / len(readers)).astype(np.float32))
    finally:
        for r in readers:
            r.close()


def threshold_images(input_dir, output_dir, threshold: float = 150,
                     invert: bool = False) -> int:
    """Binarize (≥threshold → 255) and optionally invert every tif in a folder
    (reference threshold_images.py; default threshold 150)."""
    os.makedirs(output_dir, exist_ok=True)
    n = 0
    for path in sorted(glob.glob(os.path.join(input_dir, "*.tif"))):
        img = tiff.imread(path).astype(np.float32)
        out = np.where(img >= threshold, 255, 0).astype(np.uint8)
        if invert:
            out = 255 - out
        tiff.imwrite(os.path.join(output_dir, os.path.basename(path)), out)
        n += 1
    return n


def generate_plain_image(shape=(512, 512), value: int = 128, output=None) -> np.ndarray:
    """Constant-value test image (reference generate_plain_image.py)."""
    img = np.full(shape, value, dtype=np.uint8)
    if output is not None:
        tiff.imwrite(output, img)
    return img


def create_pixel_value_histogram(movie_path, output_dir, frames_per_plot: int = 10,
                                 bins: int = 64) -> list:
    """Pixel-value histograms of a movie every N frames
    (reference create_pixel_value_histogram.py), saved as PNGs."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(output_dir, exist_ok=True)
    written = []
    with tiff.TiffReader(movie_path) as reader:
        for i in range(0, reader.n_pages, frames_per_plot):
            frame = reader.read_page(i)
            fig, ax = plt.subplots()
            ax.hist(np.asarray(frame).ravel(), bins=bins)
            ax.set_title(f"frame {i}")
            ax.set_xlabel("pixel value")
            ax.set_ylabel("count")
            path = os.path.join(output_dir, f"hist_{i:06d}.png")
            fig.savefig(path, dpi=100)
            plt.close(fig)
            written.append(path)
    return written
