"""Siamese training-input generators (the port's copy of
``bio_image_unet_tpu/tools/siam_inputs.py``; reference
siam_unet/helpers/generate_siam_unet_input_imgs.py): host only, numpy and
the port's TIFF codec."""

from __future__ import annotations

import os
import shutil
from typing import Optional

import numpy as np

from ..data import tiff


def generate_coupled_image(movie, frame: int, output: str) -> None:
    """Write ``[previous | current]`` frames of a movie, side by side, as one
    tif, the Siam input layout (reference :13-34; frame 0 pairs with frame
    1)."""
    with tiff.TiffReader(movie) as reader:
        curr = reader.read_page(frame)
        prev_idx = frame + 1 if frame == 0 else frame - 1
        prev = reader.read_page(min(prev_idx, reader.n_pages - 1))
    tiff.imwrite(output, np.concatenate((prev, curr), axis=1).astype(np.uint8))


def generate_coupled_image_from_self(img, out_img: str, noise_amp: float = 10,
                                     seed: Optional[int] = None) -> None:
    """Make a 'previous frame' by warping the image with a random sinusoidal
    displacement field plus Gaussian noise, then write both side by side
    (reference :37-77)."""
    from scipy.ndimage import geometric_transform

    rng = np.random.default_rng(seed)
    image = tiff.imread(img).astype(np.float64)
    modes_x, modes_y = 10, 4
    amps_x = rng.random(modes_x)
    amps_y = rng.random(modes_y)

    def func(xy):
        return (xy[0] + np.sum(amps_y * np.sin(modes_y * 2 * np.pi * xy[0] / image.shape[0])),
                xy[1] + np.sum(amps_x * np.sin(modes_x * 2 * np.pi * xy[1] / image.shape[1])))

    warped = geometric_transform(image, func)
    warped = np.clip(warped + rng.normal(0, noise_amp, size=image.shape), 0, 255)
    tiff.imwrite(out_img, np.concatenate((warped, image), axis=1).astype(np.uint8))


def utilize_search_result(search_result_mr_txt: str, movie_path_prefix: str,
                          labels_path_prefix: str, output_folder: str) -> None:
    """A Siam training set from frame-search results (reference :80-127): for
    each tab-separated ``label  movie  frame`` line, the coupled image under
    ``output_folder/image/`` and the label (grayscale) under
    ``output_folder/label/``."""
    image_dir = os.path.join(output_folder, "image")
    label_dir = os.path.join(output_folder, "label")
    for d in (image_dir, label_dir):
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d, exist_ok=True)
    with open(search_result_mr_txt) as fh:
        for line in fh:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 3:
                continue
            label_name, movie_name, frame = parts[0], parts[1], int(parts[2])
            generate_coupled_image(os.path.join(movie_path_prefix, movie_name), frame,
                                   os.path.join(image_dir, label_name))
            label = tiff.imread(os.path.join(labels_path_prefix, label_name))
            if label.ndim == 3:  # RGB to grayscale (reference :123-127)
                label = label.mean(axis=-1)
            tiff.imwrite(os.path.join(label_dir, label_name), label.astype(np.uint8))
