"""End-to-end smoke recipes (counterpart of ``bio_image_unet_tpu/utils/test.py``;
reference utils/test.py:18-137): random TIFFs → DataProcess → Trainer →
Predict for all five families through the port's facades; success = no
exception.  Each recipe trains with the facade's defaults, so the best
checkpoint is ``<base>/out/model.ckpt``, and runs on the card unless
``device="cpu"`` is passed.  Runnable as
``python -m bio_image_unet_tpu_torch.utils.test``.

The functions' names start with ``test_``, as the reference's do: import the
module (``from bio_image_unet_tpu_torch.utils import test as recipes``), never
the functions, into a pytest file, or pytest collects them as tests.
"""

from __future__ import annotations

import gc
import os
import shutil
import tempfile
import time

import numpy as np

from ..data import tiff


def _make_random_data(base, n=5, shape=(64, 64), movie_frames=20, seed=0):
    rng = np.random.default_rng(seed)
    img_dir = os.path.join(base, "image")
    mask_dir = os.path.join(base, "label")
    os.makedirs(img_dir), os.makedirs(mask_dir)
    for i in range(n):
        tiff.imwrite(os.path.join(img_dir, f"img_{i}.tif"),
                     rng.integers(0, 255, shape, dtype=np.uint8))
        tiff.imwrite(os.path.join(mask_dir, f"img_{i}.tif"),
                     (rng.random(shape) > 0.5).astype(np.uint8) * 255)
    movie = os.path.join(base, "movie.tif")
    tiff.imwrite(movie, rng.integers(0, 255, (movie_frames,) + shape, dtype=np.uint8))
    return img_dir + "/", mask_dir + "/", movie


def test_unet(base_dir=None, num_epochs=4, n_filter=8, device=None):
    """(reference utils/test.py:18-46)"""
    from .. import unet

    base = base_dir or tempfile.mkdtemp(prefix="biu_smoke_")
    img_dir, mask_dir, movie = _make_random_data(base)
    data = unet.DataProcess((img_dir, mask_dir), dim_out=(64, 64), aug_factor=2,
                            data_path=os.path.join(base, "data"), seed=0)
    trainer = unet.Trainer(data, num_epochs=num_epochs, batch_size=4,
                           n_filter=n_filter, save_dir=os.path.join(base, "out"),
                           seed=0, device=device)
    trainer.start()
    unet.Predict(movie, os.path.join(base, "pred.tif"),
                 os.path.join(base, "out", "model.ckpt"), resize_dim=(64, 64),
                 show_progress=False, device=device)
    return base


def test_siam_unet(base_dir=None, num_epochs=4, n_filter=8, device=None):
    """(reference utils/test.py:49-81)"""
    from .. import siam_unet as siam

    base = base_dir or tempfile.mkdtemp(prefix="biu_smoke_")
    rng = np.random.default_rng(0)
    img_dir = os.path.join(base, "image")
    mask_dir = os.path.join(base, "label")
    os.makedirs(img_dir), os.makedirs(mask_dir)
    for i in range(5):  # W-doubled frame pairs
        tiff.imwrite(os.path.join(img_dir, f"img_{i}.tif"),
                     rng.integers(0, 255, (64, 128), dtype=np.uint8))
        tiff.imwrite(os.path.join(mask_dir, f"img_{i}.tif"),
                     (rng.random((64, 64)) > 0.5).astype(np.uint8) * 255)
    movie = os.path.join(base, "movie.tif")
    tiff.imwrite(movie, rng.integers(0, 255, (20, 64, 64), dtype=np.uint8))

    data = siam.DataProcess((img_dir + "/", mask_dir + "/"), dim_out=(64, 64),
                            aug_factor=2, data_path=os.path.join(base, "data"),
                            seed=0)
    trainer = siam.Trainer(data, num_epochs=num_epochs, batch_size=4,
                           n_filter=n_filter, mode="max",
                           save_dir=os.path.join(base, "out"), seed=0, device=device)
    trainer.start()
    siam.Predict(movie, os.path.join(base, "pred.tif"),
                 os.path.join(base, "out", "model.ckpt"), resize_dim=(64, 64),
                 show_progress=False, device=device)
    return base


def test_unet3d(base_dir=None, num_epochs=4, n_filter=8, device=None):
    """(reference utils/test.py:83-111)"""
    from .. import unet3d

    base = base_dir or tempfile.mkdtemp(prefix="biu_smoke_")
    rng = np.random.default_rng(0)
    vol_dir = os.path.join(base, "vol")
    mask_dir = os.path.join(base, "label")
    os.makedirs(vol_dir), os.makedirs(mask_dir)
    for i in range(2):
        tiff.imwrite(os.path.join(vol_dir, f"v_{i}.tif"),
                     rng.integers(0, 255, (16, 64, 64), dtype=np.uint8))
        tiff.imwrite(os.path.join(mask_dir, f"v_{i}.tif"),
                     (rng.random((16, 64, 64)) > 0.5).astype(np.uint8) * 255)
    data = unet3d.DataProcess((vol_dir + "/", mask_dir + "/"),
                              dim_out=(16, 64, 64), aug_factor=2,
                              data_path=os.path.join(base, "data"), seed=0)
    trainer = unet3d.Trainer(data, num_epochs=num_epochs, batch_size=2,
                             n_filter=n_filter, save_dir=os.path.join(base, "out"),
                             seed=0, device=device)
    trainer.start()
    vol = rng.integers(0, 255, (16, 64, 64), dtype=np.uint8)
    unet3d.Predict(vol, os.path.join(base, "pred.tif"),
                   os.path.join(base, "out", "model.ckpt"),
                   resize_dim=(16, 64, 64), show_progress=False, device=device)
    return base


def test_multi_output_unet(base_dir=None, num_epochs=4, n_filter=8, device=None):
    """Beyond the reference script (its multi_output packages have no test
    coverage): the same random-data recipe through the multi-head 2D
    family."""
    from .. import multi_output_unet as mo

    base = base_dir or tempfile.mkdtemp(prefix="biu_smoke_")
    rng = np.random.default_rng(0)
    img_dir = os.path.join(base, "image")
    mask_dir = os.path.join(base, "mask")
    os.makedirs(img_dir), os.makedirs(mask_dir)
    for i in range(3):
        tiff.imwrite(os.path.join(img_dir, f"s{i}.tif"),
                     rng.integers(0, 255, (64, 64)).astype(np.uint8))
        tiff.imwrite(os.path.join(mask_dir, f"s{i}.tif"),
                     (rng.random((64, 64)) > 0.5).astype(np.float32))
    heads = {"mask": {"channels": 1, "activation": "sigmoid",
                      "loss": "BCEDiceLoss", "weight": 1.0}}
    data = mo.DataProcess(img_dir, [mask_dir], {"mask": "mask"},
                          data_dir=os.path.join(base, "data"),
                          dim_out=(32, 32), aug_factor=2)
    trainer = mo.Trainer(data, num_epochs=num_epochs, batch_size=2,
                         n_filter=n_filter, output_heads=heads,
                         save_dir=os.path.join(base, "out"), device=device)
    trainer.start()
    mo.Predict(rng.integers(0, 255, (64, 64)).astype(np.uint8),
               os.path.join(base, "out", "model.ckpt"),
               result_path=os.path.join(base, "results"),
               max_patch_size=(32, 32), show_progress=False, device=device)
    return base


def test_multi_output_unet3d(base_dir=None, num_epochs=4, n_filter=8, device=None):
    """Beyond the reference script: the multi-head 3D family."""
    from .. import multi_output_unet3d as mo3d

    base = base_dir or tempfile.mkdtemp(prefix="biu_smoke_")
    rng = np.random.default_rng(0)
    vol_dir = os.path.join(base, "volume")
    mask_dir = os.path.join(base, "mask")
    os.makedirs(vol_dir), os.makedirs(mask_dir)
    for i in range(2):
        tiff.imwrite(os.path.join(vol_dir, f"v{i}.tif"),
                     rng.integers(0, 255, (12, 32, 32)).astype(np.uint8))
        tiff.imwrite(os.path.join(mask_dir, f"v{i}.tif"),
                     (rng.random((12, 32, 32)) > 0.5).astype(np.float32))
    heads = {"mask": {"channels": 1, "activation": "sigmoid",
                      "loss": "BCEDiceLoss", "weight": 1.0}}
    data = mo3d.DataProcess(vol_dir, [mask_dir],
                            data_dir=os.path.join(base, "data"),
                            dim_out=(8, 16, 16), aug_factor=2)
    trainer = mo3d.Trainer(data, heads, num_epochs, batch_size=2,
                           n_filter=n_filter, use_interpolation=True,
                           save_dir=os.path.join(base, "out"), device=device)
    trainer.start()
    mo3d.Predict(rng.integers(0, 255, (12, 32, 32)).astype(np.uint8),
                 os.path.join(base, "out", "model.ckpt"),
                 result_path=os.path.join(base, "results"),
                 max_patch_size=(8, 16, 16), overlap_factor=0.2,
                 show_progress=False, device=device)
    return base


def delete_folder_with_retry(path, retries: int = 3, delay: float = 0.5):
    """(reference utils/test.py:114-128 — Windows file-lock workaround)"""
    for attempt in range(retries):
        try:
            shutil.rmtree(path)
            return
        except PermissionError:
            gc.collect()
            time.sleep(delay)
    shutil.rmtree(path, ignore_errors=True)


if __name__ == "__main__":
    for fn in (test_unet, test_siam_unet, test_unet3d,
               test_multi_output_unet, test_multi_output_unet3d):
        base = fn(num_epochs=2, n_filter=4)
        delete_folder_with_retry(base)
    print("Tests completed successfully")
