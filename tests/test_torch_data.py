"""The port's 2D training-data pipeline, host augmentation, morphology,
loader and synthetic data held against the JAX package's on the same inputs
and seeds.  Tiles must come out bit-equal (after the CHW ↔ HWC move)."""

import os

import numpy as np
import pytest

from bio_image_unet_tpu.data import augment as jaug
from bio_image_unet_tpu.data import morphology as jmorph
from bio_image_unet_tpu.data import pipelines as jpipe
from bio_image_unet_tpu.data import tiff as jtiff
from bio_image_unet_tpu.utils.synth import blob_sample as jblob
from bio_image_unet_tpu_torch.data import augment as taug
from bio_image_unet_tpu_torch.data import morphology as tmorph
from bio_image_unet_tpu_torch.data import pipelines as tpipe
from bio_image_unet_tpu_torch.utils.synth import blob_sample


@pytest.fixture(scope="module")
def blob_tiffs(tmp_path_factory):
    """Three blob movies' worth of single frames (80×72, uint8) and masks."""
    root = tmp_path_factory.mktemp("blobs")
    rng = np.random.default_rng(11)
    for sub in ("image", "label"):
        os.makedirs(root / sub)
    for i in range(3):
        img, mask = blob_sample(rng, (80, 72))
        jtiff.imwrite(str(root / "image" / f"blob {i}.tif"), img)
        jtiff.imwrite(str(root / "label" / f"blob {i}.tif"), mask)
    return (str(root / "image") + "/", str(root / "label") + "/")


CONFIGS = {
    "split": dict(aug_factor=None),
    "aug2": dict(aug_factor=2, seed=3),
    "aug2-dilate-addtile": dict(aug_factor=2, seed=5, dilate_mask=2, add_tile=1),
    "split-erode-square-invert": dict(aug_factor=None, dilate_mask=-1,
                                      dilate_kernel="square", invert=True),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_dataprocess2d_tiles_bit_equal_to_jax(blob_tiffs, tmp_path, name):
    kw = dict(dim_out=(32, 32), **CONFIGS[name])
    ref = jpipe.DataProcess2D(blob_tiffs, data_path=str(tmp_path / "jax"), **kw)
    ours = tpipe.DataProcess2D(blob_tiffs, data_path=str(tmp_path / "port"), **kw)
    assert len(ours) == len(ref) > 0
    for i in range(len(ref)):
        for key in ("image", "mask"):
            a, b = ours[i][key], ref[i][key]
            assert a.dtype == np.float32 and a.shape == (1, 32, 32), (key, a.shape)
            np.testing.assert_array_equal(a, np.moveaxis(b, -1, 0), err_msg=f"{i} {key}")
    # the pipeline draws did something in the augmented configurations
    if kw["aug_factor"]:
        tiles = [ours[i]["image"] for i in range(len(ours))]
        assert any(not np.array_equal(tiles[2 * j], tiles[2 * j + 1])
                   for j in range(len(tiles) // 2))


def test_shift_scale_rotate_close_to_opencv(rng):
    """Non-identity ShiftScaleRotate: the port's scipy warp against the JAX
    package's OpenCV warp on the same draw (reflect-101 border both)."""
    img = (rng.random((64, 64)) * 255).astype(np.uint8)
    mask = ((rng.random((64, 64)) > 0.5) * 255).astype(np.uint8)
    params = {"dx": 0.05, "dy": -0.03, "scale": 1.1, "angle": 25.0}
    ours, ref = taug.ShiftScaleRotate(), jaug.ShiftScaleRotate()
    diff = np.abs(ours.apply(img, params).astype(int) - ref.apply(img, params).astype(int))
    assert np.mean(diff <= 1) >= 0.99 and np.median(diff) == 0, (diff.max(), np.mean(diff > 1))
    same = ours.apply_mask(mask, params) == ref.apply_mask(mask, params)
    assert same.mean() >= 0.97, same.mean()
    ident = {"dx": 0.0, "dy": -0.0, "scale": 1.0, "angle": -0.0}
    np.testing.assert_array_equal(ours.apply(img, ident), ref.apply(img, ident))


@pytest.mark.parametrize("fn", ["dilation", "erosion", "binary_dilation", "binary_erosion",
                                "binary_opening", "skeletonize"])
def test_morphology_matches_jax(rng, fn):
    mask = ((rng.random((40, 36)) > 0.7) * 255).astype(np.uint8)
    mask = jmorph.dilation(mask, jmorph.disk(1))
    if fn == "skeletonize":
        args = (mask,)
    elif fn.startswith("binary"):
        args = (mask, jmorph.square(3))
    else:
        args = (mask, jmorph.disk(2))
    np.testing.assert_array_equal(getattr(tmorph, fn)(*args), getattr(jmorph, fn)(*args))


def test_split_and_loader_order_match_jax():
    class Items:
        def __len__(self):
            return 23

        def __getitem__(self, i):
            return {"image": np.full((1, 2, 2), i, np.float32),
                    "mask": np.full((1, 2, 2), -i, np.float32)}

    t_train, t_val = tpipe.random_split(Items(), 0.2, seed=4)
    j_train, j_val = jpipe.random_split(Items(), 0.2, seed=4)
    assert t_train.indices == j_train.indices and t_val.indices == j_val.indices
    ours = tpipe.DataLoader(t_train, 4, shuffle=True, drop_last=True, seed=4)
    ref = jpipe.DataLoader(j_train, 4, shuffle=True, drop_last=True, seed=4)
    assert len(ours) == len(ref) == 4
    for _ in range(3):  # three epochs: the shuffle stream advances alike
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a["image"], b["image"])
            assert a["image"].shape == (4, 1, 2, 2)
    skipped = tpipe.DataLoader(t_train, 4, shuffle=True, drop_last=True, seed=4)
    skipped.skip_epochs(3)
    assert all(np.array_equal(a["image"], b["image"]) for a, b in zip(skipped, ours))


def test_blob_sample_matches_jax():
    for shape in ((64, 64), (48, 80)):
        a = blob_sample(np.random.default_rng(2), shape)
        b = jblob(np.random.default_rng(2), shape)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


def test_helpers_match_jax(rng):
    img = rng.integers(0, 4000, (30, 20)).astype(np.uint16)
    np.testing.assert_array_equal(tpipe.clip_and_normalize(img, (1.0, 99.0)),
                                  jpipe.clip_and_normalize(img, (1.0, 99.0)))
    for extent, tile, extra in ((80, 32, 0), (80, 32, 1), (32, 32, 1), (300, 256, 2)):
        np.testing.assert_array_equal(tpipe.tile_starts(extent, tile, extra),
                                      jpipe.tile_starts(extent, tile, extra))
    mask = ((rng.random((24, 24)) > 0.6) * 255).astype(np.uint8)
    np.testing.assert_array_equal(tpipe.edit_mask(mask, skeletonize=True, dilate_mask=1),
                                  jpipe.edit_mask(mask, skeletonize=True, dilate_mask=1))
    with pytest.raises(ValueError, match="unknown"):
        tpipe.edit_mask(mask, dilate_mask=1, dilate_kernel="hexagon")
