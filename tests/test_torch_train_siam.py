"""The port's Siam training held against the JAX package on the CPU: the
pair pipeline (``DataProcessSiam``) and the Trainer with ``mode=``.

- ``DataProcessSiam``'s tiles equal JAX's on the same TIFFs: W-doubled
  images (the left half is the previous frame) and 2-layer stacks, split
  tiles and augmented copies (the same numpy stream).
- The Trainer: JAX's initial variables go to a reference ``.pt``
  (``export_torch_checkpoint``) and the port starts from them through
  ``load_weights``; both train 2 epochs on the same in-memory pair tiles
  with the same seed (``max`` here, through the host loader; ``corr``, with
  the tiles resident, in ``test_torch_train_siam_step.py``), float32 at lr
  1e-4: the ``metrics.csv`` rows agree to rtol 1e-4 (the bound and the
  reasons of ``tests/test_torch_train.py``).
"""

import csv
import os

import numpy as np
import pytest

import torch_parity  # noqa: F401  (one torch thread a test process)
from bio_image_unet_tpu.data.pipelines import DataProcessSiam as JDataProcessSiam
from bio_image_unet_tpu.interop.torch_export import export_torch_checkpoint
from bio_image_unet_tpu.parallel import get_mesh
from bio_image_unet_tpu.train import Trainer as JaxTrainer
from bio_image_unet_tpu_torch.data import tiff
from bio_image_unet_tpu_torch.data.pipelines import DataProcessSiam
from bio_image_unet_tpu_torch.train import Trainer
from bio_image_unet_tpu_torch.utils.synth import blob_sample
from torch_parity import jit_init

N_FILTER, SIZE, BATCH, EPOCHS, LR = 4, 64, 4, 2, 1e-4


class PairTiles:
    """12 blob pair tiles in [0, 1]: the prev frame is the cur frame shifted
    by a few pixels plus noise; ``layout`` 'hwc' (JAX) or 'chw' (port)."""

    def __init__(self, layout: str, n: int = 12, size: int = SIZE, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.items = []
        for _ in range(n):
            img, mask = blob_sample(rng, (size, size))
            prev = np.roll(img, tuple(rng.integers(-3, 4, 2)), (0, 1)).astype(np.float32)
            prev = np.clip(prev + rng.normal(0, 8, prev.shape), 0, 255)
            arrs = {"image": img / 255.0, "mask": mask / 255.0, "prev_image": prev / 255.0}
            self.items.append({k: (v[..., None] if layout == "hwc" else v[None]).astype(np.float32)
                               for k, v in arrs.items()})

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def _rows(save_dir):
    with open(os.path.join(save_dir, "metrics.csv")) as fh:
        rows = list(csv.reader(fh))
    assert rows[0] == ["epoch", "train_loss", "val_loss", "lr", "seconds"]
    return np.array([[float(v) for v in r[:4]] for r in rows[1:]])


def _source(root, layout: str, n: int = 2, h: int = 80, w: int = 72, seed: int = 1):
    """Pair images (W-doubled or 2-layer) and masks as TIFFs under ``root``."""
    rng = np.random.default_rng(seed)
    for sub in ("image", "label"):
        os.makedirs(root / sub)
    for i in range(n):
        cur, mask = blob_sample(rng, (h, w))
        prev, _ = blob_sample(rng, (h, w))
        pair = (np.concatenate([prev, cur], axis=1) if layout == "doubled"
                else np.stack([prev, cur]))
        tiff.imwrite(str(root / "image" / f"f{i}.tif"), pair.astype(np.uint16) * 200)
        tiff.imwrite(str(root / "label" / f"f{i}.tif"), mask)
    return str(root / "image"), str(root / "label")


@pytest.mark.parametrize("aug,ssr", [(None, (0, 0, 0)), (2, (0, 0, 0)), (2, (0.1, 0.1, 10))],
                         ids=["split", "augmented", "augmented-warped"])
@pytest.mark.parametrize("layout", ["doubled", "stacked"])
def test_data_process_siam_matches_jax(tmp_path, layout, aug, ssr):
    """Bit-equal tiles; with a non-identity ShiftScaleRotate the port warps
    with scipy and JAX as OpenCV does, so those tiles are held, over the
    set, to that transform's contract (``tests/test_torch_data.py``): at
    most one level on at least 99% of pixels, the median 0, masks equal on
    at least 97%."""
    source = _source(tmp_path / "src", layout)
    kw = dict(dim_out=(32, 32), aug_factor=aug, dilate_mask=1, skeletonize=layout == "stacked",
              invert_masks=aug is None, shiftscalerotate=ssr, seed=3)
    ref = JDataProcessSiam(source, data_path=str(tmp_path / "jax"), **kw)
    ours = DataProcessSiam(source, data_path=str(tmp_path / "port"), **kw)
    assert len(ours) == len(ref) == (2 * 9 * (aug or 1))
    diffs = {"image": [], "prev_image": [], "mask": []}
    for i in range(len(ref)):
        a, b = ours[i], ref[i]
        assert set(a) == set(b) == set(diffs)
        for k in a:
            assert a[k].shape == (1, 32, 32) and a[k].dtype == np.float32
            want = np.moveaxis(b[k], -1, 0)
            if ssr == (0, 0, 0):
                np.testing.assert_array_equal(a[k], want, err_msg=(i, k))
            diffs[k].append(np.rint(np.abs(a[k] - want) * 255).ravel())
    for k, d in diffs.items():
        d = np.concatenate(d)
        if k == "mask":
            assert (d == 0).mean() >= 0.97, (k, (d == 0).mean())
        else:
            assert (d <= 1).mean() >= 0.99 and np.median(d) == 0, (k, d.max(), (d > 1).mean())
    # the pairs are the frames' own halves (or layers): image is not prev
    assert not np.array_equal(ours[0]["image"], ours[0]["prev_image"])


def jax_run(root, mode: str, cache: bool):
    """JAX's Trainer on ``PairTiles`` (its init jitted): the exported initial
    weights and its ``metrics.csv`` rows."""
    out = str(root / mode)
    with jit_init():
        t = JaxTrainer(PairTiles("hwc"), EPOCHS, network="Siam_UNet", mode=mode,
                       batch_size=BATCH, lr=LR, n_filter=N_FILTER, save_dir=out, seed=0,
                       mesh=get_mesh(n_data=1), device_cache=cache)
    init = str(root / f"init_{mode}.pt")
    export_torch_checkpoint(init, {"params": t.params, "batch_stats": t.batch_stats},
                            {"model_name": "Siam_UNet", "n_filter": N_FILTER, "mode": mode},
                            epoch=0)
    t.start()
    return init, _rows(out)


def check_trainer_matches_jax(tmp_path, mode: str, cache: bool):
    init, ref_rows = jax_run(tmp_path / "jax", mode, cache)
    t = Trainer(PairTiles("chw"), EPOCHS, network="Siam_UNet", mode=mode, batch_size=BATCH,
                lr=LR, n_filter=N_FILTER, save_dir=str(tmp_path / "port"), seed=0,
                device="cpu", load_weights=init, device_cache=cache)
    assert t.model.mode == mode and t.params_meta["mode"] == mode
    t.start()
    rows = _rows(tmp_path / "port")
    assert rows.shape == ref_rows.shape == (EPOCHS, 4)
    np.testing.assert_array_equal(rows[:, 0], ref_rows[:, 0])
    np.testing.assert_allclose(rows[:, 1:], ref_rows[:, 1:], rtol=1e-4)


def test_siam_trainer_max_matches_jax(tmp_path):
    """The ``max`` join through the host loader."""
    check_trainer_matches_jax(tmp_path, "max", cache=False)
