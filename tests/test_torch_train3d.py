"""The port's 3D training of ``UNet3D`` held against the JAX package on the
CPU: the 5-D device augmentation (K4v's plain version) on JAX's own draws,
``DataProcess3D`` on the same TIFFs and seed, the ``unet3d`` Trainer (with
its temporal loss) against the JAX Trainer from the same initial weights,
and the first step's gradients of the trilinear ``UNet3D`` with the temporal
loss against ``jax.grad``.

Tolerances: the augmented image atol 1e-6 and masks equal (K4's contract);
pipeline items equal; ``metrics.csv`` rtol 1e-4 and the final weights and
first-step gradients within the bounds of ``tests/test_torch_train.py``
(the reasons are given there).  Sizes: n_filter 4, (8, 16, 16) volumes,
batch 4; one JAX Trainer for the whole file."""

import csv
import inspect
import itertools
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from bio_image_unet_tpu import unet3d as junet3d
from bio_image_unet_tpu.data import pipelines as jpipe
from bio_image_unet_tpu.data import tiff as jtiff
from bio_image_unet_tpu.data.augment_jax import _spatial_tx, augment_batch
from bio_image_unet_tpu.interop.torch_export import export_torch_checkpoint
from bio_image_unet_tpu.parallel import get_mesh
from bio_image_unet_tpu_torch import unet3d
from bio_image_unet_tpu_torch.data import pipelines as tpipe
from bio_image_unet_tpu_torch.data.augment_device import (augment_apply_plain,
                                                          augment_volume_apply, draw)
from bio_image_unet_tpu_torch.data.augment_device import augment_batch as port_augment_batch
from bio_image_unet_tpu_torch.interop import state_dict_from_jax
from bio_image_unet_tpu_torch.models import UNet3D
from bio_image_unet_tpu_torch.predict import Predict3D
from bio_image_unet_tpu_torch.train import Trainer
from test_torch_augment import _draws, _jax_draws, _nchw, _nhwc
from torch_parity import jit_init, write_seeded_checkpoint

REPO = Path(__file__).resolve().parent.parent
N_FILTER, SHAPE, BATCH, EPOCHS, LR = 4, (8, 16, 16), 4, 2, 1e-4


class Volumes:
    """``n`` volumes in [0, 1] with a smooth-blob mask; ``layout`` 'zxyc'
    (JAX) or 'czxy' (port); the input under ``key``."""

    def __init__(self, layout: str, n: int = 12, key: str = "volume", seed: int = 0):
        rng = np.random.default_rng(seed)
        self.items = []
        for _ in range(n):
            field = ndimage.gaussian_filter(rng.standard_normal(SHAPE), 2.0)
            mask = (field > 0).astype(np.float32)
            vol = np.clip(0.6 * mask + 0.4 * rng.random(SHAPE), 0, 1).astype(np.float32)
            ax = -1 if layout == "zxyc" else 0
            self.items.append({key: np.expand_dims(vol, ax), "mask": np.expand_dims(mask, ax)})

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def _rows(save_dir):
    with open(os.path.join(save_dir, "metrics.csv")) as fh:
        rows = list(csv.reader(fh))
    assert rows[0] == ["epoch", "train_loss", "val_loss", "lr", "seconds"]
    return np.array([[float(v) for v in r[:4]] for r in rows[1:]])


def _pre_bn_bias(key: str) -> bool:
    return key.endswith(".0.bias") and not key.startswith("final")


# --- K4v's plain version against augment_jax on 5-D batches ------------------------

@pytest.mark.parametrize("k,fh,fv", list(itertools.product(range(4), (False, True),
                                                           (False, True))))
def test_volume_spatial_cases_match_spatial_tx(rng, k, fh, fv):
    """All 16 (k, flip_h, flip_v) cases on a 2-channel (3, 8, 8) volume with
    the gate on and the intensity stage off: the (X, Y) plane moves as
    ``_spatial_tx`` moves it with the 3D ``axes`` (1, 2), alike for every z."""
    image = rng.random((1, 3, 8, 8, 2)).astype(np.float32)
    mask = (rng.random((1, 3, 8, 8, 1)) > 0.5).astype(np.float32)
    one, zero = torch.ones(1, dtype=torch.bool), torch.zeros(1, dtype=torch.bool)
    d = _draws(gate=one, k=torch.tensor([k]), flip_h=one if fh else zero,
               flip_v=one if fv else zero, bc_apply=zero, alpha=torch.ones(1),
               beta=torch.zeros(1), mult_apply=zero, gauss_apply=zero)
    out_img, out_mask = augment_volume_apply(_nchw(image), _nchw(mask), d)
    for ours, ref in ((out_img, image), (out_mask, mask)):
        want = np.asarray(_spatial_tx(jnp.asarray(ref[0]), k, fh, fv, (1, 2)))
        np.testing.assert_array_equal(_nhwc(ours)[0], want)


@pytest.mark.parametrize("gauss_sigma", [None, 0.04], ids=["mult", "mult+gauss"])
def test_augment_volume_matches_jax(rng, gauss_sigma):
    """A full 5-D ``augment_batch(key, ...)`` for several keys: the port's
    plain K4v on JAX's draws (5-D fields moved to channels-first) gives
    JAX's batch."""
    image = rng.random((6, 4, 8, 8, 1)).astype(np.float32)
    mask = (rng.random((6, 4, 8, 8, 2)) > 0.5).astype(np.float32)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        ref = augment_batch(key, jnp.asarray(image), jnp.asarray(mask), gauss_sigma=gauss_sigma)
        d = _jax_draws(key, 6, image.shape, False, gauss_sigma=gauss_sigma)
        ours = augment_volume_apply(_nchw(image), _nchw(mask), d)
        np.testing.assert_allclose(_nhwc(ours[0]), np.asarray(ref[0]), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(_nhwc(ours[1]), np.asarray(ref[1]))
        changed = (ours[0] != _nchw(image)).flatten(1).any(1)
        assert 0 < int(changed.sum()) <= 6


def test_augment_volume_gathers_index_and_passes_gated_samples(rng):
    """``index`` gathers rows of a resident volume set; a sample whose gate
    is off passes through; on CPU tensors the wrapper is the plain version
    and launches nothing; ``augment_batch`` takes 5-D sets through K4v's
    wrapper."""
    image = torch.from_numpy(rng.random((9, 1, 4, 12, 12)).astype(np.float32))
    mask = torch.from_numpy((rng.random((9, 1, 4, 12, 12)) > 0.5).astype(np.float32))
    index = torch.tensor([7, 2, 2, 8], dtype=torch.int64)
    d = draw(torch.Generator().manual_seed(0), 4, (4, 1, 4, 12, 12), gauss_sigma=0.05)
    d.flags[3, 0] = 0
    before = augment_volume_apply.launches
    out = augment_volume_apply(image, mask, d, index=index)
    assert augment_volume_apply.launches == before
    ref = augment_apply_plain(image[index], mask[index], d)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert torch.equal(out[0][3], image[8]) and torch.equal(out[1][3], mask[8])
    assert out[0].shape == (4, 1, 4, 12, 12) and out[1].dtype == torch.float32
    img, msk = port_augment_batch(torch.Generator().manual_seed(1), image, mask, index=index)
    assert img.shape == (4, 1, 4, 12, 12) and msk.shape == (4, 1, 4, 12, 12)
    assert float(img.min()) >= 0.0 and float(img.max()) <= 1.0
    with pytest.raises(ValueError, match="square"):
        augment_volume_apply(image[..., :10], mask[..., :10], d)
    with pytest.raises(ValueError, match="NCDHW"):
        augment_volume_apply(image[:, :, 0], mask[:, :, 0], d)


# --- DataProcess3D -----------------------------------------------------------------

@pytest.fixture(scope="module")
def volume_tiffs(tmp_path_factory):
    """Two uint16 volumes of (10, 20, 18) and their uint8 masks."""
    root = tmp_path_factory.mktemp("vols")
    rng = np.random.default_rng(11)
    for sub in ("image", "label"):
        os.makedirs(root / sub)
    for i in range(2):
        field = ndimage.gaussian_filter(rng.standard_normal((10, 20, 18)), 2.0)
        jtiff.imwrite(str(root / "image" / f"vol {i}.tif"),
                      (rng.random((10, 20, 18)) * 3000 + 2000 * (field > 0)).astype(np.uint16))
        jtiff.imwrite(str(root / "label" / f"vol {i}.tif"), ((field > 0) * 255).astype(np.uint8))
    return (str(root / "image") + "/", str(root / "label") + "/")


@pytest.mark.parametrize("kw", [dict(aug_factor=2, add_patch=1, seed=3),
                                dict(aug_factor=None, dilate_mask=1, invert=True)],
                         ids=["aug2-add_patch", "split-dilate-invert"])
def test_dataprocess3d_items_bit_equal_to_jax(volume_tiffs, tmp_path, kw):
    kw = dict(dim_out=SHAPE, **kw)
    ref = jpipe.DataProcess3D(volume_tiffs, data_path=str(tmp_path / "jax"), **kw)
    ours = tpipe.DataProcess3D(volume_tiffs, data_path=str(tmp_path / "port"), **kw)
    assert len(ours) == len(ref) > 0
    for i in range(len(ref)):
        for key in ("volume", "mask"):
            a, b = ours[i][key], ref[i][key]
            assert a.dtype == np.float32 and a.shape == (1,) + SHAPE, (key, a.shape)
            np.testing.assert_array_equal(a, np.moveaxis(b, -1, 0), err_msg=f"{i} {key}")
    if kw["aug_factor"]:  # add_patch tiled every axis, and the draws did something
        assert len(ours) == 2 * 3 * 3 * 3 * 2
        assert any(not np.array_equal(ours[2 * j]["volume"], ours[2 * j + 1]["volume"])
                   for j in range(len(ours) // 2))


# --- the Trainer -------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX ``unet3d.Trainer`` (``UNet3D``, ``time_loss_weight`` 0.1) on
    resident volumes: its initial weights as a ``.pt``, its ``metrics.csv``
    rows and final variables."""
    root = tmp_path_factory.mktemp("jax_train3d")
    out = str(root / "run")
    with jit_init():
        t = junet3d.Trainer(Volumes("zxyc"), EPOCHS, batch_size=BATCH, lr=LR,
                            n_filter=N_FILTER, save_dir=out, seed=0, mesh=get_mesh(n_data=1),
                            device_cache=True)
    init_path = str(root / "init.pt")
    export_torch_checkpoint(init_path, {"params": t.params, "batch_stats": t.batch_stats},
                            {"model_name": "UNet3D", "n_filter": N_FILTER}, epoch=0,
                            final_sequential=False)
    t.start()
    return init_path, _rows(out), {"params": t.params, "batch_stats": t.batch_stats}


def test_unet3d_trainer_matches_jax(jax_run, tmp_path):
    """``unet3d.Trainer`` from JAX's initial weights, resident volumes, the
    facade's temporal loss: ``metrics.csv`` within rtol 1e-4 and the final
    weights within the bounds of ``test_torch_train.py``."""
    init_path, ref_rows, ref_vars = jax_run
    t = unet3d.Trainer(Volumes("czxy"), EPOCHS, batch_size=BATCH, lr=LR, n_filter=N_FILTER,
                       save_dir=str(tmp_path), seed=0, load_weights=init_path,
                       device_cache=True, device="cpu")
    assert t.time_loss_weight == 0.1 and t.input_key == "volume"
    t.start()
    rows = _rows(tmp_path)
    assert rows.shape == ref_rows.shape == (EPOCHS, 4)
    np.testing.assert_array_equal(rows[:, 0], ref_rows[:, 0])
    np.testing.assert_allclose(rows[:, 1:], ref_rows[:, 1:], rtol=1e-4)
    ref_sd = state_dict_from_jax(ref_vars)
    ours = t.model.state_dict()
    assert set(ours) == set(ref_sd)
    steps = EPOCHS * (12 - 3) // BATCH
    for k, v in ref_sd.items():
        if k.endswith("num_batches_tracked"):
            continue
        a, b = ours[k].numpy(), v.numpy()
        assert np.abs(a - b).max() <= 2 * LR * steps, (k, np.abs(a - b).max())
        if not (_pre_bn_bias(k) or k.endswith("running_mean")):
            close = np.isclose(a, b, rtol=1e-4, atol=1e-5).mean()
            assert close >= 0.9, (k, close)
    meta = torch.load(str(tmp_path / "model.pt"), weights_only=True)
    assert meta["time_loss_weight"] == 0.1 and meta["use_interpolation"] is False


def test_first_step_gradients_with_time_loss_match_jax(tmp_path):
    """One train-mode forward and backward of the trilinear ``UNet3D`` with
    the temporal loss (BCEDice + 0.1 · SmoothL1 of batch-adjacent logits):
    every gradient within 1e-4 of its tensor's largest entry of
    ``jax.grad``'s, the conv biases in front of a BatchNorm excepted (rounding
    noise on both sides)."""
    from bio_image_unet_tpu.interop.torch_export import variables_to_torch_state_dict
    from bio_image_unet_tpu.losses import BCEDiceLoss as JaxBCEDice
    from bio_image_unet_tpu.losses import smooth_l1_loss as jax_smooth_l1
    from bio_image_unet_tpu.models import UNet3D as JaxUNet3D
    from bio_image_unet_tpu_torch.losses import BCEDiceLoss, smooth_l1_loss

    path, variables = write_seeded_checkpoint(tmp_path, "tri", "UNet3D", 3, n_filter=N_FILTER,
                                          use_interpolation=True)
    data = Volumes("zxyc")
    x = np.stack([data[i]["volume"] for i in range(BATCH)])
    y = np.stack([data[i]["mask"] for i in range(BATCH)])
    model = JaxUNet3D(n_filter=N_FILTER, use_interpolation=True)

    def loss_fn(params):
        (_, z), _ = model.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                jnp.asarray(x), train=True, mutable=["batch_stats"])
        return (JaxBCEDice(0.5, 0.5)(z[..., 0], jnp.asarray(y)[..., 0])
                + 0.1 * jax_smooth_l1(z[1:], z[:-1]))

    ref = variables_to_torch_state_dict(
        {"params": jax.jit(jax.grad(loss_fn))(variables["params"])}, final_sequential=False)
    net = UNet3D(n_filter=N_FILTER, use_interpolation=True)
    net.load_state_dict(torch.load(path, weights_only=True)["state_dict"])
    _, z = net.train()(_nchw(x))
    loss = BCEDiceLoss(0.5, 0.5)(z[:, 0], _nchw(y)[:, 0]) + 0.1 * smooth_l1_loss(z[1:], z[:-1])
    loss.backward()
    grads = {k: p.grad.numpy() for k, p in net.named_parameters()}
    assert set(grads) == set(ref)
    top = max(float(np.abs(g).max()) for g in ref.values())
    for k, g in ref.items():
        g = np.asarray(g)
        if _pre_bn_bias(k):
            assert np.abs(g).max() < 1e-5 * top and np.abs(grads[k]).max() < 1e-5 * top, k
            continue
        np.testing.assert_allclose(grads[k], g, rtol=0, atol=1e-4 * np.abs(g).max(), err_msg=k)


@pytest.mark.parametrize("network", ["UNet3D", UNet3D], ids=["string", "class"])
def test_unet3d_network_by_class_or_name_trains_3d(tmp_path, network):
    """A ``UNet3D`` named or passed as a class takes the 3D path: the
    trilinear decoder reaches the model, the temporal loss applies, the
    ``.pt`` records both and rebuilds in ``Predict3D`` (``strict=True``)."""
    t = Trainer(Volumes("czxy", n=5, key="image"), 1, network=network, batch_size=2,
                n_filter=N_FILTER, use_interpolation=True, time_loss_weight=0.1,
                save_dir=str(tmp_path), seed=0, device="cpu")
    assert isinstance(t.model, UNet3D) and t.model.use_interpolation and not hasattr(t.model, "up1")
    assert t.volumetric and t.input_key == "image" and t._memory_format() == torch.channels_last_3d
    t.start()
    state = torch.load(str(tmp_path / "model.pt"), weights_only=True)
    assert state["model_name"] == "UNet3D" and state["use_interpolation"] is True
    assert state["time_loss_weight"] == 0.1
    vol = np.random.default_rng(0).integers(0, 255, (8, 20, 20), dtype=np.uint8)
    res = Predict3D(vol, None, str(tmp_path / "model.pt"), resize_dim=SHAPE,
                    show_progress=False, device="cpu").result
    assert res.shape == vol.shape and res.dtype == np.uint8


def test_time_loss_adds_smooth_l1_and_skips_batch_of_one(tmp_path):
    """The temporal term is SmoothL1 of batch-adjacent logits times the
    weight, and a batch of one adds nothing (``trainer.py:468-472``)."""
    from types import SimpleNamespace

    from bio_image_unet_tpu.train.trainer import Trainer as JaxTrainer
    from bio_image_unet_tpu_torch.losses import get_loss

    rng = np.random.default_rng(4)
    z = rng.standard_normal((3, 2, 2, 4, 4)).astype(np.float32)
    y = (rng.random((3, 2, 2, 4, 4)) > 0.5).astype(np.float32)
    for b in (3, 1):
        ours = Trainer._compute_loss(
            SimpleNamespace(multi_output=False, criterion=get_loss("BCEDice", alpha=0.5, beta=0.5),
                            channel_weights=torch.ones(2), out_channels=2, time_loss_weight=0.1),
            (None, torch.from_numpy(z[:b])), {"mask": torch.from_numpy(y[:b])}, True)
        from bio_image_unet_tpu.losses import get_loss as jget_loss

        ref = JaxTrainer._compute_loss(
            SimpleNamespace(multi_output=False, criterion=jget_loss("BCEDice", alpha=0.5, beta=0.5),
                            channel_weights=np.ones(2, np.float32), out_channels=2,
                            time_loss_weight=0.1),
            (None, jnp.asarray(np.moveaxis(z[:b], 1, -1))),
            {"mask": jnp.asarray(np.moveaxis(y[:b], 1, -1))}, True)
        np.testing.assert_allclose(float(ours), float(ref), rtol=1e-6)


def test_unet3d_facade_defaults_and_loader_path(tmp_path):
    """The facade's defaults are the JAX facade's (the checkpoint name aside:
    ``.pt``), and the loader path (``device_cache=False``) trains an epoch
    from ``DataProcess`` items with device augmentation."""
    ours = inspect.signature(unet3d.Trainer.__init__).parameters
    ref = inspect.signature(junet3d.Trainer.__init__).parameters
    assert list(ours) == list(ref)
    for name, p in ref.items():
        if name != "save_name":
            assert ours[name].default == p.default, name
    assert ours["save_name"].default == "model.pt"
    assert unet3d.DataProcess is tpipe.DataProcess3D
    if torch.cuda.is_available():
        assert unet3d.Trainer(Volumes("czxy", n=4), 1, n_filter=N_FILTER,
                              save_dir=str(tmp_path / "card")).device.type == "cuda"
    else:  # no card: the facade raises unless the caller asks for the CPU
        with pytest.raises(RuntimeError, match="device='cpu'"):
            unet3d.Trainer(Volumes("czxy", n=4), 1, n_filter=N_FILTER,
                           save_dir=str(tmp_path / "card"))
    t = unet3d.Trainer(Volumes("czxy", n=6), 1, batch_size=2, n_filter=N_FILTER,
                       save_dir=str(tmp_path), seed=0, device_augment=True, device="cpu")
    assert (t.scheduler.patience, t.scheduler.factor, t.lr) == (4, 0.1, 1e-3)
    assert t._device_data is None
    t.start()
    assert np.isfinite(t.history[0]["train_loss"]) and len(_rows(tmp_path)) == 1


def test_3d_training_runs_without_jax(tmp_path, volume_tiffs):
    """The 3D pipelines, K4v/K4hv's wrappers, the Trainer and both 3D facades
    import and train an epoch on the CPU with JAX, flax, optax, ml_dtypes and
    the JAX package made unimportable (names matched exactly or followed by
    '.')."""
    code = textwrap.dedent(f"""
        import sys
        import numpy as np
        BLOCKED = ("jax", "jaxlib", "flax", "optax", "ml_dtypes", "bio_image_unet_tpu")
        for name in list(sys.modules):
            if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                del sys.modules[name]
        for b in BLOCKED:
            sys.modules[b] = None
        sys.path.insert(0, {str(REPO)!r})
        from bio_image_unet_tpu_torch import multi_output_unet3d, unet3d
        tmp = {str(tmp_path)!r}
        data = unet3d.DataProcess({volume_tiffs!r}, dim_out=(8, 16, 16), aug_factor=1,
                                  data_path=tmp + "/d3", seed=0)
        t = unet3d.Trainer(data, 1, batch_size=2, n_filter=4, save_dir=tmp + "/u3d",
                           device_cache=True, device_augment=True, device="cpu")
        t.start()
        assert np.isfinite(t.history[0]["train_loss"])
        heads = {{"label": {{"channels": 1, "activation": "sigmoid", "loss": "BCEDiceLoss"}}}}
        mo = multi_output_unet3d.DataProcess({volume_tiffs[0]!r}, [{volume_tiffs[1]!r}],
                                             data_dir=tmp + "/mo", dim_out=(8, 16, 16),
                                             aug_factor=3, seed=0)
        t = multi_output_unet3d.Trainer(mo, heads, 1, batch_size=2, n_filter=4,
                                        save_dir=tmp + "/mo3d", device_cache=True,
                                        device_augment=True, device="cpu")
        t.start()
        assert np.isfinite(t.history[0]["train_loss"])
        leaked = sorted(n for n in sys.modules if sys.modules[n] is not None and
                        any(n == b or n.startswith(b + ".") for b in BLOCKED))
        assert not leaked, leaked
        print("OK")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("OK"), out.stdout[-2000:]
