"""The port's 2D ``Unet`` Trainer held against the JAX Trainer on the CPU.

The JAX Trainer's initial variables are exported to a reference ``.pt``
(``export_torch_checkpoint``) and the port's Trainer starts from them through
``load_weights``.  Both then train 2 epochs on the same in-memory blob tiles
(``utils.synth.blob_sample``; HWC items for JAX, CHW for the port) with the
same seed, hence the same split and batch order: once through the host
loader and once with the tiles resident (``device_cache=True``), without
augmentation, at the slice's learning rate 1e-4.  float32, JAX matmul
precision 'highest' (``conftest.py``).  The ``metrics.csv`` rows agree to
rtol 1e-4, and the first step's gradients to 1e-4 of each tensor's largest
entry.

What the final weights can be held to, and why not every element to
rtol 1e-4 / atol 1e-5: the gradients of the two frameworks differ by float32
summation order (~3e-5 of each tensor's scale), and Adam's normalized step
m̂/(√v̂ + ε) turns such differences into up to ~lr per step wherever an
element's gradient changes sign between steps, and on the conv biases in
front of each BatchNorm, whose gradient is zero in exact arithmetic (train-
mode BatchNorm removes any per-channel offset) and so is rounding noise
(~1e-7..1e-13) that Adam scales to ±lr; the BatchNorm running means take
those biases in.  So after 4 steps every other tensor agrees to rtol 1e-4 /
atol 1e-5 on at least 90% of its elements (measured: 95.6% at worst), and
every element of every tensor lies within 2·lr per step of the JAX value."""

import csv
import os

import numpy as np
import pytest
import torch

from bio_image_unet_tpu import checkpoint as jcheckpoint
from bio_image_unet_tpu.interop.pt_reader import read_pt
from bio_image_unet_tpu.interop.torch_export import export_torch_checkpoint
from bio_image_unet_tpu.parallel import get_mesh
from bio_image_unet_tpu.predict import Predict as JaxPredict
from bio_image_unet_tpu.train import Trainer as JaxTrainer
from bio_image_unet_tpu.train.trainer import ReduceLROnPlateau as JaxPlateau
from bio_image_unet_tpu_torch import checkpoint
from bio_image_unet_tpu_torch.interop import state_dict_from_jax
from bio_image_unet_tpu_torch.models import Unet
from bio_image_unet_tpu_torch.predict import Predict
from bio_image_unet_tpu_torch.train import ReduceLROnPlateau, Trainer
from bio_image_unet_tpu_torch.utils.synth import blob_sample
from torch_parity import assert_u8_contract

N_FILTER, SIZE, BATCH, EPOCHS, LR = 4, 64, 4, 2, 1e-4


class BlobTiles:
    """12 blob tiles in [0, 1]; ``layout`` 'hwc' (JAX) or 'chw' (port)."""

    def __init__(self, layout: str, n: int = 12, size: int = SIZE, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.items = []
        for _ in range(n):
            img, mask = blob_sample(rng, (size, size))
            img, mask = (img / 255.0).astype(np.float32), (mask / 255.0).astype(np.float32)
            if layout == "hwc":
                self.items.append({"image": img[..., None], "mask": mask[..., None]})
            else:
                self.items.append({"image": img[None], "mask": mask[None]})

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def _rows(save_dir):
    with open(os.path.join(save_dir, "metrics.csv")) as fh:
        rows = list(csv.reader(fh))
    assert rows[0] == ["epoch", "train_loss", "val_loss", "lr", "seconds"]
    return np.array([[float(v) for v in r[:4]] for r in rows[1:]])


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The exported initial weights and, per data path, the JAX Trainer's
    metrics and final variables."""
    root = tmp_path_factory.mktemp("jax_train")
    data = BlobTiles("hwc")
    init_path, runs = str(root / "init.pt"), {}
    for cache in (False, True):
        out = str(root / f"cache{int(cache)}")
        t = JaxTrainer(data, EPOCHS, network="Unet", batch_size=BATCH, lr=LR,
                       n_filter=N_FILTER, save_dir=out, seed=0, mesh=get_mesh(n_data=1),
                       device_cache=cache)
        if not cache:
            export_torch_checkpoint(init_path, {"params": t.params, "batch_stats": t.batch_stats},
                                    {"model_name": "Unet", "n_filter": N_FILTER}, epoch=0)
        t.start()
        runs[cache] = (_rows(out), {"params": t.params, "batch_stats": t.batch_stats})
    return init_path, runs


def _port_trainer(out, **kw):
    kw = {"network": "Unet", "batch_size": BATCH, "lr": LR, "n_filter": N_FILTER,
          "save_dir": str(out), "seed": 0, "device": "cpu", **kw}
    return Trainer(BlobTiles("chw"), kw.pop("epochs", EPOCHS), **kw)


def _pre_bn_bias(key: str) -> bool:
    """The conv bias of a ConvBlock (``<block>.0.bias``), in front of its
    BatchNorm."""
    return key.endswith(".0.bias") and not key.startswith("final")


@pytest.mark.parametrize("cache", [False, True], ids=["loader", "device_cache"])
def test_trainer_matches_jax(jax_runs, tmp_path, cache):
    init_path, runs = jax_runs
    ref_rows, ref_vars = runs[cache]
    t = _port_trainer(tmp_path, load_weights=init_path, device_cache=cache)
    assert t.epoch_start == 0 and t.best_loss == float("inf")
    t.start()
    rows = _rows(tmp_path)
    assert rows.shape == ref_rows.shape == (EPOCHS, 4)
    np.testing.assert_array_equal(rows[:, 0], ref_rows[:, 0])
    np.testing.assert_allclose(rows[:, 1:], ref_rows[:, 1:], rtol=1e-4)
    ref_sd = state_dict_from_jax(ref_vars)
    ours = t.model.state_dict()
    assert set(ours) == set(ref_sd)
    steps = EPOCHS * (len(BlobTiles("chw")) - 3) // BATCH
    for k, v in ref_sd.items():
        if k.endswith("num_batches_tracked"):
            continue
        a, b = ours[k].numpy(), v.numpy()
        assert np.abs(a - b).max() <= 2 * LR * steps, (k, np.abs(a - b).max())
        if not (_pre_bn_bias(k) or k.endswith("running_mean")):
            close = np.isclose(a, b, rtol=1e-4, atol=1e-5).mean()
            assert close >= 0.9, (k, close)


def test_first_step_gradients_match_jax(jax_runs):
    """One train-mode forward and backward on the same weights and batch:
    every gradient agrees with ``jax.grad`` to 1e-4 of its tensor's largest
    entry, except the conv biases in front of a BatchNorm, whose gradient is
    rounding noise on both sides (far below the other gradients)."""
    import jax
    import jax.numpy as jnp

    from bio_image_unet_tpu.interop.torch_export import variables_to_torch_state_dict
    from bio_image_unet_tpu.losses import BCEDiceLoss as JaxBCEDice
    from bio_image_unet_tpu.models import Unet as JaxUnet
    from bio_image_unet_tpu_torch.losses import BCEDiceLoss

    init_path = jax_runs[0]
    variables = jcheckpoint.load(init_path)["variables"]
    data = BlobTiles("hwc")
    x = np.stack([data[i]["image"] for i in range(BATCH)])
    y = np.stack([data[i]["mask"] for i in range(BATCH)])
    model = JaxUnet(n_filter=N_FILTER)

    def loss_fn(params):
        (_, z), _ = model.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                jnp.asarray(x), train=True, mutable=["batch_stats"])
        return JaxBCEDice(0.5, 0.5)(z[..., 0], jnp.asarray(y)[..., 0])

    # jitted: the same gradients in seconds, not ~20 s of op-by-op dispatch
    jgrads = jax.jit(jax.grad(loss_fn))(variables["params"])
    ref = variables_to_torch_state_dict({"params": jgrads})
    net = Unet(n_filter=N_FILTER)
    net.load_state_dict(checkpoint.load(init_path)["state_dict"])
    _, z = net.train()(torch.from_numpy(np.moveaxis(x, -1, 1).copy()))
    BCEDiceLoss(0.5, 0.5)(z[:, 0], torch.from_numpy(np.moveaxis(y, -1, 1).copy())[:, 0]).backward()
    grads = {k: p.grad.numpy() for k, p in net.named_parameters()}
    assert set(grads) == set(ref)
    top = max(float(np.abs(g).max()) for g in ref.values())
    for k, g in ref.items():
        g = np.asarray(g)
        if _pre_bn_bias(k):
            assert np.abs(g).max() < 1e-5 * top and np.abs(grads[k]).max() < 1e-5 * top, k
            continue
        np.testing.assert_allclose(grads[k], g, rtol=0, atol=1e-4 * np.abs(g).max(), err_msg=k)


def test_scheduler_matches_jax():
    seq = [1.0, 0.9, 0.9, 0.9, 0.9, 0.9, 0.9, 0.5, 0.49999, 0.49998, 0.49997, 0.49996,
           0.49995, 0.49994, 0.3, 0.3, 0.3]
    for factor, patience in ((0.1, 4), (0.2, 2), (0.5, 0)):
        ours, ref = ReduceLROnPlateau(factor, patience), JaxPlateau(factor, patience)
        scales = [ours.step(v) for v in seq]
        assert scales == [ref.step(v) for v in seq]
        assert scales[-1] < 1.0
        assert ours.state() == {"best": ref.best, "num_bad": ref.num_bad, "scale": ref.scale}


@pytest.mark.parametrize("augment", [False, True], ids=["plain", "device_augment"])
def test_resume_equals_straight_run(tmp_path, augment):
    """1 epoch, then a resume from its checkpoint and 1 more epoch, equals 2
    epochs straight: metrics rows and final weights."""
    kw = {"device_augment": augment, "device_cache": augment}
    straight = _port_trainer(tmp_path / "straight", **kw)
    straight.start()
    first = _port_trainer(tmp_path / "resumed", epochs=1, **kw)
    first.start()
    state = checkpoint.load(str(tmp_path / "resumed" / "model.ckpt"))
    assert state["epoch"] == 1 and state["optimizer_state_dict"] is not None
    assert state["hyperparams"]["scheduler_state"]["scale"] == 1.0
    second = _port_trainer(tmp_path / "resumed", epochs=1, load_weights=True, **kw)
    assert second.epoch_start == 1 and second.best_loss == first.best_loss
    second.start()
    np.testing.assert_allclose(_rows(tmp_path / "resumed")[:, :4],
                               _rows(tmp_path / "straight")[:, :4], rtol=1e-6)
    for (k, a), b in zip(second.model.state_dict().items(),
                         straight.model.state_dict().values()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7, err_msg=k)


def test_checkpoint_read_back_by_jax_and_both_predicts_agree(tmp_path):
    """The port-trained ``.pt`` is read by the JAX package's restricted
    unpickler and ``checkpoint.load``; both ``Predict``s agree on it within
    one level on ≤ 0.1% of pixels."""
    t = _port_trainer(tmp_path, epochs=1, save_iter=True, save_name="model.pt")
    t.start()
    path = str(tmp_path / "model.pt")
    raw = read_pt(path)  # the torch-free reader: no fallback to torch.load
    assert raw["model_name"] == "Unet" and raw["n_filter"] == N_FILTER
    assert raw["epoch"] == 1 and set(raw["scheduler_state"]) == {"best", "num_bad", "scale"}
    assert "state" in raw["optimizer_state_dict"]
    state = jcheckpoint.load(path)
    assert state["epoch"] == 1 and np.isclose(state["best_loss"], t.best_loss)
    assert state["hyperparams"]["loss_function"] == "BCEDice"
    assert os.path.exists(tmp_path / "model_epoch_0.pt")

    movie = np.random.default_rng(5).integers(0, 255, (3, 96, 80), dtype=np.uint8)
    kw = dict(resize_dim=(64, 64), show_progress=False)
    ref = JaxPredict(movie, None, path, **kw).result
    ours = Predict(movie, None, path, device="cpu", **kw).result
    assert_u8_contract(ours, ref)


def test_trainer_device_rule_and_unported_options(tmp_path):
    data = BlobTiles("chw", n=4)
    if torch.cuda.is_available():
        assert Trainer(data, 1, n_filter=4, save_dir=str(tmp_path)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Trainer(data, 1, n_filter=4, save_dir=str(tmp_path))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Trainer(data, 1, n_filter=4, save_dir=str(tmp_path), device="auto")
    # mesh= is ported: what is not a mesh is refused by name; the mesh of one
    # (no process group) trains, device_cache="sharded" on it too
    from bio_image_unet_tpu_torch.parallel import get_mesh as port_mesh

    with pytest.raises(TypeError, match="mesh"):
        Trainer(data, 1, n_filter=4, save_dir=str(tmp_path), device="cpu", mesh=object())
    for cache in (False, "sharded"):
        t = Trainer(BlobTiles("chw"), 1, n_filter=4, save_dir=str(tmp_path / f"one_{cache}"),
                    device="cpu", mesh=port_mesh(), device_cache=cache)
        assert t.mesh.shape == {"data": 1, "spatial": 1} and not t.mesh.distributed
        t.start()
        assert np.isfinite(t.history[-1]["train_loss"])
    # AttentionUnet and the legacy models train
    for network in ("AttentionUnet", "Unet_v0", "BabyUnet"):
        assert Trainer(data, 1, network=network, n_filter=4, save_dir=str(tmp_path),
                       device="cpu").params_meta["model_name"] == network
    # the 3D options are ported: the temporal loss applies to any single-output
    # model, and a 2D model drops use_interpolation as JAX's get_model does
    t = Trainer(data, 1, n_filter=4, save_dir=str(tmp_path), device="cpu",
                time_loss_weight=0.1, use_interpolation=True)
    assert t.time_loss_weight == 0.1 and t.params_meta["time_loss_weight"] == 0.1


def test_half_precision_keeps_float32_params_and_batchnorm(tmp_path):
    """``half_precision``: bf16 convs, float32 parameters, BatchNorm running
    statistics and logits; one epoch trains to a finite loss."""
    t = _port_trainer(tmp_path, epochs=1, half_precision=True, device_augment=True)
    assert t.model.dtype == torch.bfloat16
    x = torch.rand((2, 1, 32, 32))
    probs, logits = t.model.eval()(x)
    assert logits.dtype == torch.float32 and probs.dtype == torch.float32
    ref = Unet(n_filter=N_FILTER)
    ref.load_state_dict(t.model.state_dict())
    with torch.no_grad():
        err = (logits - ref.eval()(x)[1]).abs().max().item()
    assert err < 0.1, err
    assert np.isfinite(t.start())
    assert all(p.dtype == torch.float32 for p in t.model.parameters())
    assert t.model.encode1[1].running_var.dtype == torch.float32
    assert not torch.equal(t.model.encode1[1].running_mean, torch.zeros(N_FILTER))


def test_facade_defaults_and_test_folder_prediction(tmp_path):
    from bio_image_unet_tpu_torch import unet
    from bio_image_unet_tpu_torch.data import tiff

    t = unet.Trainer(BlobTiles("chw"), 1, n_filter=4, save_dir=str(tmp_path / "out"),
                     device="cpu")
    assert (t.scheduler.patience, t.scheduler.factor) == (4, 0.1)
    assert t.params_meta["loss_function"] == "BCEDice" and t.lr == 1e-3
    test_dir = tmp_path / "test"
    os.makedirs(test_dir)
    tiff.imwrite(str(test_dir / "t0.tif"),
                 np.random.default_rng(1).integers(0, 255, (48, 48), dtype=np.uint8))
    t.start(test_data_path=str(test_dir), result_path=str(tmp_path / "res"),
            test_resize_dim=(32, 32))
    assert any("t0.tif" in f and "epoch_0" in f for f in os.listdir(tmp_path / "res"))


def test_emergency_checkpoint(tmp_path, monkeypatch):
    t = _port_trainer(tmp_path, epochs=3, val_split=0.0)
    calls = {"n": 0}
    orig = t._iterate_val

    def crash_on_second(epoch):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("boom")
        return orig(epoch)

    monkeypatch.setattr(t, "_iterate_val", crash_on_second)
    with pytest.raises(RuntimeError, match="boom"):
        t.start()
    state = checkpoint.load(str(tmp_path / "model_interrupted.ckpt"))
    assert state["epoch"] == 1
    assert all(torch.isfinite(v).all() for v in state["state_dict"].values())
