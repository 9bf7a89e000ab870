"""The port's 3D multi-output training (``MultiOutputUnet3D`` with heads) held
against the JAX package on the CPU: the 5-D multi-head device augmentation
(K4hv's plain version) on JAX's own draws, the 3D host transforms and
``DataProcessMultiOutput3D`` on the same inputs and seed, and the
``multi_output_unet3d`` Trainer (3D head losses) against the JAX Trainer from
the same initial weights.

Tolerances: the augmented image within one float32 ulp, targets equal (K4h's
contract); pipeline items equal where the warp is the identity, and within
``tests/test_torch_data.py``'s contract of the scipy warp against OpenCV
otherwise; ``metrics.csv`` rtol 1e-4 and the final weights within the bounds
of ``tests/test_torch_train.py``.  Sizes: n_filter 4, (8, 16, 16) volumes,
batch 4; one JAX Trainer for the whole file."""

import csv
import inspect
import itertools
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from bio_image_unet_tpu import checkpoint as jcheckpoint
from bio_image_unet_tpu import multi_output_unet3d as jmo3d
from bio_image_unet_tpu.data import augment as jaug
from bio_image_unet_tpu.data import pipelines as jpipe
from bio_image_unet_tpu.data import tiff as jtiff
from bio_image_unet_tpu.data.augment_jax import (_orientation_components, _spatial_tx,
                                                 augment_batch_heads as jax_batch_heads)
from bio_image_unet_tpu.interop.torch_export import export_torch_checkpoint
from bio_image_unet_tpu.parallel import get_mesh
from bio_image_unet_tpu_torch import multi_output_unet3d
from bio_image_unet_tpu_torch.data import augment as taug
from bio_image_unet_tpu_torch.data import pipelines as tpipe
from bio_image_unet_tpu_torch.data.augment_device import (AugmentDraws, HeadLayout,
                                                          augment_batch_heads,
                                                          augment_heads_apply,
                                                          augment_heads_apply_plain,
                                                          augment_heads_volume_apply, draw)
from bio_image_unet_tpu_torch.interop import state_dict_from_jax
from bio_image_unet_tpu_torch.losses import get_head_loss
from bio_image_unet_tpu_torch.models import MultiOutputUnet3D
from bio_image_unet_tpu_torch.predict import PredictMultiOutput3D
from bio_image_unet_tpu_torch.train import Trainer
from test_torch_augment_heads import _jax_draws, _ulps
from torch_parity import jit_init, write_seeded_checkpoint

HEADS = {"mask": {"channels": 1, "activation": "sigmoid", "loss": "BCEDiceLoss"},
         "orientation": {"channels": 2, "activation": None, "loss": "MSELoss", "weight": 0.5}}
N_FILTER, SHAPE, BATCH, EPOCHS, LR = 4, (8, 16, 16), 4, 2, 1e-4


def _nchw(a):
    return torch.from_numpy(np.array(np.moveaxis(np.asarray(a), -1, 1)))


def _nhwc(t):
    return np.moveaxis(t.numpy(), 1, -1)


def _heads(rng, b, shape=(3, 8, 8)):
    """Channels-last head targets of ``b`` volumes: a binary mask and a unit
    (cos, sin) field."""
    theta = rng.uniform(0, 2 * np.pi, (b,) + shape)
    return {"mask": (rng.random((b,) + shape + (1,)) > 0.5).astype(np.float32),
            "orientation": np.stack([np.cos(theta), np.sin(theta)], -1).astype(np.float32)}


class HeadVolumes:
    """``n`` volumes with a mask and an orientation field (the angle about a
    random axis through the volume, as (cos θ, sin θ)); ``layout`` 'zxyc'
    (JAX) or 'czxy' (port)."""

    def __init__(self, layout: str, n: int = 12, seed: int = 0):
        rng = np.random.default_rng(seed)
        xx, yy = np.meshgrid(np.arange(SHAPE[1]), np.arange(SHAPE[2]), indexing="ij")
        self.items = []
        for _ in range(n):
            field = ndimage.gaussian_filter(rng.standard_normal(SHAPE), 2.0)
            mask = (field > 0).astype(np.float32)
            vol = np.clip(0.6 * mask + 0.4 * rng.random(SHAPE), 0, 1).astype(np.float32)
            theta = np.broadcast_to(np.arctan2(yy - rng.uniform(0, 16), xx - rng.uniform(0, 16)),
                                    SHAPE)
            item = {"volume": vol[None], "mask": mask[None],
                    "orientation": np.stack([np.cos(theta), np.sin(theta)]).astype(np.float32)}
            if layout == "zxyc":
                item = {k: np.moveaxis(v, 0, -1) for k, v in item.items()}
            self.items.append(item)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def _rows(save_dir):
    with open(os.path.join(save_dir, "metrics.csv")) as fh:
        rows = list(csv.reader(fh))
    return np.array([[float(v) for v in r[:4]] for r in rows[1:]])


def _pre_bn_bias(key: str) -> bool:
    return key.endswith(".0.bias") and not key.startswith("output_layers")


# --- K4hv's plain version against augment_batch_heads on 5-D batches ----------------

@pytest.mark.parametrize("k,fh,fv", list(itertools.product(range(4), (False, True),
                                                           (False, True))))
def test_volume_heads_cases_match_jax(rng, k, fh, fv):
    """All 16 (k, flip_h, flip_v) cases with the gate on and the intensity
    stage off: every head moves as ``_spatial_tx`` with the 3D ``axes``
    (1, 2) moves it, and the orientation head is re-expressed at every z as
    ``_orientation_components`` does."""
    heads = _heads(rng, 1)
    image = rng.random((1, 3, 8, 8, 1)).astype(np.float32)
    layout = HeadLayout.of({"mask": 1, "orientation": 2}, ("orientation",))
    one, zero = torch.ones(1, dtype=torch.int32), torch.zeros(1, dtype=torch.int32)
    d = AugmentDraws(flags=torch.stack([one, torch.tensor([k], dtype=torch.int32),
                                        one if fh else zero, one if fv else zero,
                                        zero, zero, zero], 1),
                     coef=torch.tensor([[1.0, 0.0]]))
    target = layout.concat({n: _nchw(v) for n, v in heads.items()})
    out_img, out_tgt = augment_heads_volume_apply(_nchw(image), target, layout.codes, d)
    np.testing.assert_array_equal(
        _nhwc(out_img)[0], np.asarray(_spatial_tx(jnp.asarray(image[0]), k, fh, fv, (1, 2))))
    for name, v in layout.split(out_tgt).items():
        ref = _spatial_tx(jnp.asarray(heads[name][0]), k, fh, fv, (1, 2))
        if name == "orientation":
            ref = _orientation_components(ref, k, fh, fv)
        np.testing.assert_array_equal(_nhwc(v)[0], np.asarray(ref), err_msg=name)


@pytest.mark.parametrize("gauss_sigma", [None, 0.04], ids=["mult", "mult+gauss"])
def test_augment_volume_heads_matches_jax(rng, gauss_sigma):
    """A full 5-D ``augment_batch_heads(key, ...)`` for several keys: the
    plain K4hv on JAX's draws gives JAX's batch (image within one ulp,
    targets equal); gathering an ``index`` equals augmenting the gathered
    batch."""
    b = 8
    image = rng.random((b, 3, 8, 8, 1)).astype(np.float32)
    heads = _heads(rng, b)
    layout = HeadLayout.of({"mask": 1, "orientation": 2}, ("orientation",))
    target = layout.concat({n: _nchw(v) for n, v in heads.items()})
    gates = []
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        ref_img, ref_tgt = jax_batch_heads(
            key, jnp.asarray(image), {n: jnp.asarray(v) for n, v in heads.items()},
            orientation_keys=("orientation",), gauss_sigma=gauss_sigma)
        d = _jax_draws(key, b, image.shape, gauss_sigma=gauss_sigma)
        out_img, out_tgt = augment_heads_volume_apply(_nchw(image), target, layout.codes, d)
        assert _ulps(_nhwc(out_img), np.asarray(ref_img)) <= 1
        for name, v in layout.split(out_tgt).items():
            np.testing.assert_array_equal(_nhwc(v), np.asarray(ref_tgt[name]), err_msg=name)
        gates += d.flag("gate").tolist()
    assert 0 < sum(gates) < len(gates)  # both gate states drawn
    index = torch.tensor([5, 1, 1, 7], dtype=torch.int64)
    d = draw(torch.Generator().manual_seed(0), 4, (4, 1, 3, 8, 8), gauss_sigma=0.05)
    before = (augment_heads_volume_apply.launches, augment_heads_apply.launches)
    out = augment_heads_apply(_nchw(image), target, layout.codes, d, index=index)
    assert (augment_heads_volume_apply.launches, augment_heads_apply.launches) == before
    ref = augment_heads_apply_plain(_nchw(image)[index], target[index], layout.codes, d)
    assert all(torch.equal(a, r) for a, r in zip(out, ref))
    img, tgts = augment_batch_heads(torch.Generator().manual_seed(1), _nchw(image),
                                    {n: _nchw(v) for n, v in heads.items()}, ("orientation",),
                                    index=index)
    assert img.shape == (4, 1, 3, 8, 8) and tgts["orientation"].shape == (4, 2, 3, 8, 8)
    norm = tgts["orientation"].pow(2).sum(1)
    assert torch.allclose(norm, torch.ones_like(norm), atol=1e-5)


# --- the 3D host transforms and DataProcessMultiOutput3D --------------------------------

def test_3d_host_transforms_match_jax(rng):
    """``RandomCrop3D`` and the volumetric ``Blur`` equal JAX's on one draw
    (the blur in-plane, every z slice on its own); ``ShiftScaleRotate3D``
    with a non-identity draw within the 2D contract of the scipy warp against
    OpenCV's (≥ 99% of voxels within one level, median 0; masks ≥ 97%
    equal), and an exact copy at the identity."""
    vol = (rng.random((6, 40, 36)) * 255).astype(np.uint8)
    mask = ((rng.random((6, 40, 36)) > 0.5) * 255).astype(np.uint8)
    for seed in range(2):
        a = taug.RandomCrop3D((4, 16, 20)).sample(np.random.default_rng(seed), vol.shape)
        b = jaug.RandomCrop3D((4, 16, 20)).sample(np.random.default_rng(seed), vol.shape)
        assert a == b
        np.testing.assert_array_equal(taug.RandomCrop3D((4, 16, 20)).apply(vol, a),
                                      jaug.RandomCrop3D((4, 16, 20)).apply(vol, b))
    volf = vol.astype(np.float32) / 255
    for k in (3, 5):
        ours = taug.Blur(volumetric=True).apply(volf, {"ksize": k})
        np.testing.assert_array_equal(ours, jaug.Blur(volumetric=True).apply(volf, {"ksize": k}))
        np.testing.assert_array_equal(ours[2], taug.Blur().apply(volf[2], {"ksize": k}))
    params = {"dx": 0.0, "dy": 0.0, "scale": 0.8, "angle": 35.0}
    ours, ref = taug.ShiftScaleRotate3D(), jaug.ShiftScaleRotate3D()
    assert ours.sample(np.random.default_rng(1), vol.shape) == ref.sample(
        np.random.default_rng(1), vol.shape)
    diff = np.abs(ours.apply(vol, params).astype(int) - ref.apply(vol, params).astype(int))
    assert np.mean(diff <= 1) >= 0.99 and np.median(diff) == 0, (diff.max(), np.mean(diff > 1))
    same = ours.apply_mask(mask, params) == ref.apply_mask(mask, params)
    assert same.mean() >= 0.97, same.mean()
    ident = {"dx": 0.0, "dy": 0.0, "scale": 1.0, "angle": 0.0}
    np.testing.assert_array_equal(ours.apply(volf, ident), ref.apply(volf, ident))


@pytest.fixture(scope="module")
def head_tiffs(tmp_path_factory):
    """Two float volumes of (10, 20, 18) with a mask and an orientation-angle
    target (NaN in one corner)."""
    root = tmp_path_factory.mktemp("head_vols")
    rng = np.random.default_rng(12)
    dirs = {k: root / k for k in ("volume", "mask", "orientation")}
    for d in dirs.values():
        os.makedirs(d)
    for i in range(2):
        field = ndimage.gaussian_filter(rng.standard_normal((10, 20, 18)), 2.0)
        angle = rng.uniform(0, 2 * np.pi, (10, 20, 18)).astype(np.float32)
        angle[:, :3, :3] = np.nan
        jtiff.imwrite(str(dirs["volume"] / f"v{i}.tif"),
                      (rng.random((10, 20, 18)) + (field > 0)).astype(np.float32))
        jtiff.imwrite(str(dirs["mask"] / f"v{i}.tif"), (field > 0).astype(np.float32))
        jtiff.imwrite(str(dirs["orientation"] / f"v{i}.tif"), angle)
    return str(dirs["volume"]), [str(dirs["mask"]), str(dirs["orientation"])]


def test_dataprocess_multi_output_3d_bit_equal_to_jax(head_tiffs, tmp_path):
    """With ``scale_limit`` and ``rotate_limit`` (0, 0) the warp is the
    identity in both packages, so the draws stay aligned and every item is
    bit-equal (channels-first against channels-last; the orientation as
    (cos θ, sin θ), NaN filled)."""
    kw = dict(dim_out=SHAPE, aug_factor=4, seed=2, scale_limit=(0, 0), rotate_limit=(0, 0),
              nan_to_val=-1.0)
    ref = jpipe.DataProcessMultiOutput3D(*head_tiffs, data_dir=str(tmp_path / "jax"), **kw)
    ours = tpipe.DataProcessMultiOutput3D(*head_tiffs, data_dir=str(tmp_path / "port"), **kw)
    assert len(ours) == len(ref) == 8 and ours.target_keys == ["mask", "orientation"]
    for i in range(len(ref)):
        item = ours[i]
        assert item["volume"].shape == (1,) + SHAPE and item["orientation"].shape == (2,) + SHAPE
        for key in ("volume", "mask", "orientation"):
            np.testing.assert_array_equal(item[key], np.moveaxis(ref[i][key], -1, 0),
                                          err_msg=f"{i} {key}")
    vols = [ours[i]["volume"] for i in range(len(ours))]
    assert any(not np.array_equal(vols[0], v) for v in vols[1:4])


# --- the Trainer -------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX ``multi_output_unet3d.Trainer`` (``MultiOutputUnet3D``, mask +
    orientation heads, 3D head losses) on resident volumes: its initial
    weights as a ``.pt``, its ``metrics.csv`` rows and final variables."""
    root = tmp_path_factory.mktemp("jax_train_heads3d")
    out = str(root / "run")
    with jit_init():
        t = jmo3d.Trainer(HeadVolumes("zxyc"), HEADS, EPOCHS, batch_size=BATCH, lr=LR,
                          n_filter=N_FILTER, save_dir=out, seed=0, mesh=get_mesh(n_data=1),
                          device_cache=True)
    init_path = str(root / "init.pt")
    export_torch_checkpoint(init_path, {"params": t.params, "batch_stats": t.batch_stats},
                            {"model_name": "MultiOutputUnet3D", "n_filter": N_FILTER,
                             "output_heads": HEADS, "use_interpolation": False}, epoch=0)
    t.start()
    return init_path, _rows(out), {"params": t.params, "batch_stats": t.batch_stats}


def test_multi_output_unet3d_trainer_matches_jax(jax_run, tmp_path):
    """``multi_output_unet3d.Trainer`` from JAX's initial weights on
    resident volumes: ``metrics.csv`` within rtol 1e-4 and the final weights
    within the bounds of ``test_torch_train.py``; the ``.pt`` rebuilds in
    ``PredictMultiOutput3D``."""
    init_path, ref_rows, ref_vars = jax_run
    t = multi_output_unet3d.Trainer(HeadVolumes("czxy"), HEADS, EPOCHS, batch_size=BATCH, lr=LR,
                                    n_filter=N_FILTER, save_dir=str(tmp_path), seed=0,
                                    load_weights=init_path, device_cache=True, device="cpu")
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


def test_first_step_gradients_nearest_decoder_match_jax(tmp_path):
    """One train-mode forward and backward of ``MultiOutputUnet3D`` with the
    nearest decoder (the strided ×0.5 views, nearest ×2 and the
    ``up<i>_conv`` blocks) and the 3D head losses: every gradient within
    1e-4 of its tensor's largest entry of ``jax.grad``'s, the conv biases in
    front of a BatchNorm excepted.

    The head convs are scaled by 1/4: the seeded draw as written puts 38 of
    the 8192 mask voxels at or past BCE's clip bound 1 − 1e-7, where the
    gradient hangs on the last bit of each sigmoid and both frameworks'
    float32 gradients lie 5% from a float64 one (the tie at the bound itself
    is ``test_torch_losses.py::test_gradient_on_a_clip_bound_matches_jax``).
    JAX's gradient is taken in float64 (jitted): a float32 ``jax.grad`` of
    this decoder is 1.6% from float64 on XLA's CPU backend when jitted and
    2.6e-5 eager, at ten times the time; the port is within 3e-5."""
    from bio_image_unet_tpu.interop.torch_export import variables_to_torch_state_dict
    from bio_image_unet_tpu.losses import get_head_loss as jget_head_loss
    from bio_image_unet_tpu.models import MultiOutputUnet3D as JaxMO3D

    path, variables = write_seeded_checkpoint(tmp_path, "near", "MultiOutputUnet3D", 5,
                                          n_filter=N_FILTER, output_heads=HEADS,
                                          use_interpolation=True)
    params = {k: dict(v) for k, v in variables["params"].items()}
    state = torch.load(path, weights_only=True)["state_dict"]
    for name in HEADS:
        params[f"output_layers_{name}"]["kernel"] = params[f"output_layers_{name}"]["kernel"] / 4
        state[f"output_layers.{name}.weight"] = state[f"output_layers.{name}.weight"] / 4
    data = HeadVolumes("zxyc")
    batch = {k: np.stack([data[i][k] for i in range(BATCH)]) for k in data[0]}
    model = JaxMO3D(n_filter=N_FILTER, output_heads=HEADS, use_interpolation=True)
    jlosses = {n: jget_head_loss(c["loss"], family="3d") for n, c in HEADS.items()}

    def loss_fn(p, stats, inputs):
        out, _ = model.apply({"params": p, "batch_stats": stats}, inputs["volume"], train=True,
                             mutable=["batch_stats"])
        return sum(c.get("weight", 1.0) * jlosses[n](out[n], inputs[n])
                   for n, c in HEADS.items())

    with jax.enable_x64(True):
        f64 = partial(jax.tree_util.tree_map, lambda a: jnp.asarray(a, jnp.float64))
        grads = jax.jit(jax.grad(loss_fn))(f64(params), f64(variables["batch_stats"]),
                                           f64(batch))
        grads = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), grads)
    ref = variables_to_torch_state_dict({"params": grads})
    net = MultiOutputUnet3D(n_filter=N_FILTER, output_heads=HEADS, use_interpolation=True)
    net.load_state_dict(state)
    out = net.train()(_nchw(batch["volume"]))
    assert float(out["mask"].max()) < 0.999  # off the clip bound
    sum(c.get("weight", 1.0) * get_head_loss(c["loss"], family="3d")(out[n], _nchw(batch[n]))
        for n, c in HEADS.items()).backward()
    grads = {k: p.grad.numpy() for k, p in net.named_parameters()}
    assert set(grads) == set(ref)
    top = max(float(np.abs(g).max()) for g in ref.values())
    for k, g in ref.items():
        g = np.asarray(g)
        if _pre_bn_bias(k):
            assert np.abs(g).max() < 1e-5 * top and np.abs(grads[k]).max() < 1e-5 * top, k
            continue
        np.testing.assert_allclose(grads[k], g, rtol=0, atol=1e-4 * np.abs(g).max(), err_msg=k)


@pytest.mark.parametrize("network", ["MultiOutputUnet3D", MultiOutputUnet3D],
                         ids=["string", "class"])
def test_multi_output_unet3d_by_class_or_name_trains_3d(tmp_path, network):
    """A ``MultiOutputUnet3D`` named or passed as a class takes the 3D path
    (the fault the name-only guard let through): the 3D head losses,
    ``use_interpolation=False`` reaching the model against its class default
    True, and a ``.pt`` that rebuilds in ``PredictMultiOutput3D`` with
    ``strict=True``."""
    data = HeadVolumes("czxy", n=5)
    t = Trainer(data, 1, network=network, output_heads=HEADS, batch_size=2, n_filter=N_FILTER,
                grad_clip=1.0, save_dir=str(tmp_path), seed=0, device="cpu")
    assert isinstance(t.model, MultiOutputUnet3D) and t.input_key == "volume"
    assert not t.model.use_interpolation and hasattr(t.model, "up1")
    for name, cfg in HEADS.items():
        assert type(t.head_losses[name]) is type(get_head_loss(cfg["loss"], family="3d"))
    assert type(t.head_losses["mask"]) is not type(get_head_loss("BCEDiceLoss", family="2d"))
    t.start()
    state = jcheckpoint.peek(str(tmp_path / "model.ckpt"))["hyperparams"]
    assert state["model_name"] == "MultiOutputUnet3D" and state["use_interpolation"] is False
    assert state["output_heads"] == HEADS
    vol = np.random.default_rng(0).integers(0, 255, (8, 20, 20), dtype=np.uint8)
    res = PredictMultiOutput3D(vol, str(tmp_path / "model.ckpt"), max_patch_size=SHAPE,
                               show_progress=False, device="cpu").result
    assert res["mask"].shape == vol.shape and res["orientation"].shape == (2,) + vol.shape


def test_multi_output_unet3d_facade_defaults_and_loader_path(tmp_path):
    """The facade's defaults are the JAX facade's (the checkpoint too:
    ``model.ckpt``); ``output_heads`` is its second positional argument; the dead
    ``loss_function``/``time_loss_weight`` knobs are dropped; the loader
    path (``device_cache=False``) with device augmentation trains an epoch."""
    ours = inspect.signature(multi_output_unet3d.Trainer.__init__).parameters
    ref = inspect.signature(jmo3d.Trainer.__init__).parameters
    assert list(ours) == list(ref)
    for name, p in ref.items():
        assert ours[name].default == p.default, name
    assert ours["save_name"].default == "model.ckpt"
    assert multi_output_unet3d.DataProcess is tpipe.DataProcessMultiOutput3D
    t = multi_output_unet3d.Trainer(HeadVolumes("czxy", n=6), HEADS, 1, batch_size=2,
                                    n_filter=N_FILTER, save_dir=str(tmp_path), seed=0,
                                    time_loss_weight=0.1, device_augment=True, log_images=True,
                                    device="cpu")
    assert (t.grad_clip, t.scheduler.patience, t.scheduler.factor) == (1.0, 5, 0.2)
    assert t.time_loss_weight is None and t.multi_output and t._device_data is None
    t.start()
    assert np.isfinite(t.history[0]["train_loss"]) and len(_rows(tmp_path)) == 1
    try:  # the validation grid shows the middle z slice where matplotlib exists
        import matplotlib  # noqa: F401
    except ImportError:
        assert not (tmp_path / "val_results").exists()
    else:
        assert (tmp_path / "val_results" / "epoch_0.png").exists()
