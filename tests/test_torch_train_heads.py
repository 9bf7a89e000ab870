"""The port's multi-output training (``MultiOutputUnet``, both UNet++
depths) held against the JAX package on the CPU.

- ``VGGBlock`` and UNet++ in bf16 compute mode, and UNet++ first-step
  gradients with deep supervision: the port's weights are carried to JAX
  through a reference ``.pt``, and JAX runs ``model.apply`` +
  ``jax.value_and_grad`` (no ``init``).  float32: loss within 1e-6 relative,
  gradients within 1e-4 of each tensor's largest entry (the conv biases in
  front of a BatchNorm excepted: their gradient is rounding noise on both
  sides, ``test_torch_train.py``).  bf16: JAX builds the ``align_corners``
  upsample weights in bf16, the port in float32 (``ops/functional.py``), so
  the heads are held to twice JAX's own bf16-vs-float32 difference.
- The deep-supervision loss: JAX's ``Trainer._compute_loss`` and the port's,
  each called unbound on the fields it reads, to float32 rounding.
- The whole JAX ``Trainer`` against the port's on ``MultiOutputUnet``
  (n_filter 4, 32², mask + orientation heads), 2 epochs from the same
  initial weights, through the loader and with the tiles resident:
  ``metrics.csv`` within rtol 1e-4 (the bound of ``test_torch_train.py``).
- Resume = straight run; the port-trained ``.pt`` read by the JAX
  restricted reader, both ``PredictMultiOutput``s within
  ``test_torch_heads.py``'s ``1e-3 + 1e-3·|JAX|``; TensorBoard event files read back by
  ``tensorboard``; the facade's defaults; the modules with JAX blocked.
"""

import csv
import os
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bio_image_unet_tpu import checkpoint as jcheckpoint
from bio_image_unet_tpu.interop.pt_reader import read_pt
from bio_image_unet_tpu.interop.torch_export import (export_torch_checkpoint,
                                                     variables_to_torch_state_dict)
from bio_image_unet_tpu.losses import get_head_loss as jget_head_loss
from bio_image_unet_tpu.models import MultiOutputNestedUNet_3Levels as JNested3
from bio_image_unet_tpu.ops.blocks import VGGBlock as JVGGBlock
from bio_image_unet_tpu.parallel import get_mesh
from bio_image_unet_tpu.predict import PredictMultiOutput as JPredictMultiOutput
from bio_image_unet_tpu.train import Trainer as JaxTrainer
from bio_image_unet_tpu.utils import tboard as jtboard
from bio_image_unet_tpu_torch import multi_output_unet
from bio_image_unet_tpu_torch.interop import state_dict_from_jax
from bio_image_unet_tpu_torch.losses import get_head_loss
from bio_image_unet_tpu_torch.models import get_model
from bio_image_unet_tpu_torch.ops.blocks import VGGBlock, init_weights_
from bio_image_unet_tpu_torch.predict import PredictMultiOutput
from bio_image_unet_tpu_torch.train import Trainer
from bio_image_unet_tpu_torch.utils import tboard
from bio_image_unet_tpu_torch.utils.synth import blob_sample
from torch_parity import jit_init, default_threads

REPO = Path(__file__).resolve().parent.parent
HEADS = {"mask": {"channels": 1, "activation": "sigmoid", "loss": "BCEDiceLoss"},
         "orientation": {"channels": 2, "activation": None, "loss": "MSELoss", "weight": 0.5}}
N_FILTER, SIZE, BATCH, EPOCHS, LR = 4, 32, 4, 2, 1e-4


class HeadTiles:
    """12 blob tiles with a mask and an orientation field (the angle about
    the tile centre, as (cos θ, sin θ)); ``layout`` 'hwc' (JAX) or 'chw'
    (port)."""

    def __init__(self, layout: str, n: int = 12, size: int = SIZE, seed: int = 0):
        rng = np.random.default_rng(seed)
        yy, xx = np.mgrid[:size, :size]
        self.items = []
        for _ in range(n):
            img, mask = blob_sample(rng, (size, size), n_blobs=3, margin=4, radius=(3, 6))
            theta = np.arctan2(yy - rng.uniform(0, size), xx - rng.uniform(0, size))
            item = {"image": (img / 255.0).astype(np.float32)[None],
                    "mask": (mask / 255.0).astype(np.float32)[None],
                    "orientation": np.stack([np.cos(theta), np.sin(theta)]).astype(np.float32)}
            if layout == "hwc":
                item = {k: np.ascontiguousarray(np.moveaxis(v, 0, -1)) for k, v in item.items()}
            self.items.append(item)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def _rows(save_dir):
    with open(os.path.join(save_dir, "metrics.csv")) as fh:
        rows = list(csv.reader(fh))
    assert rows[0] == ["epoch", "train_loss", "val_loss", "lr", "seconds"]
    return np.array([[float(v) for v in r[:4]] for r in rows[1:]])


def _nchw(x):
    return torch.from_numpy(np.moveaxis(np.asarray(x), -1, 1).copy())


def _pre_bn_bias(key: str) -> bool:
    """A ``VGGBlock`` conv bias (``conv<i>_<j>.conv{1,2}.bias``), in front of
    its BatchNorm."""
    return key.endswith((".conv1.bias", ".conv2.bias"))


# --- models: bf16 mode, first-step gradients ----------------------------------------

@pytest.mark.parametrize("dilation", [1, 2])
def test_vgg_block_bf16_matches_jax(rng, dilation):
    """Train mode, bf16 compute: the port's casts are JAX's (bf16 convs,
    float32 BatchNorm, bf16 out).  The two bf16 blocks round their convs
    differently, and train-mode BatchNorm scales those roundings up, so the
    output is held to twice JAX's own bf16-vs-float32 difference; float32
    parameters and running statistics."""
    block = init_weights_(VGGBlock(3, 6, 5, dilation), torch.Generator().manual_seed(1),
                          random_bn_stats=True)
    sd = {f"b.{k}": v for k, v in block.state_dict().items()}
    # the JAX variables of the same weights, through the reference schema
    variables = {"params": {}, "batch_stats": {}}
    for k, (ci, co) in enumerate(((3, 6), (6, 5)), start=1):
        conv, bn = f"b.conv{k}", f"b.bn{k}"
        variables["params"][f"conv{k}"] = {
            "kernel": sd[f"{conv}.weight"].numpy().transpose(2, 3, 1, 0),
            "bias": sd[f"{conv}.bias"].numpy()}
        variables["params"][f"bn{k}"] = {"scale": sd[f"{bn}.weight"].numpy(),
                                         "bias": sd[f"{bn}.bias"].numpy()}
        variables["batch_stats"][f"bn{k}"] = {"mean": sd[f"{bn}.running_mean"].numpy(),
                                              "var": sd[f"{bn}.running_var"].numpy()}
    x = rng.random((2, 12, 12, 3)).astype(np.float32)
    ref, mutated = JVGGBlock(6, 5, dilation=dilation, dtype=jnp.bfloat16).apply(
        variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    ref32, _ = JVGGBlock(6, 5, dilation=dilation).apply(
        variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    block.compute_dtype = torch.bfloat16
    out = block.train()(_nchw(x))
    assert out.dtype == torch.bfloat16 and block.conv1.weight.dtype == torch.float32
    assert block.bn1.running_mean.dtype == torch.float32
    want = np.moveaxis(np.asarray(ref.astype(jnp.float32)), -1, 1)
    gap = np.abs(want - np.moveaxis(np.asarray(ref32), -1, 1)).max()
    assert np.abs(out.float().detach().numpy() - want).max() <= 2 * gap
    np.testing.assert_allclose(block.bn2.running_var.numpy(),
                               np.asarray(mutated["batch_stats"]["bn2"]["var"]), rtol=1e-2)



@pytest.fixture(scope="module", autouse=True)
def _default_thread_count():
    """The Trainer parity here (``metrics.csv`` within rtol 1e-4 of JAX's)
    sits near its bound in float32: it runs with torch's default thread
    count, the one its sums were measured with (``torch_parity`` sets one
    thread a process)."""
    with default_threads():
        yield

@pytest.fixture(scope="module")
def nested3(tmp_path_factory):
    """A deep-supervision ``MultiOutputNestedUNet_3Levels`` with seeded
    weights drawn in the port, its JAX variables (read from the ``.pt``) and
    one batch."""
    hyper = {"model_name": "MultiOutputNestedUNet_3Levels", "n_filter": N_FILTER,
             "in_channels": 1, "output_heads": HEADS, "deep_supervision": True}
    net = init_weights_(get_model(hyper["model_name"], **hyper),
                        torch.Generator().manual_seed(0), random_bn_stats=True)
    path = str(tmp_path_factory.mktemp("nested3") / "n3.pt")
    torch.save({"state_dict": net.state_dict(), **hyper}, path)
    data = HeadTiles("hwc", n=2)
    batch = {k: np.stack([data[i][k] for i in range(2)]) for k in ("image", "mask", "orientation")}
    return hyper, net.state_dict(), jcheckpoint.load(path)["variables"], batch


def _jax_first_step(variables, batch, dtype):
    model = JNested3(n_filter=N_FILTER, output_heads=HEADS, deep_supervision=True, dtype=dtype)

    def loss_fn(params):
        out, _ = model.apply({"params": params, "batch_stats": variables["batch_stats"]},
                             jnp.asarray(batch["image"]), train=True, mutable=["batch_stats"])
        total = 0.0
        for name, cfg in HEADS.items():
            for level, w in enumerate([0.5, 0.75, 1.0], 1):
                total += w * cfg.get("weight", 1.0) * jget_head_loss(cfg["loss"])(
                    out[f"{name}_{level}"], jnp.asarray(batch[name]))
        return total, out

    (loss, out), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    return float(loss), out, variables_to_torch_state_dict({"params": grads})


def _port_first_step(hyper, state, batch, dtype):
    net = get_model(hyper["model_name"], **hyper, dtype=dtype)
    net.load_state_dict(state)
    head_inputs = []
    for layer in net.output_layers.values():  # the 1×1 heads run in float32
        layer.register_forward_pre_hook(lambda m, args: head_inputs.append(args[0].dtype))
    out = net.train()(_nchw(batch["image"]))
    ns = types.SimpleNamespace(multi_output=True, deep_supervision=True, levels=net.levels,
                               output_heads=HEADS,
                               head_weights={k: c.get("weight", 1.0) for k, c in HEADS.items()},
                               head_losses={k: get_head_loss(c["loss"]) for k, c in HEADS.items()})
    loss = Trainer._compute_loss(ns, out, {k: _nchw(batch[k]) for k in HEADS}, train=True)
    loss.backward()
    assert set(head_inputs) == {torch.float32}
    return loss.item(), out, {k: p.grad.numpy() for k, p in net.named_parameters()}


def test_nested_first_step_gradients_match_jax_float32(nested3):
    hyper, state, variables, batch = nested3
    ref_loss, ref_out, ref = _jax_first_step(variables, batch, None)
    loss, out, grads = _port_first_step(hyper, state, batch, None)
    assert abs(loss - ref_loss) <= 1e-6 * abs(ref_loss)
    assert set(out) == {f"{h}{s}" for h in HEADS for s in ("", "_1", "_2", "_3")}
    for name in out:
        np.testing.assert_allclose(out[name].detach().numpy(),
                                   np.moveaxis(np.asarray(ref_out[name]), -1, 1),
                                   rtol=0, atol=2e-4, err_msg=name)
    assert set(grads) == set(ref)
    top = max(float(np.abs(np.asarray(g)).max()) for g in ref.values())
    for k, g in ref.items():
        g = np.asarray(g)
        if _pre_bn_bias(k):
            assert np.abs(g).max() < 1e-4 * top and np.abs(grads[k]).max() < 1e-4 * top, k
            continue
        np.testing.assert_allclose(grads[k], g, rtol=0, atol=1e-4 * np.abs(g).max(), err_msg=k)


def test_nested_bf16_forward_matches_jax(nested3):
    """bf16 compute: float32 heads and loss; each head within twice JAX's own
    bf16-vs-float32 difference of JAX's bf16 output (the upsample weights
    are rounded to bf16 in JAX only)."""
    hyper, state, variables, batch = nested3
    _, ref32, _ = _jax_first_step(variables, batch, None)
    ref_loss, ref16, _ = _jax_first_step(variables, batch, jnp.bfloat16)
    loss, out, grads = _port_first_step(hyper, state, batch, torch.bfloat16)
    assert abs(loss - ref_loss) <= 1e-2 * abs(ref_loss)
    for name in HEADS:
        assert out[name].dtype == torch.float32
        a = out[name].detach().numpy()
        b16, b32 = (np.moveaxis(np.asarray(r[name]), -1, 1) for r in (ref16, ref32))
        assert np.abs(a - b16).max() <= 2 * np.abs(b16 - b32).max(), name
    assert all(np.isfinite(g).all() for g in grads.values())


@pytest.mark.parametrize("levels", [3, 4])
@pytest.mark.parametrize("train", [True, False])
def test_deep_supervision_loss_matches_jax(rng, levels, train):
    """``_compute_loss`` of both Trainers, called unbound on the fields it
    reads, on the same outputs of every level: equal to float32 rounding."""
    outs = {}
    for name, cfg in HEADS.items():
        for s in [""] + [f"_{lv}" for lv in range(1, levels + 1)]:
            v = rng.random((2, 16, 16, cfg["channels"])).astype(np.float32)
            outs[name + s] = v if cfg["activation"] else v * 4 - 2
    batch = {"mask": (rng.random((2, 16, 16, 1)) > 0.5).astype(np.float32),
             "orientation": rng.uniform(-1, 1, (2, 16, 16, 2)).astype(np.float32)}
    weights = {k: c.get("weight", 1.0) for k, c in HEADS.items()}

    def fields(losses):
        return types.SimpleNamespace(multi_output=True, deep_supervision=True, levels=levels,
                                     output_heads=HEADS, head_weights=weights,
                                     head_losses={k: losses(c["loss"]) for k, c in HEADS.items()})

    ref = JaxTrainer._compute_loss(fields(jget_head_loss), {k: jnp.asarray(v) for k, v in
                                                            outs.items()},
                                   {k: jnp.asarray(v) for k, v in batch.items()}, train)
    ours = Trainer._compute_loss(fields(get_head_loss), {k: _nchw(v) for k, v in outs.items()},
                                 {k: _nchw(v) for k, v in batch.items()}, train)
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-6)
    with pytest.raises(ValueError, match="levels not valid"):
        bad = fields(get_head_loss)
        bad.levels = 5
        Trainer._compute_loss(bad, {k: _nchw(v) for k, v in outs.items()},
                              {k: _nchw(v) for k, v in batch.items()}, True)


# --- the Trainer against JAX's ------------------------------------------------------

@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The exported initial weights and, per data path, the JAX Trainer's
    ``metrics.csv`` rows on ``MultiOutputUnet``."""
    root = tmp_path_factory.mktemp("jax_train_heads")
    init_path, runs = str(root / "init.pt"), {}
    for cache in (False, True):
        out = str(root / f"cache{int(cache)}")
        with jit_init():
            t = JaxTrainer(HeadTiles("hwc"), EPOCHS, network="MultiOutputUnet",
                           batch_size=BATCH, lr=LR, n_filter=N_FILTER, output_heads=HEADS,
                           save_dir=out, seed=0, mesh=get_mesh(n_data=1), device_cache=cache)
        if not cache:
            export_torch_checkpoint(init_path, {"params": t.params, "batch_stats": t.batch_stats},
                                    {"model_name": "MultiOutputUnet", "n_filter": N_FILTER,
                                     "output_heads": HEADS}, epoch=0)
        t.start()
        runs[cache] = _rows(out)
    return init_path, runs


def _port_trainer(out, data=None, **kw):
    kw = {"network": "MultiOutputUnet", "batch_size": BATCH, "lr": LR, "n_filter": N_FILTER,
          "output_heads": HEADS, "save_dir": str(out), "seed": 0, "device": "cpu", **kw}
    return Trainer(data if data is not None else HeadTiles("chw"), kw.pop("epochs", EPOCHS), **kw)


@pytest.mark.parametrize("cache", [False, True], ids=["loader", "device_cache"])
def test_multi_output_trainer_matches_jax(jax_runs, tmp_path, cache):
    init_path, runs = jax_runs
    t = _port_trainer(tmp_path, load_weights=init_path, device_cache=cache)
    assert t.multi_output and t.layout.names == ("mask", "orientation")
    t.start()
    rows, ref = _rows(tmp_path), runs[cache]
    assert rows.shape == ref.shape == (EPOCHS, 4)
    np.testing.assert_array_equal(rows[:, 0], ref[:, 0])
    np.testing.assert_allclose(rows[:, 1:], ref[:, 1:], rtol=1e-4)


def test_multi_output_resume_equals_straight_run(tmp_path):
    """UNet++ with deep supervision, resident tiles and K4h's plain version:
    1 epoch, a resume and 1 more equal 2 epochs straight."""
    kw = {"network": "MultiOutputNestedUNet_3Levels", "deep_supervision": True,
          "device_cache": True, "device_augment": True, "grad_clip": 1.0}
    straight = _port_trainer(tmp_path / "straight", **kw)
    straight.start()
    first = _port_trainer(tmp_path / "resumed", epochs=1, **kw)
    first.start()
    second = _port_trainer(tmp_path / "resumed", epochs=1, load_weights=True, **kw)
    assert second.epoch_start == 1 and second.best_loss == first.best_loss
    second.start()
    np.testing.assert_allclose(_rows(tmp_path / "resumed"), _rows(tmp_path / "straight"),
                               rtol=1e-6)
    for (k, a), b in zip(second.model.state_dict().items(),
                         straight.model.state_dict().values()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7, err_msg=k)


def test_trained_checkpoint_read_by_jax_and_both_predicts_agree(tmp_path):
    """A deep-supervision UNet++ trained by the port: its ``.pt`` is read by
    the JAX package's restricted unpickler (no fallback to ``torch.load``),
    carries the resolved heads, and both ``PredictMultiOutput``s agree."""
    t = _port_trainer(tmp_path, epochs=1, network="MultiOutputNestedUNet_3Levels",
                      deep_supervision=True, device_cache=True, device_augment=True,
                      save_name="model.pt")
    t.start()
    path = str(tmp_path / "model.pt")
    raw = read_pt(path)
    assert raw["model_name"] == "MultiOutputNestedUNet_3Levels" and raw["deep_supervision"]
    assert raw["output_heads"] == HEADS and raw["epoch"] == 1
    assert "output_layers.orientation_3.weight" in raw["state_dict"]
    sd = state_dict_from_jax(jcheckpoint.load(path)["variables"])
    assert set(sd) == set(t.model.state_dict())
    movie = np.random.default_rng(4).integers(0, 255, (3, 48, 40), dtype=np.uint8)
    kw = dict(max_patch_size=(32, 32), safe_margin=4, show_progress=False, batch_size=4)
    for dp in (None, False):
        ref = JPredictMultiOutput(movie, path, device_pipeline=dp, **kw).result
        ours = PredictMultiOutput(movie, path, device="cpu", device_pipeline=dp, **kw).result
        assert set(ours) == set(ref) == set(HEADS)
        for head in HEADS:
            bad = np.abs(ours[head] - ref[head]) > 1e-3 + 1e-3 * np.abs(ref[head])
            assert ours[head].shape == ref[head].shape and not bad.any(), (dp, head)


# --- observability, facade, options -------------------------------------------------

def test_tensorboard_event_file_round_trips(tmp_path):
    """The port's writer: scalars and a grayscale image read back by
    ``tensorboard``'s EventAccumulator, byte-for-byte the JAX writer's
    encoding."""
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    w = tboard.SummaryWriter(str(tmp_path / "logs"))
    for step, v in enumerate((0.5, 0.25, -3.0)):
        w.add_scalar("Loss/train", v, step)
    img = np.linspace(0, 1, 12 * 10, dtype=np.float32).reshape(1, 12, 10)
    w.add_image("val/mask", img, 2)
    w.flush()
    w.close()
    acc = EventAccumulator(str(tmp_path / "logs"), size_guidance={"images": 0})
    acc.Reload()
    assert [(e.step, e.value) for e in acc.Scalars("Loss/train")] == [(0, 0.5), (1, 0.25),
                                                                       (2, -3.0)]
    (im,) = acc.Images("val/mask")
    assert (im.step, im.width, im.height) == (2, 10, 12)
    gray = (img[0] * 255).astype(np.uint8)
    assert tboard.encode_png_gray(gray) == jtboard.encode_png_gray(gray)
    for data in (b"", b"abc", bytes(range(256))):
        assert tboard._masked_crc(data) == jtboard._masked_crc(data)


def test_facade_defaults_and_logging(tmp_path):
    """``multi_output_unet.Trainer`` keeps the JAX facade's defaults; a short
    run writes TensorBoard scalars, validation grids and ``model.ckpt``."""
    data = HeadTiles("chw")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            multi_output_unet.Trainer(data, 1, n_filter=4, save_dir=str(tmp_path / "auto"))
    t = multi_output_unet.Trainer(data, 1, n_filter=4, output_heads=HEADS,
                                  save_dir=str(tmp_path / "out"), device="cpu")
    assert type(t.model).__name__ == "MultiOutputNestedUNet" and t.levels == 4
    assert (t.lr, t.grad_clip, t.scheduler.patience, t.scheduler.factor) == (1e-4, 1.0, 5, 0.2)
    assert t.writer is not None and t.log_images and t.save_name == "model.ckpt"
    assert t.params_meta["model_name"] == "MultiOutputNestedUNet"
    assert t.params_meta["output_heads"] == HEADS and t.params_meta["deep_supervision"] is False
    import inspect

    defaults = inspect.signature(multi_output_unet.Trainer).parameters
    assert defaults["n_filter"].default == 64 and defaults["dilation"].default is False
    assert multi_output_unet.Predict is PredictMultiOutput
    assert multi_output_unet.BCEDiceLoss()(torch.full((1, 1, 4, 4), 0.5),
                                           torch.ones((1, 1, 4, 4))) > 0
    t.start()
    out = tmp_path / "out"
    assert (out / "model.ckpt").exists()
    assert any(f.startswith("events.out.tfevents") for f in os.listdir(out / "logs"))
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        assert not (out / "val_results").exists()
    else:
        assert (out / "val_results" / "epoch_0.png").exists()
    # default heads: the model's single sigmoid head with BCEDice
    d = multi_output_unet.Trainer(
        [{"image": x["image"], "default": x["mask"]} for x in data.items], 1, n_filter=4,
        network="MultiOutputUnet", tensorboard=False, log_images=False,
        save_dir=str(tmp_path / "default"), device="cpu")
    assert d.output_heads == {"default": {"loss": "BCEDiceLoss", "channels": 1,
                                          "activation": "sigmoid"}}


def test_unported_and_invalid_options(tmp_path):
    data = HeadTiles("chw", n=4)
    # mesh= is ported: what is not a mesh is refused by name; the mesh of one
    # (no process group) builds the Trainer, device_cache="sharded" on it too
    from bio_image_unet_tpu_torch.parallel import get_mesh

    with pytest.raises(TypeError, match="mesh"):
        _port_trainer(tmp_path, data, mesh=object())
    for cache in (False, "sharded"):
        t = _port_trainer(tmp_path, data, mesh=get_mesh(), device_cache=cache)
        assert t.mesh.shape == {"data": 1, "spatial": 1} and not t.mesh.distributed
    # the siamese join is ported, for networks that have one
    with pytest.raises(ValueError, match="siamese join"):
        _port_trainer(tmp_path, data, mode="max")
    # the 3D options are ported: with heads the temporal term does not apply
    # (trainer.py:436-458), and a 2D model drops use_interpolation
    t = _port_trainer(tmp_path, data, time_loss_weight=0.1, use_interpolation=True)
    assert t.multi_output and not hasattr(t.model, "use_interpolation")
    with pytest.raises(ValueError, match="deep_supervision needs a UNet\\+\\+"):
        _port_trainer(tmp_path, data, deep_supervision=True)


def test_train_heads_modules_run_without_jax(tmp_path):
    """The multi-output data pipeline, K4h's wrapper, the Trainer, the
    TensorBoard writer and the facade import and train on the CPU with JAX,
    flax, optax, ml_dtypes and the JAX package made unimportable (names
    matched exactly or followed by '.')."""
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
        import bio_image_unet_tpu_torch.data.augment_device
        import bio_image_unet_tpu_torch.utils.tboard
        from bio_image_unet_tpu_torch import multi_output_unet
        from bio_image_unet_tpu_torch.data import tiff
        root = {str(tmp_path)!r}
        import os
        rng = np.random.default_rng(0)
        for sub in ("image", "mask", "orientation"):
            os.makedirs(os.path.join(root, sub))
        for i in range(2):
            tiff.imwrite(os.path.join(root, "image", f"{{i}}.tif"),
                         rng.integers(0, 255, (40, 40)).astype(np.uint8))
            tiff.imwrite(os.path.join(root, "mask", f"{{i}}.tif"),
                         (rng.random((40, 40)) > 0.5).astype(np.float32))
            tiff.imwrite(os.path.join(root, "orientation", f"{{i}}.tif"),
                         rng.uniform(0, 3, (40, 40)).astype(np.float32))
        data = multi_output_unet.DataProcess(
            os.path.join(root, "image"), [os.path.join(root, "mask"),
                                          os.path.join(root, "orientation")],
            {{"mask": "mask", "orientation": "mask"}}, data_dir=os.path.join(root, "data"),
            dim_out=(32, 32), aug_factor=2, seed=0)
        heads = {HEADS!r}
        t = multi_output_unet.Trainer(data, 1, network="MultiOutputNestedUNet_3Levels",
                                      n_filter=4, output_heads=heads, deep_supervision=True,
                                      batch_size=2, device_cache=True, device_augment=True,
                                      save_dir=os.path.join(root, "run"), device="cpu")
        assert np.isfinite(t.start())
        leaked = sorted(n for n in sys.modules if sys.modules[n] is not None and
                        any(n == b or n.startswith(b + ".") for b in BLOCKED))
        assert not leaked, leaked
        print("OK")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("OK"), out.stdout[-2000:]
