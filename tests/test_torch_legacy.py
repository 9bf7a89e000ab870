"""The port's legacy 2D models ``Unet_v0`` and ``BabyUnet`` held against the
JAX package on the CPU, at ``n_filter=4`` with BatchNorm statistics warmed by
three train-mode applies (``torch_parity.warm_unet_variables``).

- the eval forward (``models.legacy``) on JAX's weights, carried over by
  ``interop.state_dict_from_jax``: logits within atol 1e-5 of JAX's;
- the folded forward (``predict.fastpath.FoldedLegacyUnet2D``, B4) against
  the unfolded one: atol 1e-5;
- a ``.pt`` written by JAX's ``export_torch_checkpoint`` (reference keys:
  ``decode9.0/.1``, ``final.0``), loaded by the port with ``strict=True``,
  through both packages' ``Predict``, fused and host-staged: within one uint8
  level on at most 0.1% of pixels; ``half_precision=True`` gives the same
  masks as ``False`` (the legacy path is float32 whatever it says);
- the first training step's loss and gradients against ``jax.grad``, with
  JAX's dropout channel mask (taken from the flax run with
  ``capture_intermediates``) set on the port's ``middle_conv2`` dropout by a
  test-only patch: loss within rtol 1e-5, each gradient within 1e-4 of its
  tensor's largest entry (the conv biases in front of a BatchNorm, whose
  gradient is rounding noise on both sides, below 1e-5 of the largest);
- the port's Trainer trains them in float32 whatever ``half_precision`` says,
  draws the dropout from its own generator (two runs equal), and writes a
  ``.pt`` that JAX's restricted reader reads and both ``Predict``s agree on.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bio_image_unet_tpu import checkpoint as jcheckpoint
from bio_image_unet_tpu.interop.pt_reader import read_pt
from bio_image_unet_tpu.interop.torch_export import (export_torch_checkpoint,
                                                     variables_to_torch_state_dict)
from bio_image_unet_tpu.losses import BCEDiceLoss as JBCEDice
from bio_image_unet_tpu.models import BabyUnet as JBabyUnet
from bio_image_unet_tpu.models import Unet_v0 as JUnet_v0
from bio_image_unet_tpu.predict import Predict as JPredict
from bio_image_unet_tpu_torch import checkpoint
from bio_image_unet_tpu_torch.interop import state_dict_from_jax
from bio_image_unet_tpu_torch.losses import BCEDiceLoss
from bio_image_unet_tpu_torch.models import BabyUnet, Unet_v0, get_model
from bio_image_unet_tpu_torch.models.legacy import ChannelDropout2d
from bio_image_unet_tpu_torch.predict import Predict
from bio_image_unet_tpu_torch.predict.fastpath import FoldedLegacyUnet2D, folded_forward
from bio_image_unet_tpu_torch.train import Trainer
from bio_image_unet_tpu_torch.utils.synth import blob_sample
from torch_parity import assert_u8_contract, warm_unet_variables

N_FILTER = 4
MODELS = {"Unet_v0": (JUnet_v0, Unet_v0), "BabyUnet": (JBabyUnet, BabyUnet)}


@pytest.fixture(scope="module", params=sorted(MODELS))
def legacy(request, tmp_path_factory):
    """(name, JAX model, warmed JAX variables, reference-schema ``.pt``)."""
    name = request.param
    model, variables = warm_unet_variables(N_FILTER, size=32, steps=3, seed=4,
                                           cls=MODELS[name][0])
    path = str(tmp_path_factory.mktemp(name) / f"{name}.pt")
    export_torch_checkpoint(path, variables, {"model_name": name, "n_filter": N_FILTER},
                            epoch=1, best_loss=0.5)
    return name, model, variables, path


def _nchw(x):
    return torch.from_numpy(np.moveaxis(np.asarray(x), -1, 1).copy())


def _port_net(name, variables):
    net = MODELS[name][1](n_filter=N_FILTER)
    net.load_state_dict(state_dict_from_jax(variables), strict=True)
    return net


def test_eval_forward_matches_jax(legacy, rng):
    name, model, variables, _ = legacy
    x = rng.random((2, 32, 32, 1)).astype(np.float32)
    probs, logits = jax.jit(lambda v, x: model.apply(v, x))(variables, jnp.asarray(x))
    net = _port_net(name, variables).eval()
    with torch.no_grad():
        p, z = net(_nchw(x))
    assert z.dtype == torch.float32 and z.shape == (2, 1, 32, 32)
    np.testing.assert_allclose(z.numpy(), np.moveaxis(np.asarray(logits), -1, 1), atol=1e-5)
    np.testing.assert_allclose(p.numpy(), np.moveaxis(np.asarray(probs), -1, 1), atol=1e-5)


def test_folded_forward_matches_unfolded(legacy, rng):
    name, _, variables, _ = legacy
    net = _port_net(name, variables).eval()
    fwd = folded_forward(net, torch.bfloat16, "cpu")  # float32 whatever is asked
    assert isinstance(fwd, FoldedLegacyUnet2D) and fwd.dtype == torch.float32
    x = _nchw(rng.random((3, 64, 48, 1)).astype(np.float32))
    with torch.no_grad():
        want = net(x)[1]
    got = fwd.logits(x)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    np.testing.assert_allclose(fwd(x)[0].numpy(), torch.sigmoid(want).numpy(), atol=1e-5)


def test_pt_loads_with_reference_keys(legacy):
    name, _, _, path = legacy
    state = checkpoint.load(path)
    last = "decode9" if name == "Unet_v0" else "decode7"
    assert {f"{last}.0.weight", f"{last}.1.running_var", "final.0.weight"} <= set(
        state["state_dict"])
    net = get_model(name, **state["hyperparams"])
    net.load_state_dict(state["state_dict"], strict=True)
    assert isinstance(net, MODELS[name][1]) and net.n_filter == N_FILTER


@pytest.mark.parametrize("pipeline", [None, False], ids=["fused", "host"])
def test_predict_matches_jax_and_ignores_half_precision(legacy, pipeline):
    name, _, _, path = legacy
    movie = np.random.default_rng(6).integers(0, 255, (3, 96, 80), dtype=np.uint8)
    kw = dict(resize_dim=(64, 64), show_progress=False, batch_size=4, device_pipeline=pipeline)
    ours = Predict(movie, None, path, device="cpu", **kw)
    assert ours.engine.dtype == torch.float32
    assert isinstance(ours.engine.forward, FoldedLegacyUnet2D)
    ref = JPredict(movie, None, path, **kw).result
    assert_u8_contract(ours.result, ref)
    half = Predict(movie, None, path, device="cpu", half_precision=True, **kw)
    assert half.engine.dtype == torch.float32
    np.testing.assert_array_equal(half.result, ours.result)


def _pre_bn_bias(key: str) -> bool:
    return key.endswith(".0.bias") and not key.startswith("final")


def test_first_step_matches_jax_with_jax_dropout_mask(legacy, rng):
    name, model, variables, _ = legacy
    x = rng.random((4, 32, 32, 1)).astype(np.float32)
    y = (rng.random((4, 32, 32, 1)) > 0.5).astype(np.float32)
    key = jax.random.PRNGKey(9)

    def loss_fn(params):
        (_, z), state = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, jnp.asarray(x),
            train=True, mutable=["batch_stats", "intermediates"], rngs={"dropout": key},
            capture_intermediates=True)
        return JBCEDice(0.5, 0.5)(z[..., 0], jnp.asarray(y)[..., 0]), state

    (ref_loss, state), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    # the channels flax's Dropout kept in that step
    dropped = np.asarray(state["intermediates"]["middle_conv2"]["Dropout_0"]["__call__"][0])
    keep = np.any(dropped != 0, axis=(1, 2))  # (B, C): a dropped channel is all zero
    assert 0 < keep.mean() < 1

    net = _port_net(name, variables).train()
    drop = net.middle_conv2[3]
    assert isinstance(drop, ChannelDropout2d) and drop.p == 0.5
    mask = torch.from_numpy(keep)[:, :, None, None]
    drop.forward = lambda t: torch.where(mask, t / 0.5, torch.zeros(()))
    _, z = net(_nchw(x))
    loss = BCEDiceLoss(0.5, 0.5)(z[:, 0], _nchw(y)[:, 0])
    loss.backward()
    assert abs(loss.item() - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    ref = variables_to_torch_state_dict({"params": jgrads})
    grads = {k: p.grad.numpy() for k, p in net.named_parameters()}
    assert set(grads) == set(ref)
    top = max(float(np.abs(g).max()) for g in ref.values())
    for k, g in ref.items():
        g = np.asarray(g)
        if _pre_bn_bias(k):
            assert np.abs(g).max() < 1e-5 * top and np.abs(grads[k]).max() < 1e-5 * top, k
            continue
        np.testing.assert_allclose(grads[k], g, rtol=0, atol=1e-4 * np.abs(g).max(), err_msg=k)


class _Blobs:
    def __init__(self, n=10, size=32, seed=0):
        r = np.random.default_rng(seed)
        self.items = []
        for _ in range(n):
            img, mask = blob_sample(r, (size, size), n_blobs=3, margin=4, radius=(3, 6))
            self.items.append({"image": (img / 255.0).astype(np.float32)[None],
                               "mask": (mask / 255.0).astype(np.float32)[None]})

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def test_trainer_trains_float32_and_writes_a_pt_jax_reads(tmp_path):
    movie = np.random.default_rng(8).integers(0, 255, (2, 64, 48), dtype=np.uint8)
    rows = []
    for run in ("a", "b"):
        t = Trainer(_Blobs(), 2, network="BabyUnet", n_filter=N_FILTER, batch_size=4,
                    lr=1e-3, save_dir=str(tmp_path / run), seed=3, device="cpu",
                    half_precision=True, device_cache=True, device_augment=True,
                    save_name="model.pt")
        assert all(p.dtype == torch.float32 for p in t.model.parameters())
        t.start()
        rows.append([(h["train_loss"], h["val_loss"]) for h in t.history])
        gen = t.model.middle_conv2[3].generator
        assert isinstance(gen, torch.Generator)
    assert rows[0] == rows[1] and all(np.isfinite(rows[0]).ravel())
    path = str(tmp_path / "a" / "model.pt")
    raw = read_pt(path)  # the JAX package's torch-free reader
    assert raw["model_name"] == "BabyUnet" and raw["n_filter"] == N_FILTER
    state = jcheckpoint.load(path)
    assert "decode7" in state["variables"]["params"]
    kw = dict(resize_dim=(32, 32), show_progress=False)
    assert_u8_contract(Predict(movie, None, path, device="cpu", **kw).result,
                       JPredict(movie, None, path, **kw).result)
