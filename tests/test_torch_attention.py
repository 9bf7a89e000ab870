"""The port's ``AttentionUnet``, float and int8, held against the JAX package
on the CPU.

- the model (``models.unet2d.AttentionUnet`` with ``ops.blocks.AttentionBlock``)
  on JAX's warmed weights, carried over by ``interop.state_dict_from_jax``,
  gives JAX's eval outputs within 2e-4 (``tests/test_torch_model.py``'s
  tolerance);
- float ``Predict`` on the same reference-schema ``.pt`` (loaded with
  ``strict=True``) gives JAX's ``Predict`` masks within one uint8 level on at
  most 0.1% of pixels;
- the int8 calibrator's per-site maxes are within 2e-2 relative of JAX's
  ``build_calibrator(attention=True)``;
- the int8 forward (``predict.quant.Int8Unet2D`` with the gated decoder) on
  JAX's folded weights and calibrated maxes gives ``build_int8_apply(
  attention=True)``'s logits bit for bit (the probabilities within 6e-8:
  torch's and XLA's sigmoids differ in the last bit);
- ``Predict(quantized=True)`` runs int8 by default (``attention2d`` is in the
  ship set), calibrating as JAX does, within JAX's int8 contract of JAX's
  int8 masks.

Checkpoints are built in the port from JAX variables
(``torch_parity.write_seeded_checkpoint``, BN-warmed for int8) at
``n_filter=4``; inputs are drawn with numpy from a seed.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bio_image_unet_tpu.interop.torch_export import export_torch_checkpoint
from bio_image_unet_tpu.models import AttentionUnet as JAttentionUnet
from bio_image_unet_tpu.predict import Predict as JPredict
from bio_image_unet_tpu.predict import predictor as jpredictor
from bio_image_unet_tpu.predict import quant as jquant
from bio_image_unet_tpu_torch import checkpoint
from bio_image_unet_tpu_torch.interop import state_dict_from_jax
from bio_image_unet_tpu_torch.models import AttentionUnet, get_model
from bio_image_unet_tpu_torch.predict import Predict, predictor, quant
from torch_parity import (assert_u8_contract, port_folded, warm_unet_variables,
                          write_seeded_checkpoint)

N_FILTER = 4


@pytest.fixture(scope="module")
def jax_att():
    """A JAX ``AttentionUnet(4)`` with warmed BatchNorm statistics."""
    return warm_unet_variables(N_FILTER, size=32, steps=3, seed=5, cls=JAttentionUnet)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory, jax_att):
    """``float``: JAX's warmed variables as a reference-schema ``.pt``;
    ``warm``: a BN-warmed model drawn in the port, with its JAX variables."""
    root = tmp_path_factory.mktemp("attention_pt")
    hyper = {"model_name": "AttentionUnet", "n_filter": N_FILTER, "in_channels": 1,
             "out_channels": 1}
    export_torch_checkpoint(str(root / "float.pt"), jax_att[1], hyper, epoch=1, best_loss=0.5)
    warm, variables = write_seeded_checkpoint(root, "warm", "AttentionUnet", 70,
                                              n_filter=N_FILTER, warm=True)
    return {"float": str(root / "float.pt"), "warm": warm, "warm_variables": variables}


def _port_model(path):
    state = checkpoint.load(path)
    net = get_model(state["hyperparams"]["model_name"], **state["hyperparams"])
    net.load_state_dict(state["state_dict"], strict=True)
    return net.eval()


def test_attention_model_matches_jax(jax_att):
    model, variables = jax_att
    net = AttentionUnet(n_filter=N_FILTER)
    net.load_state_dict(state_dict_from_jax(variables), strict=True)
    assert [f"attention{i}.{g}.{j}" for i in range(1, 5) for g in ("W_gate", "W_x", "psi")
            for j in (0, 1)] == [k[:-len(".weight")] for k in net.state_dict()
                                 if k.startswith("attention") and k.endswith(".weight")]
    x = np.random.default_rng(1).random((2, 32, 32, 1)).astype(np.float32)
    ref_p, ref_z = (np.asarray(v) for v in jax.jit(
        lambda v, a: model.apply(v, a, train=False))(variables, jnp.asarray(x)))
    with torch.no_grad():
        p, z = net.eval()(torch.from_numpy(np.moveaxis(x, -1, 1)))
    np.testing.assert_allclose(np.moveaxis(z.numpy(), 1, -1), ref_z, atol=2e-4)
    np.testing.assert_allclose(np.moveaxis(p.numpy(), 1, -1), ref_p, atol=2e-4)


def _movie(seed, n=3, shape=(80, 72)):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[: shape[0], : shape[1]]
    frames = [25 + 150 * np.exp(-((yy - 30 - 4 * i) ** 2 + (xx - 36) ** 2) / 150.0)
              + 50 * rng.random(shape) for i in range(n)]
    return np.clip(np.stack(frames), 0, 255).astype(np.uint8)


def test_attention_predict_matches_jax(ckpts):
    movie = _movie(2)
    kw = dict(resize_dim=(32, 32), show_progress=False, batch_size=4)
    ours = Predict(movie, None, ckpts["float"], device="cpu", **kw)
    assert ours.engine.forward.attention
    ref = JPredict(movie, None, ckpts["float"], **kw).result
    assert_u8_contract(ours.result, ref)


def _tiles(seed, n=4):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:32, :32]
    blob = np.exp(-((yy - 12 - seed % 5) ** 2 + (xx - 18) ** 2) / 60.0)
    return np.clip(rng.random((n, 32, 32)) * 0.4 + blob * 0.6, 0, 1).astype(np.float32)


@pytest.fixture(scope="module")
def jax_int8(ckpts):
    variables = ckpts["warm_variables"]
    x = _tiles(3)
    cal = jquant.build_calibrator(variables, attention=True)
    apply_fn, make = jquant.build_int8_apply(variables, attention=True)
    return dict(net=_port_model(ckpts["warm"]), x=x, apply=jax.jit(apply_fn), make=make,
                maxes=np.asarray(cal(jnp.asarray(x[..., None]))),
                folded=port_folded(variables))


def test_attention_calibrator_matches_jax(jax_int8):
    r = jax_int8
    assert quant._int8_family(r["net"]) == "attention2d"
    cal_fn, _ = quant.int8_builders(r["net"], "cpu")
    ours = cal_fn(torch.from_numpy(r["x"][:, None]))
    assert ours.dtype == np.float32 and ours.shape == r["maxes"].shape
    np.testing.assert_allclose(ours, r["maxes"], rtol=2e-2)


def test_attention_int8_forward_matches_jax(jax_int8):
    r = jax_int8
    maxes = r["maxes"] * np.float32(1.1)
    ref_p, ref_z = (np.asarray(v)[..., 0] for v in r["apply"](
        r["make"](maxes), jnp.asarray(r["x"][..., None])))
    fwd = quant.build_int8_apply(r["net"], "cpu", r["folded"])(maxes)
    assert fwd.attention and sorted(n for n in fwd.w.float if n.startswith("attention")) == [
        f"attention{i}.{g}" for i in range(1, 5) for g in sorted(("W_gate", "W_x", "psi"))]
    with torch.inference_mode():
        p, z = fwd(torch.from_numpy(r["x"][:, None]))
    assert z.dtype == torch.float32
    np.testing.assert_array_equal(z[:, 0].numpy(), ref_z)
    np.testing.assert_allclose(p[:, 0].numpy(), ref_p, rtol=0, atol=6e-8)


@pytest.fixture
def maxes(monkeypatch):
    """The raw per-site maxes each package calibrates, call by call."""
    seen = {"port": [], "jax": []}
    for key, engine in (("port", predictor._Engine), ("jax", jpredictor._Engine)):
        finish = engine._finish_int8_calibration

        def spy(self, raw, _finish=finish, _key=key):
            seen[_key].append(np.asarray(raw, np.float32))
            return _finish(self, raw)

        monkeypatch.setattr(engine, "_finish_int8_calibration", spy)
    return seen


def test_attention_predict_quantized_runs_int8_by_default(ckpts, maxes, monkeypatch):
    monkeypatch.delenv("BIU_INT8_EXPERIMENTAL", raising=False)
    movie = _movie(4)
    kw = dict(resize_dim=(32, 32), show_progress=False, batch_size=4, quantized=True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no gate warning: int8 runs by default
        ours = Predict(movie, None, ckpts["warm"], device="cpu", **kw)
    assert ours.engine._quant_ready and isinstance(ours.engine.forward, quant.Int8Unet2D)
    ref = JPredict(movie, None, ckpts["warm"], **kw).result
    assert len(maxes["port"]) == len(maxes["jax"]) == 1
    np.testing.assert_allclose(maxes["port"][0], maxes["jax"][0], rtol=2e-2)
    d = np.abs(ours.result.astype(int) - ref.astype(int))
    # JAX's int8 contract (tests/test_quant.py): each side calibrates and
    # folds BatchNorm itself, so a few activations may round one code apart
    assert d.max() <= 4 and d.mean() < 0.5 and (d > 1).mean() < 0.01, (d.max(), d.mean())
    flt = Predict(movie, None, ckpts["warm"], device="cpu",
                  **{**kw, "quantized": False}).result
    assert not np.array_equal(ours.result, flt)
