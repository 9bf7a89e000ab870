"""The port's loss zoo (``bio_image_unet_tpu_torch/losses.py``) held against
``bio_image_unet_tpu/losses.py`` on the same seeded inputs: every
``LOSS_REGISTRY``, ``HEAD_LOSS_REGISTRY`` and 3D head entry, by value and by
the gradient with respect to its first argument (torch autograd against
``jax.grad``).  float32 on both sides; sums run in another order, so values
and gradients agree to rtol 1e-5 (atol 1e-6 of the gradient's largest
entry, for the entries that are near zero)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bio_image_unet_tpu import losses as jl
from bio_image_unet_tpu_torch import losses as tl


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def _inputs(kind: str, rng):
    """(port NCHW/NCZXY inputs, JAX channels-last inputs) for one loss."""
    shape = (3, 2, 12, 12)
    if kind == "temporal":
        shape = (2, 1, 5, 8, 8)
    z = (rng.standard_normal(shape) * 2).astype(np.float32)
    binary = (rng.random(shape) > 0.6).astype(np.float32)
    if kind in ("logits", "temporal"):
        pred, target = z, binary
    elif kind == "probs":
        pred, target = _sigmoid(z).astype(np.float32), binary
    elif kind == "regression":
        pred = z
        target = np.where(binary > 0, rng.random(shape) * 3, 0).astype(np.float32)
    elif kind == "vectors":
        theta = rng.uniform(0, 2 * np.pi, (shape[0],) + shape[2:])
        t = np.stack([np.cos(theta), np.sin(theta)], 1).astype(np.float32)
        t[:, :, :4] = 0.0  # zero vectors are masked differently
        pred, target = z, t
    else:
        raise ValueError(kind)
    return (pred, target), tuple(np.ascontiguousarray(np.moveaxis(a, 1, -1))
                                 for a in (pred, target))


KIND = {
    "BCE": "logits", "BCEDice": "logits", "BCEDiceProb": "probs", "Dice": "logits",
    "logcoshDice": "logits", "Tversky": "logits", "logcoshTversky": "logits",
    "weightedBCE": "logits", "MSE": "regression", "MAE": "regression", "Huber": "regression",
    "DistanceGradient": "regression", "WeightedDistanceGradient": "regression",
    "WeightedVectorField": "vectors", "BCEDiceTemporal": "temporal",
    "BCEDiceLoss": "probs", "DiceLoss": "probs", "TverskyLoss": "probs",
    "logcoshTverskyLoss": "probs", "MSELoss": "regression", "MAELoss": "regression",
    "HuberLoss": "regression", "DistanceGradientLoss": "regression",
    "WeightedDistanceGradientLoss": "regression", "WeightedVectorFieldLoss": "vectors",
    "BCEDiceTemporalLoss": "temporal",
}

CASES = ([("loss", n) for n in jl.LOSS_REGISTRY] + [("head", n) for n in jl.HEAD_LOSS_REGISTRY]
         + [("head3d", n) for n in ("BCEDiceLoss", "DiceLoss")])


def test_registries_have_the_same_names():
    assert list(tl.LOSS_REGISTRY) == list(jl.LOSS_REGISTRY)
    assert list(tl.HEAD_LOSS_REGISTRY) == list(jl.HEAD_LOSS_REGISTRY)
    assert list(tl.HEAD_LOSS_REGISTRY_3D) == list(jl.HEAD_LOSS_REGISTRY_3D)


@pytest.mark.parametrize("registry,name", CASES, ids=[f"{r}-{n}" for r, n in CASES])
def test_loss_value_and_gradient_match_jax(rng, registry, name):
    (pred, target), (jpred, jtarget) = _inputs(KIND[name], rng)
    if registry == "loss":
        ours_fn, ref_fn = tl.get_loss(name), jl.get_loss(name)
    else:
        fam = "3d" if registry == "head3d" else "2d"
        ours_fn, ref_fn = tl.get_head_loss(name, fam), jl.get_head_loss(name, fam)

    ref_val, ref_grad = jax.value_and_grad(lambda p: ref_fn(p, jnp.asarray(jtarget)))(
        jnp.asarray(jpred))
    x = torch.from_numpy(pred).requires_grad_(True)
    val = ours_fn(x, torch.from_numpy(target))
    val.backward()
    np.testing.assert_allclose(val.item(), float(ref_val), rtol=1e-5)
    grad = np.moveaxis(x.grad.numpy(), 1, -1)
    ref_grad = np.asarray(ref_grad)
    assert np.isfinite(grad).all()
    np.testing.assert_allclose(grad, ref_grad, rtol=1e-5,
                               atol=1e-6 * float(np.abs(ref_grad).max()))


def test_temporal_consistency_loss_matches_jax(rng):
    pred = rng.standard_normal((2, 1, 5, 6, 6)).astype(np.float32)
    ours = tl.TemporalConsistencyLoss()(torch.from_numpy(pred)).item()
    ref = float(jl.TemporalConsistencyLoss()(jnp.asarray(np.moveaxis(pred, 1, -1))))
    np.testing.assert_allclose(ours, ref, rtol=1e-6)


def test_unknown_loss_names_raise():
    with pytest.raises(ValueError, match="unknown loss"):
        tl.get_loss("NoSuchLoss")
    with pytest.raises(ValueError, match="not defined"):
        tl.get_head_loss("NoSuchLoss")
    fn = tl.BCEDiceLoss(0.3, 0.7)
    assert tl.get_loss(fn) is fn and "alpha" in repr(fn)


@pytest.mark.parametrize("name", ["bce_probs", "weighted_bce"])
def test_gradient_on_a_clip_bound_matches_jax(name):
    """Probabilities exactly on a clip bound (1 − 1e-7 or 1e-7 in float32)
    get JAX's gradient: ``jnp.clip``'s max/min split a tie in half, where
    ``torch.clamp`` would pass it whole.  A saturated sigmoid head lands on
    1 − 1e-7 in a first training step (found by the 3D multi-output
    gradient test)."""
    hi = np.float32(1.0) - np.float32(1e-7)
    if name == "bce_probs":
        x = np.array([[1e-7, hi, 0.5, 1.0, 0.0, 0.3]], np.float32)
        ours_fn = lambda a, t: tl.bce_loss(a, t, from_logits=False)  # noqa: E731
        ref_fn = lambda a, t: jl.bce_loss(a, t, from_logits=False)  # noqa: E731
    else:
        x = np.array([[20.0, -20.0, 0.5, 16.5, -16.5, 1.0]], np.float32)  # sigmoid saturates
        ours_fn, ref_fn = tl.weighted_bce_loss, jl.weighted_bce_loss
    t = np.array([[0.0, 1.0, 1.0, 0.0, 1.0, 0.0]], np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    loss = ours_fn(xt, torch.from_numpy(t))
    loss.backward()
    ref_loss, ref_grad = jax.value_and_grad(lambda a: ref_fn(a, jnp.asarray(t)))(jnp.asarray(x))
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_grad), rtol=1e-6, atol=1e-9)
