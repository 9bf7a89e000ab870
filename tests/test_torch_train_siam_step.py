"""The port's Siam training held against the JAX package on the CPU (the
second file of ``test_torch_train_siam.py``'s, one JAX Trainer run each):

- the ``corr`` join's Trainer, tiles resident, against JAX's: the
  ``metrics.csv`` rows within rtol 1e-4 (K6 and K6b through their plain
  versions);
- one train-mode step of ``concat`` and ``control`` on the same weights and
  batch: the loss within rtol 1e-5, every gradient within 1e-4 of its
  tensor's largest entry (the conv biases in front of a BatchNorm are
  rounding noise on both sides) and the BatchNorm running statistics after
  the step within rtol 1e-5 (the twin encoder updates them cur first, then
  prev, in flax's order);
- a resume equal to a straight run (``corr``, K4's pair form);
- the port's ``.pt`` read by JAX's restricted reader, and both
  ``PredictSiam``s on it within one level on ≤ 0.1% of pixels;
- the ``siam_unet`` facade's defaults equal to JAX's.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bio_image_unet_tpu import siam_unet as jsiam
from bio_image_unet_tpu.data import tiff as jtiff
from bio_image_unet_tpu.interop.pt_reader import read_pt
from bio_image_unet_tpu.interop.torch_export import variables_to_torch_state_dict
from bio_image_unet_tpu.losses import BCEDiceLoss as JBCEDice
from bio_image_unet_tpu.models import Siam_UNet as JSiam
from bio_image_unet_tpu.predict import PredictSiam as JPredictSiam
from bio_image_unet_tpu_torch import checkpoint, siam_unet
from bio_image_unet_tpu_torch.data import tiff
from bio_image_unet_tpu_torch.interop import state_dict_from_jax
from bio_image_unet_tpu_torch.losses import BCEDiceLoss
from bio_image_unet_tpu_torch.models import Siam_UNet
from bio_image_unet_tpu_torch.ops.functional import (depthwise_xcorr,
                                                     depthwise_xcorr_grad_input,
                                                     depthwise_xcorr_grad_kernel)
from test_torch_train_siam import (BATCH, LR, N_FILTER, PairTiles, _rows,
                                   check_trainer_matches_jax)
from torch_parity import assert_u8_contract, write_seeded_checkpoint


def test_siam_trainer_corr_matches_jax(tmp_path):
    """The ``corr`` join with the tiles resident (``device_cache``)."""
    check_trainer_matches_jax(tmp_path, "corr", cache=True)


def _pre_bn_bias(key: str) -> bool:
    return key.endswith(".0.bias") and not key.startswith("final")


@pytest.mark.parametrize("mode", ["concat", "control"])
def test_first_step_matches_jax(tmp_path, mode):
    path, variables = write_seeded_checkpoint(tmp_path, mode, "Siam_UNet", 60, n_filter=N_FILTER,
                                              mode=mode)
    data = PairTiles("hwc")
    x, y, p = (np.stack([data[i][k] for i in range(BATCH)])
               for k in ("image", "mask", "prev_image"))
    model = JSiam(n_filter=N_FILTER, mode=mode)

    def loss_fn(params):
        (_, z), mutated = model.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                      jnp.asarray(x), jnp.asarray(p), train=True,
                                      mutable=["batch_stats"])
        return JBCEDice(1, 1)(z[..., 0], jnp.asarray(y)[..., 0]), (mutated, z)

    (jloss, (mutated, _)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    ref = variables_to_torch_state_dict({"params": jgrads})
    ref_stats = state_dict_from_jax({"params": variables["params"], **mutated})
    net = Siam_UNet(n_filter=N_FILTER, mode=mode)
    net.load_state_dict(checkpoint.load(path)["state_dict"])
    chw = (torch.from_numpy(np.moveaxis(a, -1, 1).copy()) for a in (x, y, p))
    xt, yt, pt = chw
    _, z = net.train()(xt, pt)
    loss = BCEDiceLoss(1, 1)(z[:, 0], yt[:, 0])
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    grads = {k: q.grad.numpy() for k, q in net.named_parameters()}
    assert set(grads) == set(ref)
    top = max(float(np.abs(g).max()) for g in ref.values())
    for k, g in ref.items():
        g = np.asarray(g)
        if _pre_bn_bias(k):
            assert np.abs(g).max() < 1e-5 * top and np.abs(grads[k]).max() < 1e-5 * top, k
            continue
        np.testing.assert_allclose(grads[k], g, rtol=0, atol=1e-4 * np.abs(g).max(), err_msg=k)
    ours = net.state_dict()
    stats = [k for k in ref_stats if k.endswith(("running_mean", "running_var"))]
    assert stats and all(k in ours for k in stats)
    for k in stats:
        np.testing.assert_allclose(ours[k].numpy(), ref_stats[k].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def _trainer(out, epochs, **kw):
    return siam_unet.Trainer(PairTiles("chw"), epochs, batch_size=BATCH, lr=LR,
                             n_filter=N_FILTER, save_dir=str(out), seed=0, device="cpu",
                             **{"mode": "corr", **kw})


def test_resume_equals_straight_run(tmp_path):
    """1 epoch, a resume from its checkpoint (the facade takes a path) and 1
    more epoch equal 2 epochs straight; the tiles resident and augmented by
    K4's pair form."""
    kw = {"device_cache": True, "device_augment": True}
    straight = _trainer(tmp_path / "straight", 2, **kw)
    straight.start()
    first = _trainer(tmp_path / "resumed", 1, **kw)
    first.start()
    path = str(tmp_path / "resumed" / "model.ckpt")
    assert checkpoint.load(path)["epoch"] == 1
    second = _trainer(tmp_path / "resumed", 1, load_weights=path, **kw)
    assert second.epoch_start == 1 and second.best_loss == first.best_loss
    second.start()
    np.testing.assert_allclose(_rows(tmp_path / "resumed")[:, :4],
                               _rows(tmp_path / "straight")[:, :4], rtol=1e-6)
    for (k, a), b in zip(second.model.state_dict().items(),
                         straight.model.state_dict().values()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7, err_msg=k)


def test_checkpoint_read_by_jax_and_both_predicts_agree(tmp_path):
    """A ``corr`` model trained by the port (K6 and K6b on the CPU: no
    launch counted) is read by the JAX package's torch-free reader; both
    ``PredictSiam``s agree on it."""
    before = (depthwise_xcorr.launches, depthwise_xcorr_grad_input.launches,
              depthwise_xcorr_grad_kernel.launches)
    t = _trainer(tmp_path / "run", 1, save_name="model.pt")
    t.start()
    assert (depthwise_xcorr.launches, depthwise_xcorr_grad_input.launches,
            depthwise_xcorr_grad_kernel.launches) == before
    path = str(tmp_path / "run" / "model.pt")
    raw = read_pt(path)
    assert raw["model_name"] == "Siam_UNet" and raw["mode"] == "corr"
    assert raw["n_filter"] == N_FILTER and raw["epoch"] == 1
    movie = np.random.default_rng(4).integers(0, 255, (4, 48, 40), dtype=np.uint8)
    src = str(tmp_path / "movie.tif")
    tiff.imwrite(src, movie)
    kw = dict(resize_dim=(32, 32), show_progress=False, frames_per_chunk=2)
    ours, ref = str(tmp_path / "port.tif"), str(tmp_path / "jax.tif")
    siam_unet.Predict(src, ours, path, device="cpu", **kw)
    JPredictSiam(src, ref, path, **kw)
    assert_u8_contract(tiff.imread(ours), jtiff.imread(ref))


def test_facade_defaults_match_jax(tmp_path):
    for ours, ref in ((siam_unet.Trainer, jsiam.Trainer), (siam_unet.DataProcess,
                                                          jsiam.DataProcess)):
        want = inspect.signature(ref.__init__).parameters
        got = inspect.signature(ours.__init__).parameters
        for name, param in want.items():
            if name in ("self", "kwargs"):
                continue
            assert name in got and got[name].default == param.default, (ours, name)
    t = siam_unet.Trainer(PairTiles("chw", n=4), 1, save_dir=str(tmp_path), device="cpu")
    assert t.model.mode == "max" and t.model.n_filter == 32 and t.batch_size == 4
    assert (t.scheduler.patience, t.scheduler.factor) == (4, 0.1)
    assert t.save_name == "model.ckpt" and t.loss_params == (1, 1) and t.lr == 1e-3
    assert t.params_meta["mode"] == "max" and t.params_meta["model_name"] == "Siam_UNet"
    # pairs are required: items without a prev frame are refused by name
    with pytest.raises(ValueError, match="prev_image"):
        siam_unet.Trainer([{"image": np.zeros((1, 32, 32), np.float32),
                            "mask": np.zeros((1, 32, 32), np.float32)}], 1,
                          save_dir=str(tmp_path), device="cpu")
