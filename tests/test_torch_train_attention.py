"""``AttentionUnet`` training in the port held against the JAX Trainer on the
CPU, float32 and bf16 (``half_precision``), at ``n_filter=4`` on 64² blob
tiles (``test_torch_train.BlobTiles``).

- float32: the JAX Trainer's initial weights (its init jitted through
  ``torch_parity.jit_init``) are exported to a reference ``.pt`` and the
  port's Trainer starts from them; 2 epochs on the same tiles, seed, split and
  batch order give ``metrics.csv`` rows within rtol 1e-4;
- bf16: one train-mode step of the model on the JAX Trainer's weights after
  those 2 epochs (BatchNorm statistics warmed), against
  ``jax.value_and_grad`` of JAX's ``AttentionUnet(dtype=bfloat16)``: loss
  within rtol 1e-2, every BatchNorm running variance within rtol 1e-2 and
  every running mean within 1e-2 of its channel's running std (a mean near 0
  carries the bf16 rounding of its channel's values, so a relative bound on
  it would ask for less than a bf16 ulp of them: a gate's mean of 0.0012 lay
  1.2% from JAX's on warmed initial weights).
  The gradients: a bf16 step's gradient is rounding noise in most tensors at
  this size, in JAX too (train-mode BatchNorm removes the mean and the scale
  of each conv's output, so a conv's weight gradient is a small difference of
  large sums of bf16-rounded terms): on the Trainer's initial weights JAX's
  own bf16 gradient lies within 5e-2 of its tensor's largest |g| of JAX's
  float32 gradient on at least 99% of the elements in only 30 of the 100
  tensors (the conv biases in front of a BatchNorm left out), and the port's
  bf16 gradient within that of JAX's bf16 one in 30.  So each tensor of 16
  elements or more is held to that criterion where JAX's bf16 gradient meets
  it against JAX's float32 one (the gradient is signal there: 2 tensors on
  these weights; a smaller tensor can meet it by chance); over the other
  tensors, each scaled by its largest |g|, the port's L2 distance to JAX's
  bf16 gradient is at most 1.5 times the distance of JAX's float32 gradient to
  it, JAX's own bf16 noise (measured 1.08 times here, 0.97-1.00 on initial
  weights at three sizes; single tensors of 1-8 elements range up to 4 times,
  so no tensor is held alone to it); the port's gradients of the conv biases
  in front of a BatchNorm (0 in exact arithmetic) lie below 1e-2 of the
  largest gradient;
- the bf16 eval forward within twice JAX's own bf16-vs-float32 difference of
  JAX's bf16 logits, the gates computing in float32 as flax promotes them;
- the port's ``.pt`` is read by JAX's restricted reader and rebuilds an
  ``AttentionUnet`` there.
"""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bio_image_unet_tpu.interop.pt_reader import read_pt
from bio_image_unet_tpu.interop.torch_export import (export_torch_checkpoint,
                                                     variables_to_torch_state_dict)
from bio_image_unet_tpu.losses import BCEDiceLoss as JBCEDice
from bio_image_unet_tpu.models import AttentionUnet as JAttentionUnet
from bio_image_unet_tpu.models import get_model as jget_model
from bio_image_unet_tpu.parallel import get_mesh
from bio_image_unet_tpu.train import Trainer as JaxTrainer
from bio_image_unet_tpu_torch.interop import state_dict_from_jax
from bio_image_unet_tpu_torch.losses import BCEDiceLoss
from bio_image_unet_tpu_torch.models import AttentionUnet
from bio_image_unet_tpu_torch.train import Trainer
from test_torch_train import BlobTiles
from torch_parity import jit_init

N_FILTER, BATCH, EPOCHS, LR = 4, 4, 2, 1e-4


def _rows(save_dir):
    with open(os.path.join(save_dir, "metrics.csv")) as fh:
        rows = list(csv.reader(fh))
    return np.array([[float(v) for v in r[:4]] for r in rows[1:]])


@pytest.fixture(scope="module")
def float_runs(tmp_path_factory):
    """The JAX Trainer's ``metrics.csv`` rows and the port's, from the same
    initial weights; the port's save directory; the JAX Trainer's variables
    after its 2 epochs (trained weights, warmed BatchNorm statistics)."""
    root = tmp_path_factory.mktemp("attention_train")
    init = str(root / "init.pt")
    with jit_init():
        t = JaxTrainer(BlobTiles("hwc"), EPOCHS, network="AttentionUnet", batch_size=BATCH,
                       lr=LR, n_filter=N_FILTER, save_dir=str(root / "jax"), seed=0,
                       mesh=get_mesh(n_data=1))
    export_torch_checkpoint(init, {"params": t.params, "batch_stats": t.batch_stats},
                            {"model_name": "AttentionUnet", "n_filter": N_FILTER}, epoch=0)
    t.start()
    ours = Trainer(BlobTiles("chw"), EPOCHS, network="AttentionUnet", batch_size=BATCH, lr=LR,
                   n_filter=N_FILTER, save_dir=str(root / "port"), seed=0, device="cpu",
                   load_weights=init)
    assert ours.model.attention and ours.epoch_start == 0
    ours.start()
    trained = jax.tree_util.tree_map(np.asarray, {"params": t.params,
                                                  "batch_stats": t.batch_stats})
    return _rows(root / "jax"), _rows(root / "port"), root / "port", trained


def test_float32_metrics_match_jax(float_runs):
    ref, rows, _, _ = float_runs
    assert rows.shape == ref.shape == (EPOCHS, 4)
    np.testing.assert_array_equal(rows[:, 0], ref[:, 0])
    np.testing.assert_allclose(rows[:, 1:], ref[:, 1:], rtol=1e-4)


def test_pt_read_by_jax(float_runs):
    _, _, save_dir, _ = float_runs
    raw = read_pt(str(save_dir / "model.pt"))  # the torch-free reader
    assert raw["model_name"] == "AttentionUnet" and raw["n_filter"] == N_FILTER
    model = jget_model(raw["model_name"], **{k: v for k, v in raw.items()
                                             if k not in ("state_dict", "optimizer_state_dict")})
    assert isinstance(model, JAttentionUnet) and model.attention
    assert any(k.startswith("attention4.psi.1.") for k in raw["state_dict"])


@pytest.fixture(scope="module")
def warmed(float_runs):
    return float_runs[3]


def _nchw(x):
    return torch.from_numpy(np.moveaxis(np.asarray(x), -1, 1).copy())


def _batch():
    data = BlobTiles("hwc")
    return (np.stack([data[i]["image"] for i in range(BATCH)]),
            np.stack([data[i]["mask"] for i in range(BATCH)]))


def test_bf16_first_step_matches_jax(warmed):
    x, y = _batch()

    def step(dtype):
        model = JAttentionUnet(n_filter=N_FILTER, dtype=dtype)

        def loss_fn(params):
            (_, z), mutated = model.apply(
                {"params": params, "batch_stats": warmed["batch_stats"]}, jnp.asarray(x),
                train=True, mutable=["batch_stats"])
            return JBCEDice(0.5, 0.5)(z[..., 0], jnp.asarray(y)[..., 0]), mutated

        return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(warmed["params"])

    (ref_loss, mutated), jgrads = step(jnp.bfloat16)
    jgrads32 = step(None)[1]
    net = AttentionUnet(n_filter=N_FILTER, dtype=torch.bfloat16)
    net.load_state_dict(state_dict_from_jax(warmed), strict=True)
    _, z = net.train()(_nchw(x))
    assert z.dtype == torch.float32
    loss = BCEDiceLoss(0.5, 0.5)(z[:, 0], _nchw(y)[:, 0])
    loss.backward()
    assert abs(loss.item() - float(ref_loss)) <= 1e-2 * abs(float(ref_loss))

    ref = variables_to_torch_state_dict({"params": jgrads})
    ref32 = variables_to_torch_state_dict({"params": jgrads32})
    grads = {k: p.grad.numpy() for k, p in net.named_parameters()}
    assert set(grads) == set(ref)
    top = max(float(np.abs(g).max()) for g in ref.values())
    signal, noise_ours, noise_jax = 0, 0.0, 0.0
    for k, g in ref.items():
        g, g32, ours = np.asarray(g, np.float32), np.asarray(ref32[k], np.float32), grads[k]
        if k.endswith(".0.bias") and not k.startswith("final"):
            # in front of a BatchNorm (a block's conv, a gate's 1×1 convs): 0 in
            # exact arithmetic; JAX's is the sum of its bf16-rounded output
            # gradient (up to 8e-2 of the largest gradient here), the port's
            # the float32 sum of its conv's
            assert np.abs(ours).max() <= 1e-2 * top, k
            continue
        scale = 5e-2 * np.abs(g).max()
        if g.size >= 16 and (np.abs(g32 - g) <= scale).mean() >= 0.99:
            signal += 1
            assert (np.abs(ours - g) <= scale).mean() >= 0.99, k
        else:
            noise_ours += float(np.sum(((ours - g) / np.abs(g).max()) ** 2))
            noise_jax += float(np.sum(((g32 - g) / np.abs(g).max()) ** 2))
    assert signal >= 2
    assert np.sqrt(noise_ours) <= 1.5 * np.sqrt(noise_jax), (noise_ours, noise_jax)

    stats = variables_to_torch_state_dict({"batch_stats": mutated["batch_stats"]})
    ours = net.state_dict()
    n_stats = 0
    for k, v in stats.items():
        if k.endswith("running_var"):
            np.testing.assert_allclose(ours[k].numpy(), np.asarray(v), rtol=1e-2, err_msg=k)
            # a mean near 0 carries the bf16 rounding of its channel's values:
            # each running mean within 1e-2 of its channel's running std
            mean = k.replace("running_var", "running_mean")
            err = np.abs(ours[mean].numpy() - np.asarray(stats[mean]))
            assert (err <= 1e-2 * np.sqrt(np.asarray(v))).all(), mean
            assert ours[k].dtype == ours[mean].dtype == torch.float32
            n_stats += 1
    assert n_stats == 18 + 12  # 18 ConvBlocks, 4 gates of 3 BatchNorms


def test_bf16_eval_forward_matches_jax(warmed, rng):
    x = rng.random((2, 64, 64, 1)).astype(np.float32)
    ref16 = jax.jit(lambda v, x: JAttentionUnet(n_filter=N_FILTER, dtype=jnp.bfloat16).apply(
        v, x)[1])(warmed, jnp.asarray(x))
    ref32 = jax.jit(lambda v, x: JAttentionUnet(n_filter=N_FILTER).apply(v, x)[1])(
        warmed, jnp.asarray(x))
    net = AttentionUnet(n_filter=N_FILTER, dtype=torch.bfloat16)
    net.load_state_dict(state_dict_from_jax(warmed), strict=True)
    with torch.no_grad():
        z = net.eval()(_nchw(x))[1].numpy()
    b16, b32 = (np.moveaxis(np.asarray(r), -1, 1) for r in (ref16, ref32))
    gap = np.abs(b16 - b32).max()
    assert 0 < gap and np.abs(z - b16).max() <= 2 * gap
