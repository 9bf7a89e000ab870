"""The Trainer's ``remat`` and ``profile_dir`` on the CPU.

``remat=True`` runs the training forward under ``torch.utils.checkpoint``
(non-reentrant, the counterpart of ``jax.checkpoint`` of the JAX Trainer's
forward): one step gives the loss, gradients and BatchNorm statistics of a
plain step within 1e-6 in float32, for ``Unet``, for ``Unet_v0`` with its
channel dropout (the recompute replays the forward's mask from the
Trainer's generator) and for a ``Siam_UNet`` ``corr`` step (K6's autograd
Function, on its plain version here, under the recompute); the statistics
move once a step, not twice.  The first epoch's ``metrics.csv`` row of a
port Trainer with ``remat=True`` matches the JAX Trainer's with
``remat=True`` from the same initial weights.  ``profile_dir`` writes one
Chrome trace JSON a ``start()``, also when the run raises, and the Trainer
refuses to start inside another profiler."""

import csv
import json
import os

import numpy as np
import pytest
import torch

from bio_image_unet_tpu.interop.torch_export import export_torch_checkpoint
from bio_image_unet_tpu.parallel import get_mesh
from bio_image_unet_tpu.train import Trainer as JaxTrainer
from bio_image_unet_tpu_torch import multi_output_unet, multi_output_unet3d, siam_unet, unet, unet3d
from bio_image_unet_tpu_torch.models.legacy import ChannelDropout2d
from bio_image_unet_tpu_torch.train import Trainer
from bio_image_unet_tpu_torch.utils.synth import blob_sample
from torch_parity import jit_init

N_FILTER, SIZE, BATCH, LR = 4, 64, 4, 1e-4


class Tiles:
    """blob tiles in [0, 1], CHW (``layout='chw'``) or HWC (JAX); with
    ``pairs`` a shifted prev frame too (``Siam_UNet``)."""

    def __init__(self, layout: str = "chw", n: int = 12, pairs: bool = False, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.items = []
        for _ in range(n):
            img, mask = blob_sample(rng, (SIZE, SIZE))
            img, mask = (img / 255.0).astype(np.float32), (mask / 255.0).astype(np.float32)
            item = {"image": img, "mask": mask}
            if pairs:
                item["prev_image"] = np.roll(img, 3, axis=1)
            self.items.append({k: v[..., None] if layout == "hwc" else v[None]
                               for k, v in item.items()})

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


CASES = [("Unet", {}, False), ("Unet_v0", {}, False), ("Siam_UNet", {"mode": "corr"}, True)]


def _one_step(tmp_path, network, extra, pairs, remat):
    t = Trainer(Tiles(pairs=pairs), 1, network=network, n_filter=N_FILTER, batch_size=BATCH,
                lr=LR, save_dir=str(tmp_path / f"remat{int(remat)}"), seed=0, device="cpu",
                remat=remat, **extra)
    t.model.train()
    t._seed_dropout(0)
    inputs, batch = next(t._batches(0))
    loss = t._train_step(inputs, batch)
    grads = {n: p.grad.clone() for n, p in t.model.named_parameters()}
    gens = {id(m.generator): m.generator for m in t.model.modules()
            if isinstance(m, ChannelDropout2d) and m.generator is not None}
    drops = [g.get_state() for g in gens.values()]
    return t, loss, grads, t.model.state_dict(), drops


@pytest.mark.parametrize("network,extra,pairs", CASES, ids=[c[0] for c in CASES])
def test_remat_step_equals_plain_step(tmp_path, network, extra, pairs):
    _, loss0, g0, sd0, d0 = _one_step(tmp_path, network, extra, pairs, False)
    t1, loss1, g1, sd1, d1 = _one_step(tmp_path, network, extra, pairs, True)
    assert t1.remat
    np.testing.assert_allclose(loss1.item(), loss0.item(), rtol=1e-6, atol=1e-6)
    for n in g0:
        np.testing.assert_allclose(g1[n].numpy(), g0[n].numpy(), rtol=1e-6, atol=1e-6,
                                   err_msg=n)
    for k in sd0:
        np.testing.assert_allclose(sd1[k].numpy(), sd0[k].numpy(), rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    # the statistics moved once a BatchNorm application, as flax's functional
    # update (the Siam twin encoder applies its BatchNorms twice a step)
    tracked = {k: v.item() for k, v in sd1.items() if k.endswith("num_batches_tracked")}
    assert tracked and set(tracked.values()) == ({1, 2} if pairs else {1})
    assert tracked == {k: sd0[k].item() for k in tracked}
    # the dropout stream stands where a plain step leaves it
    assert len(d0) == len(d1) == (1 if network == "Unet_v0" else 0)
    for a, b in zip(d0, d1):
        assert torch.equal(a, b)


def test_remat_first_epoch_matches_jax_remat(tmp_path):
    with jit_init():
        jt = JaxTrainer(Tiles("hwc"), 1, network="Unet", batch_size=BATCH, lr=LR,
                        n_filter=N_FILTER, save_dir=str(tmp_path / "jax"), seed=0,
                        mesh=get_mesh(n_data=1), remat=True)
    init = str(tmp_path / "init.pt")
    export_torch_checkpoint(init, {"params": jt.params, "batch_stats": jt.batch_stats},
                            {"model_name": "Unet", "n_filter": N_FILTER}, epoch=0)
    jt.start()
    t = Trainer(Tiles(), 1, network="Unet", batch_size=BATCH, lr=LR, n_filter=N_FILTER,
                save_dir=str(tmp_path / "port"), seed=0, device="cpu", remat=True,
                load_weights=init)
    t.start()
    rows = []
    for out in ("jax", "port"):
        with open(tmp_path / out / "metrics.csv") as fh:
            rows.append(np.array([[float(v) for v in r[:4]] for r in list(csv.reader(fh))[1:]]))
    np.testing.assert_allclose(rows[1], rows[0], rtol=1e-4)


def test_profile_dir_writes_one_trace_per_start(tmp_path):
    prof = tmp_path / "prof"
    t = Trainer(Tiles(n=8), 1, n_filter=N_FILTER, batch_size=BATCH, save_dir=str(tmp_path),
                seed=0, device="cpu", profile_dir=str(prof))
    for n in (1, 2):
        t.start()
        assert sorted(os.listdir(prof)) == sorted(os.path.basename(p) for p in t.trace_paths)
        assert len(t.trace_paths) == n
    for path in t.trace_paths:
        with open(path) as fh:
            names = {e.get("name") for e in json.load(fh)["traceEvents"]}
        assert "loss" in names  # the Trainer's own record_function range


def test_profile_dir_trace_is_written_when_the_run_raises(tmp_path, monkeypatch):
    t = Trainer(Tiles(n=8), 1, n_filter=N_FILTER, batch_size=BATCH, save_dir=str(tmp_path),
                seed=0, device="cpu", profile_dir=str(tmp_path / "prof"), save_name="model.ckpt")

    def broken(epoch):
        raise RuntimeError("validation broke")

    monkeypatch.setattr(t, "_iterate_val", broken)
    with pytest.raises(RuntimeError, match="validation broke"):
        t.start()
    assert len(t.trace_paths) == 1 and os.path.exists(t.trace_paths[0])
    with open(t.trace_paths[0]) as fh:
        assert json.load(fh)["traceEvents"]
    # the emergency checkpoint takes save_name's format
    assert os.path.exists(tmp_path / "model_interrupted.ckpt")
    assert not torch.autograd.profiler._is_profiler_enabled


def test_a_profiler_already_running_makes_the_trainer_raise(tmp_path):
    t = Trainer(Tiles(n=8), 1, n_filter=N_FILTER, batch_size=BATCH, save_dir=str(tmp_path),
                seed=0, device="cpu", profile_dir=str(tmp_path / "prof"))
    with torch.profiler.profile():
        with pytest.raises(RuntimeError, match="already running"):
            t.start()
    assert not os.path.exists(tmp_path / "prof") or not os.listdir(tmp_path / "prof")
    assert not os.path.exists(tmp_path / "model_interrupted.pt")
    t.start()  # outside the other profiler it runs
    assert len(t.trace_paths) == 1


def _volumes(n=4, heads=False):
    rng = np.random.default_rng(1)
    items = []
    for _ in range(n):
        item = {"volume": rng.random((1, 8, 16, 16), dtype=np.float32),
                "mask": (rng.random((1, 8, 16, 16)) > 0.5).astype(np.float32)}
        if heads:
            item["orientation"] = rng.random((2, 8, 16, 16), dtype=np.float32)
        items.append(item)
    return items


HEADS_2D = {"mask": {"channels": 1, "activation": "sigmoid", "loss": "BCEDiceLoss"}}
HEADS_3D = {"mask": {"channels": 1, "activation": "sigmoid", "loss": "BCEDiceLoss"},
            "orientation": {"channels": 2, "activation": None, "loss": "MSELoss"}}


@pytest.mark.parametrize("facade", ["unet", "siam_unet", "multi_output_unet", "unet3d",
                                    "multi_output_unet3d"])
def test_facades_pass_remat_and_profile_dir(tmp_path, facade):
    kw = dict(n_filter=4, save_dir=str(tmp_path), device="cpu", remat=True,
              profile_dir=str(tmp_path / "prof"))
    if facade == "unet":
        t = unet.Trainer(Tiles(n=4), 1, **kw)
    elif facade == "siam_unet":
        t = siam_unet.Trainer(Tiles(n=4, pairs=True), 1, **kw)
    elif facade == "multi_output_unet":
        t = multi_output_unet.Trainer(Tiles(n=4), 1, network="MultiOutputUnet",
                                      output_heads=HEADS_2D, tensorboard=False,
                                      log_images=False, **kw)
    elif facade == "unet3d":
        t = unet3d.Trainer(_volumes(), 1, **kw)
    else:
        t = multi_output_unet3d.Trainer(_volumes(heads=True), HEADS_3D, 1, **kw)
    assert t.remat and t.profile_dir == str(tmp_path / "prof")
