"""The Trainer with ``mesh=`` at a world of 2 gloo ranks on the CPU
(``tests/torch_mesh.py``), the replicated layouts: held against the JAX
Trainer on its 2-device mesh and against the port's own world-1 run.

A ``Unet`` (n_filter 4, 32² blob tiles, batch 4, 2 epochs, lr 1e-4, no
augmentation) trains from JAX's exported initial weights on the host loader
and with ``device_cache=True``, its mesh the Trainer's default at world 2
(JAX's rule: a data axis of 2).  Each ``metrics.csv`` equals JAX's
``Trainer(mesh=get_mesh(n_data=2))`` to rtol 1e-4 and its final tensors
equal JAX's at ``tests/test_torch_train.py``'s tolerances (rtol 1e-4 / atol
1e-5 on ≥ 90% of each tensor's elements, every element within 2·lr a step);
the run also equals the port's world-1 run (``torch_mesh.same_trajectory``).
The cross-rank BatchNorm equals ``nn.BatchNorm2d`` on the concatenated
batch, forward and backward, to rtol 1e-5.  ``device_cache="sharded"``,
``device_augment`` and a multi-head family are in
``test_torch_mesh_train_sharded.py``."""

from __future__ import annotations

import os

import jax
import numpy as np
import pytest
import torch

from bio_image_unet_tpu.interop.torch_export import export_torch_checkpoint
from bio_image_unet_tpu.parallel import get_mesh as jget_mesh
from bio_image_unet_tpu.train import Trainer as JaxTrainer
from bio_image_unet_tpu_torch.interop import state_dict_from_jax
from bio_image_unet_tpu_torch.train import Trainer
from torch_mesh import (BATCH, EPOCHS, LR, N_FILTER, blob_tiles, items, leg, pre_bn_bias,
                        ranks_agree, rows, run_world, same_trajectory, state)
from torch_parity import jit_init

MODES = {"loader": False, "cache": True}
STEPS = EPOCHS * ((12 - 3) // BATCH)  # 12 tiles, 3 for validation


def jax_mesh_runs(root, arrays, modes: dict):
    """JAX's ``Trainer(mesh=get_mesh(n_data=2))`` per mode: its rows and
    final variables, and the initial weights exported to ``init.pt``."""
    jmesh = jget_mesh(n_data=2, devices=jax.devices()[:2])
    init_path, out = str(root / "init.pt"), {}
    with jit_init():
        for mode, cache in modes.items():
            save = str(root / f"jax_{mode}")
            t = JaxTrainer(items(arrays, ["image", "mask"], hwc=True), EPOCHS, network="Unet",
                           batch_size=BATCH, lr=LR, n_filter=N_FILTER, save_dir=save, seed=0,
                           mesh=jmesh, device_cache=cache)
            if not out:
                export_torch_checkpoint(init_path, {"params": t.params,
                                                    "batch_stats": t.batch_stats},
                                        {"model_name": "Unet", "n_filter": N_FILTER}, epoch=0)
            t.start()
            out[mode] = (rows(save), {"params": t.params, "batch_stats": t.batch_stats})
    return init_path, out


def matches_jax(res_rows, ours: dict, ref_rows, ref_vars) -> None:
    """``tests/test_torch_train.py``'s tolerances against the JAX Trainer."""
    assert res_rows.shape == ref_rows.shape == (EPOCHS, 4)
    np.testing.assert_allclose(res_rows[:, 1:], ref_rows[:, 1:], rtol=1e-4)
    for k, v in state_dict_from_jax(ref_vars).items():
        if k.endswith("num_batches_tracked"):
            continue
        a, b = ours[k], v.numpy()
        assert np.abs(a - b).max() <= 2 * LR * STEPS, (k, np.abs(a - b).max())
        if not (pre_bn_bias(k) or k.endswith("running_mean")):
            close = np.isclose(a, b, rtol=1e-4, atol=1e-5).mean()
            assert close >= 0.9, (k, close)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_train")
    arrays = blob_tiles()
    init_path, jax_runs = jax_mesh_runs(root, arrays, MODES)
    common = {"batch_size": BATCH, "lr": LR, "n_filter": N_FILTER, "seed": 0, "epochs": EPOCHS}
    legs = [{"leg": "train", "name": mode, "save_dir": str(root / mode), "default_mesh": True,
             "load_weights": init_path, "device_cache": cache, **common}
            for mode, cache in MODES.items()]
    legs += [{"leg": "train", "name": "odd", "save_dir": str(root / "odd"), "default_mesh": True,
              **{**common, "batch_size": 3}},
             {"leg": "batchnorm", "name": "bn", "x": "bn_x", "weight": "bn_w", "bias": "bn_b",
              "grad": "bn_g"}]
    rng = np.random.default_rng(3)
    inputs = {**arrays,
              "bn_x": (rng.standard_normal((4, 3, 8, 8)) * 2 + 1).astype(np.float32),
              "bn_w": rng.uniform(0.5, 1.5, 3).astype(np.float32),
              "bn_b": rng.standard_normal(3).astype(np.float32),
              "bn_g": rng.standard_normal((4, 3, 8, 8)).astype(np.float32)}
    return root, arrays, init_path, jax_runs, run_world(2, legs, root / "world2", inputs)


@pytest.mark.parametrize("mode", list(MODES))
def test_world_two_matches_jax_mesh_and_world_one(mode, runs):
    root, arrays, init_path, jax_runs, ranks = runs
    res = leg(ranks, mode)
    assert "error" not in res[0], str(res[0].get("error"))
    assert res[0]["mesh"].tolist() == [2, 1]  # the default mesh: JAX's rule at world 2
    ranks_agree(res)
    ours = rows(str(root / f"{mode}_r0"))
    matches_jax(ours, state(res[0]), *jax_runs[mode])
    one_dir = str(root / f"one_{mode}")
    t = Trainer(items(arrays, ["image", "mask"]), EPOCHS, batch_size=BATCH, lr=LR,
                n_filter=N_FILTER, seed=0, save_dir=one_dir, device="cpu",
                load_weights=init_path, device_cache=MODES[mode])
    t.start()
    same_trajectory(ours, state(res[0]), rows(one_dir),
                    {k: v.numpy() for k, v in t.model.state_dict().items()}, STEPS)


def test_a_world_the_batch_leaves_ranks_out_of_raises_everywhere(runs):
    """batch 3 at world 2: JAX's rule gives a data axis of 1, which would
    leave rank 1 out; every rank raises the same error (no rank waits on
    another)."""
    for r in leg(runs[-1], "odd"):
        assert str(r["error"]).startswith("ValueError: batch_size 3 splits over at most 1 of "
                                          "the 2 ranks")


def test_cross_rank_batchnorm_equals_batchnorm_on_the_whole_batch(runs):
    inputs = np.load(os.path.join(runs[0], "world2", "inputs.npz"))
    bn = torch.nn.BatchNorm2d(3).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(inputs["bn_w"]))
        bn.bias.copy_(torch.from_numpy(inputs["bn_b"]))
    x = torch.from_numpy(inputs["bn_x"]).requires_grad_()
    y = bn(x)
    y.backward(torch.from_numpy(inputs["bn_g"]))
    want = {"y": y.detach(), "dx": x.grad, "dw": bn.weight.grad, "db": bn.bias.grad,
            "running_mean": bn.running_mean, "running_var": bn.running_var}
    for r in leg(runs[-1], "bn"):
        for k, v in want.items():
            np.testing.assert_allclose(r[k], v.numpy(), rtol=1e-5, atol=1e-6, err_msg=k)
