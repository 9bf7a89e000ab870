"""The Trainer with ``mesh=`` at a world of 2 gloo ranks on the CPU
(``tests/torch_mesh.py``): ``device_cache="sharded"`` against JAX's, and the
replicated layouts with ``device_augment`` and with a multi-head family
against the port's own world-1 run.

``device_cache="sharded"`` (``Unet``, n_filter 4, 32² blob tiles, batch 4, 2
epochs, lr 1e-4, from JAX's exported initial weights): each rank holds its
shard of the padded training set, draws its own permutation of it in JAX's
order and keeps its own BatchNorm statistics, averaged after each step with
the gradients and the loss; ``metrics.csv`` equals JAX's
``Trainer(mesh=get_mesh(n_data=2), device_cache="sharded")`` to rtol 1e-4
and its tensors JAX's at ``tests/test_torch_train.py``'s tolerances.  With
``device_augment`` in the replicated layout K4's draws are made for the
global batch and each rank applies its rows, so world 2 trains as world 1
does; so does a ``MultiOutputUnet`` with a mask and an orientation head
(K4h), whose validation batch of 2 splits over the ranks.  ``remat`` (with
``profile_dir``) trains at world 2 as without it, and a resume from rank 0's
``model.ckpt`` on every rank continues as a world-1 resume from it does."""

from __future__ import annotations

import pytest

from bio_image_unet_tpu_torch.train import Trainer
from test_torch_mesh_train import STEPS, jax_mesh_runs, matches_jax
from torch_mesh import (BATCH, EPOCHS, HEADS, LR, N_FILTER, blob_tiles, items, leg, ranks_agree,
                        rows, run_world, same_trajectory, state)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_train_sharded")
    arrays, heads_arrays = blob_tiles(), blob_tiles(10, seed=1)
    init_path, jax_runs = jax_mesh_runs(root, arrays, {"sharded": "sharded"})
    common = {"batch_size": BATCH, "lr": LR, "n_filter": N_FILTER, "seed": 0, "epochs": EPOCHS}
    legs = [{"leg": "train", "name": "sharded", "save_dir": str(root / "sharded"),
             "load_weights": init_path, "device_cache": "sharded", **common},
            {"leg": "train", "name": "augment", "save_dir": str(root / "augment"),
             "device_cache": True, "device_augment": True, **common},
            {"leg": "train", "name": "heads", "save_dir": str(root / "heads"),
             "keys": {"image": "h_image", "mask": "h_mask", "orientation": "h_orientation"},
             "network": "MultiOutputUnet", "output_heads": HEADS, "grad_clip": 1.0,
             "device_cache": True, "device_augment": True, **common}]
    legs += [{"leg": "train", "name": "remat", "save_dir": str(root / "remat"),
              "device_cache": True, "device_augment": True, "remat": True,
              "profile_dir": str(root / "traces"), **common},
             {"leg": "train", "name": "resume", "save_dir": str(root / "resume"),
              "load_weights": str(root / "augment_r0" / "model.ckpt"), "device_cache": True,
              "device_augment": True, **{**common, "epochs": 1}}]
    inputs = {**arrays, **{f"h_{k}": v for k, v in heads_arrays.items()}}
    ranks = run_world(2, legs, root / "world2", inputs)
    return root, arrays, heads_arrays, jax_runs, ranks


def test_sharded_cache_matches_jax_mesh(runs):
    root, _, _, jax_runs, ranks = runs
    res = leg(ranks, "sharded")
    assert "error" not in res[0], str(res[0].get("error"))
    ranks_agree(res)
    matches_jax(rows(str(root / "sharded_r0")), state(res[0]), *jax_runs["sharded"])


@pytest.mark.parametrize("name", ["augment", "heads"])
def test_replicated_world_two_trains_as_world_one(name, runs):
    root, arrays, heads_arrays, _, ranks = runs
    res = leg(ranks, name)
    assert "error" not in res[0], str(res[0].get("error"))
    ranks_agree(res)
    if name == "heads":
        data = items(heads_arrays, ["image", "mask", "orientation"])
        kw = {"network": "MultiOutputUnet", "output_heads": HEADS, "grad_clip": 1.0}
        steps = EPOCHS * ((10 - 2) // BATCH)
    else:
        data, kw, steps = items(arrays, ["image", "mask"]), {}, STEPS
    one_dir = str(root / f"one_{name}")
    t = Trainer(data, EPOCHS, batch_size=BATCH, lr=LR, n_filter=N_FILTER, seed=0,
                save_dir=one_dir, device="cpu", device_cache=True, device_augment=True, **kw)
    t.start()
    same_trajectory(rows(str(root / f"{name}_r0")), state(res[0]), rows(one_dir),
                    {k: v.numpy() for k, v in t.model.state_dict().items()}, steps)


def test_remat_and_profile_dir_at_world_two(runs):
    """The recompute repeats the forward's collectives and restores the
    BatchNorm statistics as on one process: the same run as without
    ``remat``; each rank writes its own trace."""
    root, *_, ranks = runs
    res = leg(ranks, "remat")
    assert "error" not in res[0], str(res[0].get("error"))
    ranks_agree(res)
    plain = leg(ranks, "augment")[0]
    same_trajectory(rows(str(root / "remat_r0")), state(res[0]), rows(str(root / "augment_r0")),
                    state(plain), STEPS)
    assert len(list((root / "traces").glob("*.json"))) == 2


def test_resume_at_world_two_continues_as_world_one(runs):
    """Every rank reads rank 0's checkpoint and continues from its epoch."""
    root, arrays, *_, ranks = runs
    res = leg(ranks, "resume")
    assert "error" not in res[0], str(res[0].get("error"))
    ranks_agree(res)
    ours = rows(str(root / "resume_r0"))
    assert ours[:, 0].tolist() == [2.0]
    one_dir = str(root / "one_resume")
    t = Trainer(items(arrays, ["image", "mask"]), 1, batch_size=BATCH, lr=LR, n_filter=N_FILTER,
                seed=0, save_dir=one_dir, device="cpu", device_cache=True, device_augment=True,
                load_weights=str(root / "augment_r0" / "model.ckpt"))
    t.start()
    same_trajectory(ours, state(res[0]), rows(one_dir),
                    {k: v.numpy() for k, v in t.model.state_dict().items()}, STEPS // 2)
