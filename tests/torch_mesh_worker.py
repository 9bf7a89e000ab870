"""Rank worker of the port's multi-process tests (pytest does not collect it):

    python tests/torch_mesh_worker.py RANK WORLD PORT SPEC.json

joins a gloo process group of WORLD ranks at 127.0.0.1:PORT (one torch
thread, ``device="cpu"``), runs the legs that SPEC lists — each
``{"leg": <function of this file>, "name": <key>, **arguments}`` — and writes
every array a leg returns to ``<SPEC's out>/rank<RANK>.npz`` under
``<name>/<key>`` (a leg that raises leaves its message under
``<name>/error``).  Inputs come from SPEC's ``inputs`` npz.  It imports the
port and never JAX; ``tests/torch_mesh.py`` launches it.
"""

from __future__ import annotations

import json
import os
import sys
from datetime import timedelta

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bio_image_unet_tpu_torch.parallel import (get_mesh, halo_exchange,  # noqa: E402
                                               initialize_distributed, shard_batch,
                                               spatial_shard_apply)

RANK, WORLD = int(sys.argv[1]), int(sys.argv[2])
INPUTS = {}
OUT = ""


def _mesh(n_data: int, n_spatial: int = 1):
    return get_mesh(n_data=n_data, n_spatial=n_spatial)


def _own(path: str) -> str:
    """This rank's copy of an output path: only rank 0 may write it."""
    root, ext = os.path.splitext(path)
    return f"{root}_r{RANK}{ext}"


# --- parallel ------------------------------------------------------------------

def conv_stack(n_data, n_spatial, halo, x, kernels, odd=False):
    """``spatial_shard_apply`` of SAME 3×3 convs + LeakyReLU(0.1) (NCHW; the
    HWIO kernels of the JAX test) on the whole ``x``."""
    ks = [torch.from_numpy(np.ascontiguousarray(INPUTS[k].transpose(3, 2, 0, 1)))
          for k in kernels]

    def fn(t):
        for k in ks:
            t = F.leaky_relu(F.conv2d(t, k, padding=1), 0.1)
        return t

    mesh = _mesh(n_data, n_spatial)
    xt = torch.from_numpy(INPUTS[x])
    out = {"out": spatial_shard_apply(fn, xt, mesh, halo).numpy()}
    if odd:  # a batch the data axis does not divide: replicated over data
        out["odd"] = spatial_shard_apply(fn, xt[:3], mesh, halo).numpy()
    return out


def halo_edges(n_data, n_spatial, halo):
    """Each rank's block filled with its rank + 1, padded by the exchange."""
    block = torch.full((1, 1, 4, 3), float(RANK + 1))
    mesh = _mesh(n_data, n_spatial)
    return {"padded": halo_exchange(block, halo, mesh=mesh).numpy(),
            "coords": np.asarray(mesh.coords)}


def divisible(n_spatial):
    spatial_shard_apply(lambda t: t, torch.zeros(1, 1, 5, 4), _mesh(1, n_spatial), 1)


def batch(n_data, x):
    local, n = shard_batch(INPUTS[x], _mesh(n_data), device="cpu")
    return {"local": local.numpy(), "n": np.asarray(n)}


# --- predict --------------------------------------------------------------------

def predict(cls, ckpt, movie, n_data=2, result=None, **kw):
    """One Predict class on the mesh; ``result`` a file to write (this
    rank's copy of the path, so the parent sees which ranks wrote)."""
    from bio_image_unet_tpu_torch import predict as P

    mesh = _mesh(n_data)
    kw = dict(kw, mesh=mesh, device="cpu", show_progress=False)
    if cls == "Predict":
        res = P.Predict(INPUTS[movie], result and _own(result), ckpt, **kw).result
    elif cls == "Predict3D":
        res = P.Predict3D(INPUTS[movie], result and _own(result), ckpt, **kw).result
    elif cls == "PredictMultiOutput":
        res = P.PredictMultiOutput(INPUTS[movie], ckpt, result and _own(result), **kw).result
    elif cls == "PredictMultiOutput3D":
        res = P.PredictMultiOutput3D(INPUTS[movie], ckpt, result and _own(result), **kw).result
    else:  # PredictSiam: a TIFF in, this rank's TIFF out (rank 0's only)
        from bio_image_unet_tpu_torch.data import tiff

        out = _own(result)
        P.PredictSiam(movie, out, ckpt, **kw)
        res = tiff.imread(out) if os.path.exists(out) else np.zeros(0, np.uint8)
    return res if isinstance(res, dict) else {"result": res}


def frames_sharded(ckpt, movie, n_data, n_spatial, halo, **kw):
    from bio_image_unet_tpu_torch.predict import predict_frames_spatial_sharded

    return {"result": predict_frames_spatial_sharded(INPUTS[movie], ckpt,
                                                     _mesh(n_data, n_spatial), halo=halo,
                                                     device="cpu", **kw)}


def volume_sharded(ckpt, movie, n_data, n_spatial, halo, **kw):
    from bio_image_unet_tpu_torch.predict import predict_volume_spatial_sharded

    return {"result": predict_volume_spatial_sharded(INPUTS[movie], ckpt,
                                                     _mesh(n_data, n_spatial), halo=halo,
                                                     device="cpu", **kw)}


# --- train ----------------------------------------------------------------------

def _tiles(keys):
    """The parent's seeded training tiles: CHW float32 items, ``keys`` the
    item keys (their input arrays of the same name) or ``{item key: input
    key}``."""
    keys = keys if isinstance(keys, dict) else {k: k for k in keys}
    n = len(INPUTS[next(iter(keys.values()))])
    return [{k: INPUTS[v][i] for k, v in keys.items()} for i in range(n)]


def train(save_dir, keys=("image", "mask"), mesh_data=2, default_mesh=False, **kw):
    """A Trainer on the mesh (or, with ``default_mesh``, the Trainer's own
    rule); returns its rows (rank 0), its final parameters and buffers, and
    the files this rank wrote."""
    from bio_image_unet_tpu_torch.train import Trainer

    out = _own(save_dir)
    t = Trainer(_tiles(keys), kw.pop("epochs"), save_dir=out, device="cpu",
                mesh=None if default_mesh else _mesh(mesh_data), **kw)
    t.start()
    res = {f"state/{k}": v.numpy() for k, v in t.model.state_dict().items()}
    res["history"] = np.array([[h["train_loss"], h["val_loss"]] for h in t.history])
    res["files"] = np.array(sorted(os.listdir(out)) or [""])
    res["mesh"] = np.array([t.mesh.shape["data"], t.mesh.shape["spatial"]])
    return res


def batchnorm(x, weight, bias, grad):
    """``CrossRankBatchNorm`` on this rank's rows of the batch: the output,
    the input's gradient, the affine gradients summed over the ranks and the
    running statistics."""
    from torch import nn

    from bio_image_unet_tpu_torch.parallel.batchnorm import CrossRankBatchNorm

    mesh = _mesh(WORLD)
    m = INPUTS[x].shape[0] // WORLD
    rows = slice(RANK * m, (RANK + 1) * m)
    base = nn.BatchNorm2d(INPUTS[x].shape[1])
    with torch.no_grad():
        base.weight.copy_(torch.from_numpy(INPUTS[weight]))
        base.bias.copy_(torch.from_numpy(INPUTS[bias]))
    bn = CrossRankBatchNorm(base, mesh.group("data")).train()
    xt = torch.from_numpy(INPUTS[x][rows]).requires_grad_()
    y = bn(xt)
    y.backward(torch.from_numpy(INPUTS[grad][rows]))
    dw, db = bn.weight.grad.clone(), bn.bias.grad.clone()
    mesh.all_reduce(dw)
    mesh.all_reduce(db)
    return {"y": mesh.all_gather(y.detach()).numpy(), "dx": mesh.all_gather(xt.grad).numpy(),
            "dw": dw.numpy(), "db": db.numpy(), "running_mean": bn.running_mean.numpy(),
            "running_var": bn.running_var.numpy()}


def main():
    global INPUTS, OUT
    port, spec_path = sys.argv[3], sys.argv[4]
    with open(spec_path) as fh:
        spec = json.load(fh)
    OUT = spec["out"]
    INPUTS = dict(np.load(spec["inputs"])) if spec.get("inputs") else {}
    torch.set_num_threads(1)
    initialize_distributed(backend="gloo", init_method=f"tcp://127.0.0.1:{port}", rank=RANK,
                           world_size=WORLD, timeout=timedelta(seconds=120))
    results = {}
    try:
        for leg in spec["legs"]:
            leg = dict(leg)
            fn, name = globals()[leg.pop("leg")], leg.pop("name")
            try:
                out = fn(**leg) or {}
            except Exception as err:  # recorded for the parent to check
                out = {"error": np.array(f"{type(err).__name__}: {err}")}
            for key, value in out.items():
                results[f"{name}/{key}"] = np.asarray(value)
            print(f"rank {RANK}: {name} done", flush=True)
    finally:
        np.savez(os.path.join(OUT, f"rank{RANK}.npz"), **results)
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
