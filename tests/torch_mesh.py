"""Launcher of the port's multi-process legs (``tests/torch_mesh_worker.py``):
a real gloo world of 2 or 4 ranks on the CPU, one process a rank, as
``tests/test_multihost.py`` runs JAX's multi-host legs.  One launch runs every
leg a test file needs; each rank writes one ``.npz``.  Also the training
tiles and the checks that ``test_torch_mesh_train*.py`` share."""

from __future__ import annotations

import csv
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

from bio_image_unet_tpu_torch.utils.synth import blob_sample

WORKER = Path(__file__).resolve().parent / "torch_mesh_worker.py"


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _launch(world: int, spec: str, timeout: float, port: int):
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(r), str(world), str(port), spec],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env={**os.environ, "OMP_NUM_THREADS": "1"})
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            try:
                out, _ = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                for q in procs:
                    if q.poll() is None:
                        q.kill()
                out, _ = p.communicate()
                out = (out or "") + f"\n[killed after {timeout:.0f} s]"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return procs, outs


def run_world(world: int, legs: list, root: Path, inputs: dict = None,
              timeout: float = 240.0) -> list:
    """Run ``legs`` on ``world`` gloo ranks; returns one ``{name/key:
    array}`` dict a rank.  ``inputs`` (numpy arrays) go to the workers in one
    npz.  The coordinator port is picked free; the probe socket closes
    before the store binds, so a stolen port gets one retry on a fresh one."""
    root.mkdir(parents=True, exist_ok=True)
    spec = {"out": str(root), "legs": legs, "inputs": None}
    if inputs:
        spec["inputs"] = str(root / "inputs.npz")
        np.savez(spec["inputs"], **inputs)
    spec_path = root / "spec.json"
    spec_path.write_text(json.dumps(spec))
    for attempt in range(2):
        procs, outs = _launch(world, str(spec_path), timeout, _free_port())
        if all(p.returncode == 0 for p in procs) or attempt == 1:
            break
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    return [dict(np.load(root / f"rank{r}.npz")) for r in range(world)]


def leg(results: list, name: str) -> list:
    """One leg's ``{key: array}`` on every rank."""
    pre = name + "/"
    return [{k[len(pre):]: v for k, v in r.items() if k.startswith(pre)} for r in results]


# --- the training legs' data and checks ---------------------------------------

N_FILTER, SIZE, BATCH, EPOCHS, LR = 4, 32, 4, 2, 1e-4
HEADS = {"mask": {"channels": 1, "activation": "sigmoid", "loss": "BCEDiceLoss"},
         "orientation": {"channels": 2, "activation": None, "loss": "MSELoss", "weight": 0.5}}


def blob_tiles(n: int = 12, seed: int = 0) -> dict:
    """Blob tiles in [0, 1] with an orientation field (the angle about a
    random point, as (cos θ, sin θ)): CHW float32 arrays."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:SIZE, :SIZE]
    image, mask, orient = [], [], []
    for _ in range(n):
        img, m = blob_sample(rng, (SIZE, SIZE), n_blobs=3, margin=4, radius=(3, 6))
        theta = np.arctan2(yy - rng.uniform(0, SIZE), xx - rng.uniform(0, SIZE))
        image.append((img / 255.0).astype(np.float32)[None])
        mask.append((m / 255.0).astype(np.float32)[None])
        orient.append(np.stack([np.cos(theta), np.sin(theta)]).astype(np.float32))
    return {"image": np.stack(image), "mask": np.stack(mask), "orientation": np.stack(orient)}


def items(arrays: dict, keys, hwc: bool = False) -> list:
    """Dataset items of ``keys``: CHW (the port) or HWC (JAX)."""
    n = len(arrays[keys[0]])
    if hwc:
        return [{k: np.ascontiguousarray(np.moveaxis(arrays[k][i], 0, -1)) for k in keys}
                for i in range(n)]
    return [{k: arrays[k][i] for k in keys} for i in range(n)]


def rows(save_dir) -> np.ndarray:
    """A run's ``metrics.csv`` rows: epoch, train loss, val loss, lr."""
    with open(os.path.join(save_dir, "metrics.csv")) as fh:
        lines = list(csv.reader(fh))
    assert lines[0] == ["epoch", "train_loss", "val_loss", "lr", "seconds"]
    return np.array([[float(v) for v in r[:4]] for r in lines[1:]])


def pre_bn_bias(key: str) -> bool:
    """The conv bias of a ConvBlock (``<block>.0.bias``), in front of its
    BatchNorm: its gradient is zero in exact arithmetic, so it is rounding
    noise, which Adam's normalized step scales to ±lr."""
    return key.endswith(".0.bias") and not key.startswith("final")


def state(res: dict) -> dict:
    """A train leg's final parameters and buffers."""
    return {k[len("state/"):]: v for k, v in res.items() if k.startswith("state/")}


def ranks_agree(res: list) -> None:
    """Every rank ends with the same parameters and buffers; rank 0 wrote
    ``metrics.csv`` and rank 1 wrote nothing."""
    a, b = state(res[0]), state(res[1])
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert "metrics.csv" in res[0]["files"].tolist()
    assert res[1]["files"].tolist() == [""]


def same_trajectory(ours_rows, ours_state: dict, one_rows, one_state: dict, steps: int) -> None:
    """World 2 against the port's world 1: the train losses to rtol 1e-5;
    every tensor but the pre-BatchNorm conv biases and the running means
    that take them in within 1e-5; those biases within 2·lr a step.  The
    validation losses, which read those running means, to rtol 1e-4 (a
    pre-BatchNorm bias's gradient is rounding noise, summed in another order
    over two ranks, and Adam turns it into up to ±lr a step)."""
    np.testing.assert_allclose(ours_rows[:, 1], one_rows[:, 1], rtol=1e-5)
    np.testing.assert_allclose(ours_rows[:, 2:], one_rows[:, 2:], rtol=1e-4)
    for k, v in one_state.items():
        if k.endswith("num_batches_tracked"):
            continue
        d = np.abs(ours_state[k] - v).max()
        if pre_bn_bias(k):
            assert d <= 2 * LR * steps, (k, d)
        elif not k.endswith("running_mean"):
            assert d <= 1e-5, (k, d)
