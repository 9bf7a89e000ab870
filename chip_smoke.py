#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``bio_image_unet_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each printing its lines; any failure raises and the script exits
non-zero without printing a result:

1. device — the card's name and power limit (``nvidia-smi``);
2. build  — every kernel of ``bio_image_unet_tpu_torch/csrc`` compiled by nvcc
   for sm_90a (one nvcc per source, all started together), with the ptxas
   register / shared-memory summary;
3. kernels — each kernel held against its plain PyTorch version on the card
   at the shapes the main path gives it (K1 / K1f bit-equal, K2 equal, K3
   within one uint8 level), and timed with CUDA events (L2 flushed before
   every launch) beside its least possible time and, where one PyTorch call
   computes the same function, that call's time;
4. main path — ``Predict`` on a random-weight ``Unet(n_filter=32)`` checkpoint
   (seeded ``torch.Generator``, non-trivial BatchNorm statistics): the
   64×1024² uint8 bf16 movie of ``bench.py``, an overlapping uint16 case, a
   float32 case and a ``'first'`` case.  The kernels' launch counts are set
   to 0 just before and read just after; every kernel must have launched.
   Each result is held against the port's host-staged path
   (``device_pipeline=False``), and a small float32 ``Predict`` on the card
   against the same on the CPU.  Prints the end-to-end and device-resident
   MP/s (the definitions of ``bench.py``);
5. kernels (training) — K4, the gather and augmentation of a training batch,
   held against its plain version at the training shapes (12 tiles of 256²
   gathered from a 120-tile resident set: mask bit-equal, image within one
   float32 ulp) and timed beside its byte bound;
6. train — the second main path, through the ``unet`` facade a user calls:
   ``DataProcess`` on 150 blob frames of 256² (``utils.synth``), then
   ``Trainer`` at the full width of ``benchmarks/train_bench.py``
   (``Unet(n_filter=32)``, batch 12, lr 1e-4, BCEDice, bf16,
   ``device_cache=True``, ``device_augment=True``) for 3 epochs of 10 steps.
   The launch counts are set to 0 just before and read just after: K4 must
   have launched once per step.  Prints the per-epoch losses, patches/s
   (``train_bench.py``'s definition: steps·batch over the best training
   epoch's wall time), step time, peak device memory and the implied share
   of the card's bf16 peak; the last epoch's train loss must be below the
   first's.  Then one profiled epoch (device time by stage, idle share), the
   trained ``.pt`` through ``Predict`` on a 16-frame blob movie (mask IoU
   against the blob truth), and a small float32 training run on the card
   against the same on the CPU (``metrics.csv`` rows within rtol 1e-3);
7. kernels (heads) — K2h (float tiles), K5 (safe-margin stitch, float16
   and float32 out) and K5s (the tile sum of the fill) against their plain
   versions at the multi-head path's shapes (a 16-frame chunk of 1024² uint8
   frames in 512² tiles, heads of 1 and 2 channels): K2h equal, K5
   bit-equal, K5s's sum equal and its fill within one float16 ulp; timed
   beside their byte bounds and, for K5, ``F.fold`` of the weighted tiles;
8. heads — the third main path, ``PredictMultiOutput`` at the full width of
   ``benchmarks/family_bench.py``'s multi-output configuration:
   ``MultiOutputNestedUNet(n_filter=32)`` with its two heads (``mask``: 1
   channel, sigmoid; ``orientation``: 2 channels, none), 512² patches,
   bf16, ``safe_margin=20``, on a 40-frame 1024² uint8 movie (two 16-frame
   chunks and a tail of 8).  Around each call on that movie, fused and
   host-staged, the launch counts are set to 0 just before and read just
   after, and must be exactly what the path launches (fused, per chunk: K1's
   two uint8 launches, K2h once, K5 and K5s once per head; host-staged: K5
   and K5s).
   Prints end-to-end MP/s (best of two after a warm-up), device-resident
   MP/s, peak device memory, the implied share of the bf16 dense peak and a
   profiled pass by stage; holds the fused path against the host-staged one
   at the same forward batch within atol 2e-3 on every pixel, fill included,
   in bf16 on the whole movie and in float32 on 16 frames; holds the
   device-resident program equal to its ``PredictMultiOutput`` call; covers
   ``MultiOutputUnet(n_filter=32)`` on an overlapping uint16 1000² movie and
   a float32 ``'first'`` movie with a reflect-padded axis; and holds a small
   float32 ``PredictMultiOutput`` (``n_filter=4``) on the card against the
   CPU (``|card − CPU| ≤ 1e-3 + 1e-3·|CPU|``);
9. kernels (heads training) — K4h, the multi-head gather and augmentation,
   held against its plain version at the shapes of the multi-output
   training path (4 of 64 resident 256² tiles, image 1 channel, targets
   1 + 2 channels, every (k, flip_h, flip_v) case forced once): targets
   bit-equal (zeros by value), image within one float32 ulp; timed beside
   its byte bound;
10. train heads — the fourth main path, through the ``multi_output_unet``
   facade a user calls: ``DataProcess`` on 40 blob frames of 256² with a
   mask and an orientation-angle target (NaN where the angle is undefined),
   ``aug_factor=2`` (80 tiles: 16 steps of 4 per epoch), then ``Trainer`` at
   ``benchmarks/family_bench.py``'s training configuration
   (``MultiOutputNestedUNet(n_filter=32)``, its two heads with their
   losses, batch 4, lr 1e-4, bf16, ``device_cache=True``,
   ``device_augment=True``, the facade's ``grad_clip=1.0``) for 3 epochs.
   The launch counts are set to 0 just before and read just after: K4h
   must have launched once per step and nothing else at all.  Prints the
   per-epoch losses (the last epoch's train loss must be below the
   first's), patches/s (``family_bench.py``'s definition), step time, peak
   device memory, the implied share of the bf16 dense peak and one profiled
   epoch by stage; then one epoch of ``MultiOutputNestedUNet_3Levels`` with
   deep supervision through ``PredictMultiOutput``, the trained ``.pt``
   through ``PredictMultiOutput`` on a 16-frame blob movie (mask IoU against
   the truth), and a small float32 training run on the card against the
   same on the CPU (``metrics.csv`` rows within rtol 1e-3);
11. kernels (3d) — K2v (a volume's normalize and 3-axis tiles, uint8 and
   bf16 modes), K3v (sigmoid·255 and the volume's mean stitch) and K5v (the
   multi-head linear-blend stitch, float16 and float32 out) against their
   plain versions at the 3D paths' shapes (K2v equal, K3v within one uint8
   level, K5v bit-equal), timed beside their byte bounds; and K1 on one
   whole volume (a 16.7 M-voxel uint8 row and a 67 M-voxel uint16 row)
   bit-equal to its plain version;
12. 3d — the fifth main path, ``Predict3D`` at
   ``benchmarks/family_bench.py``'s 3D configuration: ``UNet3D(n_filter=32)``
   (seeded, with BatchNorm statistics) on a 64×512² uint8 volume, tiles
   (32, 128, 128), bf16, ``batch_size=4`` (forward batch 16).  Around each
   call the launch counts are set to 0 just before and read just after, and
   must be exactly K1's two uint8 launches, K2v once, K3v once.  Prints the
   end-to-end and device-resident Mvox/s, peak device memory, the implied
   share of the bf16 dense peak (``unet3d_forward_flops``) and a profiled
   pass by stage; holds fused against host-staged at the same forward batch
   and a small float32 ``Predict3D`` on the card against the CPU within the
   uint8 contract; covers the trilinear decoder and uint16 with
   ``add_patch=1``;
13. 3d heads — the sixth main path, ``PredictMultiOutput3D`` on
   ``MultiOutputUnet3D(n_filter=32)`` (nearest decoder, heads ``mask``: 1
   channel, sigmoid; ``vec``: 2 channels, none) over 2 uint8 volumes of
   64×512², the class defaults (tiles (64, 256, 256), ``overlap_factor=0.1``,
   ``blend_margin=16``, ``batch_size=2``), bf16.  Launch counts exact around
   each call (K1 2, K2v 1, K5v once per head); the same prints; fused
   against host-staged at the same forward batch within 2e-3 + 1e-3·|host|;
   a small float32 case on the card against the CPU;
14. kernels (3d training) — K4v, the gather and augmentation of a batch of
   volumes, at the 3D training path's shapes (4 of 40 resident
   (1, 16, 64, 64) volumes) and K4hv, its multi-head form, at the coverage
   path's (2 of 16 resident volumes of (32, 128, 128), targets mask +
   orientation), against their plain versions with every (k, flip_h,
   flip_v) case forced once and a sample gated off: targets bit-equal,
   image within one float32 ulp; timed beside their byte bounds;
15. train 3d — the seventh main path, ``benchmarks/family_bench.py``'s 3D
   training through the ``unet3d`` facade: ``UNet3D(n_filter=32)``
   (transposed-conv decoder, the facade's ``time_loss_weight=0.1``) on 40
   resident volumes of (16, 64, 64), batch 4, bf16, ``val_split=0``,
   ``device_augment=True``, a warm-up epoch and 3 timed ones.  The launch
   counts are set to 0 just before ``Trainer.start()`` and read just after:
   K4v exactly once per step, nothing else.  Prints volumes/s (the best
   timed epoch, ``family_bench.py``'s definition), step time, peak device
   memory, the share of the bf16 dense peak and a profiled epoch (device
   busy time by stage, idle share).  Then the coverage path: the
   ``multi_output_unet3d`` facade on ``MultiOutputUnet3D(n_filter=32)``
   (its ``use_interpolation=False``), mask and orientation heads with the
   3D head losses, 16 resident volumes of (32, 128, 128), batch 2, bf16,
   3 epochs, K4hv exactly once per step; each trained ``.pt`` through
   ``Predict3D`` / ``PredictMultiOutput3D`` on the card with K1, K2v and
   K3v / K5v launched exactly as those paths launch them; and a small
   float32 ``UNet3D`` training run on the card against the CPU
   (``metrics.csv`` rows within rtol 1e-3);
16. the kernels' JSON line, then the last line
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Without CUDA, or outside a checkout of the repository, it exits with code 2.
"""

from __future__ import annotations

import csv
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent

# published peaks of one H100 SXM (NVIDIA's data sheet): HBM3 bandwidth,
# float32 rate outside the tensor cores (the kernels here do scalar work) and
# the dense bf16 tensor-core rate (the training convolutions)
PEAK_BYTES_PER_S = 3.35e12
PEAK_SCALAR_OPS_PER_S = 67e12
PEAK_BF16_FLOPS = 989e12

FRAMES, H, W, TILE, N_FILTER = 64, 1024, 1024, 256, 32
CHUNK = 16
L2_FLUSH_BYTES = 128 << 20
# the training path: train_bench.py's width and batch, 150 frames → 120
# training tiles (10 steps of 12) + 30 validation tiles
TRAIN_FRAMES, TRAIN_BATCH, TRAIN_EPOCHS, TRAIN_LR = 150, 12, 3, 1e-4


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(2)


def log(msg: str) -> None:
    print(msg, flush=True)


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: the port's kernels run on an NVIDIA GPU only")
    if not (REPO / "bio_image_unet_tpu_torch" / "csrc").is_dir():
        fail(f"{REPO} is not a checkout of the repository (bio_image_unet_tpu_torch/ missing)")
    sys.path.insert(0, str(REPO))

    from bio_image_unet_tpu_torch.ops import _cuda

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = phase_device()
    phase_build(_cuda)
    kernels = phase_kernels(torch, dev)
    k4 = phase_kernel_augment(torch, dev)
    phase_main_path(torch, dev, kernels)
    kernels.append(k4)
    phase_train(torch, dev, kernels)
    heads = phase_kernels_heads(torch, dev)
    phase_heads(torch, dev, kernels, heads)
    kernels.extend(heads)
    k4h = phase_kernel_augment_heads(torch, dev)
    kernels.append(k4h)
    phase_train_heads(torch, dev, kernels)
    k3d = phase_kernels_3d(torch, dev)
    phase_3d(torch, dev, kernels, k3d)
    phase_3d_heads(torch, dev, kernels, k3d)
    kernels.extend(k3d)
    kernels.extend(phase_kernels_3d_training(torch, dev))
    phase_train_3d(torch, dev, kernels)
    for k in kernels:
        k.pop("_counter")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


# --- 1. device ----------------------------------------------------------------

def phase_device() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()
    if not out:
        raise RuntimeError("nvidia-smi reported no card")
    log(f"[device] {out[0]}")
    return out[0]


# --- 2. build -------------------------------------------------------------------

def phase_build(_cuda) -> None:
    # build from the sources, never from libraries an earlier run left behind
    shutil.rmtree(_cuda.BUILD, ignore_errors=True)
    t0 = time.perf_counter()
    logs = _cuda.build()
    dt = time.perf_counter() - t0
    for name in _cuda.SOURCES:
        if name not in logs:
            raise RuntimeError(f"kernel {name} was not built")
        for line in logs[name].splitlines():
            line = line.strip()
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                log(f"[build] {name}: {line}")
    log(f"[build] {len(logs)} sources built by nvcc for sm_90a in {dt:.1f} s")


# --- 3. kernels -----------------------------------------------------------------

class Timer:
    """Mean device time of ``fn`` over ``iters`` launches, each after a write
    of 128 MB that evicts the 50 MB L2 (the main path finds its inputs cold:
    they were just uploaded or written by the previous stage)."""

    def __init__(self, torch, dev):
        self.torch = torch
        self.flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)

    def __call__(self, fn, iters: int = 10) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(iters):
            self.flush.fill_(1)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / iters


def kernel_row(tag, name, source, replaces, counter, err, ms, plain_ms, bound,
               library_ms) -> dict:
    """One kernel's entry of the JSON line (its launches are filled in from
    the main path), logged as it is made."""
    b, by = bound
    log(f"[{tag}] {name}: max_abs_err {err} | kernel {ms:.4f} ms | plain {plain_ms:.4f} ms"
        f" | bound {b:.4f} ms ({by}) | library "
        + ("none" if library_ms is None else f"{library_ms:.4f} ms"))
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": 0, "max_abs_err": float(err), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b, "bound_by": by, "library_ms": library_ms, "_counter": counter}


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(torch, dev) -> list:
    from bio_image_unet_tpu_torch.ops import histogram as hist
    from bio_image_unet_tpu_torch.ops.stitch import sigmoid_stitch, sigmoid_stitch_plain
    from bio_image_unet_tpu_torch.predict.normalize import normalize_tile, normalize_tile_plain
    from bio_image_unet_tpu_torch.predict.tiling import TilePlan, grid_starts

    timer = Timer(torch, dev)
    g = torch.Generator(device=dev).manual_seed(0)
    qs = (0.0, 99.8)
    rows = []

    def row(*args):
        rows.append(kernel_row("kernels", *args))

    def library_sort(x):
        """One torch.sort gives every order statistic of every frame."""
        flat = x.reshape(x.shape[0], -1)
        try:
            torch.sort(flat, dim=1)
        except (RuntimeError, NotImplementedError) as err:
            log(f"[kernels] torch.sort takes no {x.dtype} on the card ({err.__class__.__name__})")
            return None
        return timer(lambda: torch.sort(flat, dim=1), iters=5)

    # K1 / K1f: 16-frame chunks of 1024² frames, the main path's shapes
    movies = {
        "uint8": torch.randint(0, 256, (CHUNK, H, W), generator=g, device=dev,
                               dtype=torch.int32).to(torch.uint8),
        "uint16": torch.randint(0, 65536, (CHUNK, H, W), generator=g, device=dev,
                                dtype=torch.int32).to(torch.uint16),
        "float32": torch.randn((CHUNK, H, W), generator=g, device=dev) * 40 + 5,
    }
    for dt_name, x in movies.items():
        is_f = dt_name == "float32"
        wrapper = hist.float_clip_bounds if is_f else hist.int_clip_bounds
        ours = wrapper(x, *qs)
        torch.cuda.synchronize()
        ref = hist.clip_bounds_plain(x, *qs)
        if not torch.equal(ours.view(torch.int32), ref.view(torch.int32)):
            raise AssertionError(f"K1 {dt_name}: kernel {ours.tolist()} != plain {ref.tolist()}")
        n_pix = x.numel()
        row(("k1f_float_clip_bounds" if is_f else "k1_int_clip_bounds") + f"[{dt_name}]",
            "bio_image_unet_tpu_torch/csrc/clip_bounds.cu",
            "bio_image_unet_tpu/ops/histogram.py:" + ("142" if is_f else "110"),
            wrapper, (ours - ref).abs().max().item(),
            timer(lambda: wrapper(x, *qs)), timer(lambda: hist.clip_bounds_plain(x, *qs), 3),
            # least work: read every pixel once, one compare each; write 4 bounds
            bound_ms(n_pix * x.element_size() + 4 * CHUNK * 4, n_pix),
            library_sort(x))

    # K2 and K3 on the exact grid (uint8, 1024² in 256² tiles) and the
    # overlapping grid (uint16, 1000² in 256² tiles, add_tile=1)
    grids = {
        "exact": (movies["uint8"], H, W, 0),
        "gather": (movies["uint16"][:, :1000, :1000].contiguous(), 1000, 1000, 1),
    }
    for grid, (x, h, w, add) in grids.items():
        plan = TilePlan(h, w, TILE, TILE, grid_starts(h, TILE, add), grid_starts(w, TILE, add), dev)
        n = CHUNK * plan.per_frame
        bs = max(8, min(n, (1 << 24) // (TILE * TILE)))
        n_pad = -(-n // bs) * bs
        bounds = hist.clip_bounds(x, *qs)
        ours = normalize_tile(x, bounds, plan, n_pad, False)
        torch.cuda.synchronize()
        ref = normalize_tile_plain(x, bounds, plan, n_pad, False)
        err = (ours.int() - ref.int()).abs().max().item()
        if err != 0:
            raise AssertionError(f"K2 {grid}: kernel differs from plain by {err} levels")
        out_bytes = n_pad * TILE * TILE
        row(f"k2_normalize_tile[{grid}]", "bio_image_unet_tpu_torch/csrc/normalize_tile.cu",
            "bio_image_unet_tpu/predict/predictor.py:742", normalize_tile, err,
            timer(lambda: normalize_tile(x, bounds, plan, n_pad, False)),
            timer(lambda: normalize_tile_plain(x, bounds, plan, n_pad, False), 3),
            # read each source pixel once, write each tile pixel once; about
            # five float operations per tile pixel (clip, subtract, divide, scale)
            bound_ms(x.numel() * x.element_size() + bounds.numel() * 4 + out_bytes,
                     5 * out_bytes),
            None)

        logits = (torch.randn((n_pad, 1, TILE, TILE), generator=g, device=dev) * 4
                  ).to(torch.bfloat16)
        ours = sigmoid_stitch(logits, CHUNK, plan)
        torch.cuda.synchronize()
        ref = sigmoid_stitch_plain(logits, CHUNK, plan)
        err = (ours.int() - ref.int()).abs().max().item()
        if err > 1:
            raise AssertionError(f"K3 {grid}: kernel differs from plain by {err} levels")
        n_logit = n * TILE * TILE
        row(f"k3_sigmoid_stitch[{grid}]", "bio_image_unet_tpu_torch/csrc/sigmoid_stitch.cu",
            "bio_image_unet_tpu/predict/predictor.py:450", sigmoid_stitch, err,
            timer(lambda: sigmoid_stitch(logits, CHUNK, plan)),
            timer(lambda: sigmoid_stitch_plain(logits, CHUNK, plan), 3),
            # read each real tile's logits once (bf16), write each pixel once;
            # about four operations per logit (exp, add, divide, scale) + the sum
            bound_ms(n_logit * 2 + CHUNK * h * w, 5 * n_logit),
            None)
        del logits, ours, ref
    del movies
    torch.cuda.empty_cache()
    return rows


# --- 4. main path ---------------------------------------------------------------

def write_checkpoint(torch, path: str, name: str, n_filter: int, seed: int = 0,
                     **hyper) -> None:
    """A reference-schema ``.pt`` of registry model ``name`` with seeded random
    weights and random BatchNorm statistics (so the BN fold has something to
    fold); ``hyper`` are further hyperparams (``output_heads``, …)."""
    from bio_image_unet_tpu_torch.models import get_model
    from bio_image_unet_tpu_torch.ops.blocks import init_weights_

    hyper = {"model_name": name, "n_filter": n_filter, "in_channels": 1, **hyper}
    net = init_weights_(get_model(name, **hyper), torch.Generator().manual_seed(seed),
                        random_bn_stats=True)
    torch.save({"state_dict": net.state_dict(), "epoch": 0, "best_loss": None, **hyper}, path)


def check_fused_vs_host(name: str, fused: np.ndarray, host: np.ndarray, shape) -> None:
    """The contract the JAX package holds between its fused and host paths
    (``tests/test_predict.py``): host percentiles are float64, so a clip bound
    may move by a code point."""
    if fused.shape != tuple(shape) or fused.dtype != np.uint8:
        raise AssertionError(f"{name}: result {fused.shape} {fused.dtype}, want {shape} uint8")
    diff = np.abs(fused.astype(np.int16) - host.astype(np.int16))
    frac = float(np.mean(diff > 1))
    log(f"[main] {name}: fused vs host max {int(diff.max())} levels, "
        f"{frac:.6f} of pixels beyond 1 level; mask mean {fused.mean():.2f}, "
        f"std {fused.std():.2f}")
    if not (frac < 0.01 and diff.max() <= 16):
        raise AssertionError(f"{name}: fused and host paths disagree (max {diff.max()}, "
                             f"{frac:.4%} beyond one level)")


def phase_main_path(torch, dev, kernels) -> None:
    from bio_image_unet_tpu_torch.predict import Predict
    from bio_image_unet_tpu_torch.predict.predictor import _Engine
    from bio_image_unet_tpu_torch.predict.tiling import grid_starts

    counters = {id(k["_counter"]): k["_counter"] for k in kernels}
    rng = np.random.default_rng(0)
    movie = rng.integers(0, 255, (FRAMES, H, W), dtype=np.uint8)
    movie_u16 = rng.integers(0, 65535, (CHUNK, 1000, 1000), dtype=np.uint16)
    movie_f32 = (rng.standard_normal((CHUNK, H, W)) * 40 + 5).astype(np.float32)
    movie_first = movie[:CHUNK]
    kw = dict(resize_dim=(TILE, TILE), show_progress=False, batch_size=8, half_precision=True)
    cases = [
        ("uint8 64x1024^2 exact (bench.py)", movie, {}),
        ("uint16 16x1000^2 add_tile=1", movie_u16, {"add_tile": 1}),
        ("float32 16x1024^2", movie_f32, {}),
        ("uint8 16x1024^2 'first'", movie_first, {"normalization_mode": "first"}),
    ]
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = str(Path(tmp) / "unet_nf32.pt")
        write_checkpoint(torch, ckpt, "Unet", N_FILTER, out_channels=1)

        # the main path: every launch count is 0 just before, read just after
        for c in counters.values():
            c.launches = 0
        results, times = {}, {}
        for name, imgs, extra in cases:
            reps = 3 if imgs is movie else 1  # warm-up + two timed passes of the bench movie
            best = float("inf")
            for _ in range(reps):
                t0 = time.perf_counter()
                res = Predict(imgs, None, ckpt, **kw, **extra).result
                best = min(best, time.perf_counter() - t0)
            results[name], times[name] = res, best
        launches = {id(c): c.launches for c in counters.values()}
        for k in kernels:
            k["launches"] = launches[id(k["_counter"])]
            if k["launches"] <= 0:
                raise AssertionError(f"{k['name']}: never launched on the main path")
        log("[main] launches: " + ", ".join(f"{k['name']} {k['launches']}" for k in kernels))

        for name, imgs, extra in cases:
            log(f"[main] {name}: {times[name]:.3f} s end to end "
                f"({imgs.shape[0] * imgs.shape[1] * imgs.shape[2] / 1e6 / times[name]:.2f} MP/s)")
            host = Predict(imgs, None, ckpt, device_pipeline=False, **kw, **extra).result
            check_fused_vs_host(name, results[name], host, imgs.shape)
        e2e = FRAMES * H * W / 1e6 / times[cases[0][0]]

        # device-resident: the same chunk program on a movie already on the card
        t0 = time.perf_counter()
        engine = _Engine(ckpt, None, batch_size=8, half_precision=True, device=dev)
        t_engine = time.perf_counter() - t0
        xs, ys = grid_starts(H, TILE, 0), grid_starts(W, TILE, 0)
        device_mps = {}
        for dt_name, m in (("uint8", movie), ("uint16", movie.astype(np.uint16) * 257)):
            fn, n_chunk = engine.fused_runner(H, W, xs, ys, (TILE, TILE), (0.0, 99.8),
                                              n_frames=FRAMES)
            movie_dev = torch.from_numpy(m).to(dev)
            fn(movie_dev[:n_chunk])
            torch.cuda.synchronize()
            best = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                outs = [fn(movie_dev[i:i + n_chunk]) for i in range(0, FRAMES, n_chunk)]
                torch.cuda.synchronize()
                best = min(best, time.perf_counter() - t0)
            device_mps[dt_name] = FRAMES * H * W / 1e6 / best
            if dt_name == "uint8":
                same = np.abs(torch.cat(outs).cpu().numpy().astype(np.int16)
                              - results[cases[0][0]]).max()
                log(f"[main] device-resident uint8 run vs its Predict run: max {same} levels")
                profile_device_resident(torch, fn, movie_dev, n_chunk)
            del movie_dev, outs
        log(f"[main] end-to-end {e2e:.2f} MP/s; device-resident {device_mps['uint8']:.2f} MP/s "
            f"uint8, {device_mps['uint16']:.2f} MP/s uint16; engine set-up (load, fold, "
            f"upload) {t_engine:.3f} s; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

        # a small float32 reference: the card's Predict against the CPU's
        # (plain versions of the kernels, CPU convolutions), TF32 off
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        small = str(Path(tmp) / "unet_nf8.pt")
        write_checkpoint(torch, small, "Unet", 8, seed=1, out_channels=1)
        for add, m in ((0, rng.integers(0, 255, (3, 128, 128), dtype=np.uint8)),
                       (1, rng.integers(0, 65535, (3, 100, 90), dtype=np.uint16))):
            skw = dict(resize_dim=(64, 64), add_tile=add, show_progress=False, batch_size=4)
            on_card = Predict(m, None, small, **skw).result
            on_cpu = Predict(m, None, small, device="cpu", **skw).result
            diff = np.abs(on_card.astype(int) - on_cpu.astype(int))
            log(f"[main] small float32 {m.dtype} add_tile={add}: card vs CPU max {diff.max()} "
                f"levels on {np.mean(diff > 0):.6f} of pixels")
            if diff.max() > 1 or np.mean(diff > 0) > 1e-3:
                raise AssertionError("the card's Predict disagrees with the CPU's")


# kernel-name fragments of each stage of the chunk programs (first match wins)
STAGES = (("k1 clip bounds", ("hist_pass", "finalize")),
          ("k2/k2h/k2v normalize+tile", ("normalize_tile",)),
          ("k3/k3v sigmoid+stitch", ("sigmoid_stitch",)),
          ("k5/k5v weighted stitch", ("margin_stitch", "blend_stitch")),
          ("k5s tile sum", ("tile_sum",)),
          ("upsample (bilinear, trilinear, nearest)", ("upsample",)),
          ("concat", ("catarray",)),
          ("copies (layout, dtype)", ("direct_copy",)),
          ("convolutions", ("conv", "cudnn", "xmma", "gemm", "sm90", "implicit", "cutlass",
                            "fprop", "dgrad")),
          ("max pool", ("max_pool",)))


def profile_device_resident(torch, fn, movie_dev, n_chunk) -> None:
    """One profiled device-resident pass over the bench movie."""
    def run():
        for i in range(0, FRAMES, n_chunk):
            fn(movie_dev[i:i + n_chunk])

    profile_pass(torch, run, "main", f"{FRAMES} frames")


def profile_pass(torch, run, tag: str, what: str) -> None:
    """Profile ``run()``: device time by stage (kernel names) and the
    device's idle share of the pass's wall time.  The profiler's own
    overhead lengthens the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_stage = {name: 0.0 for name, _ in STAGES}
    by_stage["other (elementwise, cat, memset)"] = 0.0
    by_name = {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        dur = ev.time_range.elapsed_us()
        low = ev.name.lower()
        stage = next((name for name, keys in STAGES if any(k in low for k in keys)),
                     "other (elementwise, cat, memset)")
        by_stage[stage] += dur
        total, count = by_name.get(ev.name, (0.0, 0))
        by_name[ev.name] = (total + dur, count + 1)
    busy = sum(by_stage.values())
    if busy == 0:
        log(f"[{tag}] profiler saw no device time: breakdown not measured")
        return
    log(f"[{tag}] device-resident profile ({what}, profiler on): wall {wall_us / 1e3:.2f} ms, "
        f"device busy {busy / 1e3:.2f} ms, idle share {1 - busy / wall_us:.4f}; "
        + ", ".join(f"{k} {v / 1e3:.2f} ms ({v / busy:.1%})" for k, v in by_stage.items() if v))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    for name, (total, count) in top:
        log(f"[{tag}]   {total / 1e3:8.2f} ms {count:5d}x  {name[:110]}")


# --- 5. kernels of the training path ---------------------------------------------

def phase_kernel_augment(torch, dev) -> dict:
    """K4 at the training shapes: 12 of 120 resident 256² tiles, the draws
    the Trainer makes (no Gaussian stage); the pair form with the Gaussian
    stage is checked at the same shapes."""
    from bio_image_unet_tpu_torch.data.augment_device import (augment_apply,
                                                              augment_apply_plain, draw)

    timer = Timer(torch, dev)
    g = torch.Generator(device=dev).manual_seed(0)
    n, b, s = 120, TRAIN_BATCH, TILE
    image = torch.rand((n, 1, s, s), generator=g, device=dev)
    mask = (torch.rand((n, 1, s, s), generator=g, device=dev) > 0.5).float()
    prev = torch.rand((n, 1, s, s), generator=g, device=dev)
    index = torch.randperm(n, generator=g, device=dev)[:b]

    def ulps(a, ref):
        return (a.view(torch.int32).long() - ref.view(torch.int32).long()).abs().max().item()

    d = draw(g, b, (b, 1, s, s))
    ours = augment_apply(image, mask, d, index=index)
    torch.cuda.synchronize()
    ref = augment_apply_plain(image, mask, d, index=index)
    if not torch.equal(ours[1], ref[1]) or ulps(ours[0], ref[0]) > 1:
        raise AssertionError(f"K4: mask equal {torch.equal(ours[1], ref[1])}, image "
                             f"{ulps(ours[0], ref[0])} ulps from the plain version")
    err = (ours[0] - ref[0]).abs().max().item()
    dp = draw(g, b, (b, 1, s, s), prev=True, gauss_sigma=0.04)
    pair = augment_apply(image, mask, dp, index=index, prev=prev)
    torch.cuda.synchronize()
    pref = augment_apply_plain(image, mask, dp, index=index, prev=prev)
    if not torch.equal(pair[1], pref[1]) or max(ulps(pair[0], pref[0]),
                                                ulps(pair[2], pref[2])) > 1:
        raise AssertionError("K4 pair form with Gaussian noise differs from its plain version")

    ms = timer(lambda: augment_apply(image, mask, d, index=index))
    plain_ms = timer(lambda: augment_apply_plain(image, mask, d, index=index), 3)
    flags = d.flags.cpu()
    n_mult = int(((flags[:, 0] != 0) & (flags[:, 5] != 0)).sum())
    plane = s * s * 4
    # least work for this draw: index, flags and coefficients; each gathered
    # image and mask pixel read once; the multiplier field read for the samples
    # whose gate and noise flag are on; each output pixel written once; about
    # six float operations per augmented image pixel
    n_bytes = b * (8 + 7 * 4 + 2 * 4) + 2 * b * plane + n_mult * plane + 2 * b * plane
    bound, by = bound_ms(n_bytes, 6 * b * s * s)
    log(f"[kernels] k4_augment_batch: mask bit-equal, image max_abs_err {err} (<= 1 ulp); "
        f"pair form + Gaussian checked | kernel {ms:.4f} ms | plain {plain_ms:.4f} ms | "
        f"bound {bound:.4f} ms ({by}, {n_bytes / 1e6:.2f} MB) | library none")
    return {"name": "k4_augment_batch", "route": "cuda",
            "source": "bio_image_unet_tpu_torch/csrc/augment_batch.cu",
            "replaces": "bio_image_unet_tpu/data/augment_jax.py:132", "launches": 0,
            "max_abs_err": float(err), "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "library_ms": None, "_counter": augment_apply}


# --- 6. the training path ----------------------------------------------------------

def unet_forward_flops(nf: int, s: int) -> float:
    """Multiply-add FLOPs of one s² tile through ``Unet(n_filter=nf)``: the
    3×3 convs of each level, the 2×2 stride-2 transposed convs and the final
    1×1 conv."""
    def conv(ci, co, hw, k=3):
        return 2 * ci * co * k * k * hw

    f, hw = 0.0, s * s
    widths = [(1, nf), (nf, 2 * nf), (2 * nf, 4 * nf), (4 * nf, 8 * nf), (8 * nf, 16 * nf)]
    for level, (ci, co) in enumerate(widths):
        f += conv(ci, co, hw / 4 ** level) + conv(co, co, hw / 4 ** level)
    for level in range(4, 0, -1):
        ci, co = widths[level][1], widths[level - 1][1]
        f += 2 * ci * co * 4 * hw / 4 ** level  # transposed conv, per input pixel
        f += conv(2 * co, co, hw / 4 ** (level - 1)) + conv(co, co, hw / 4 ** (level - 1))
    return f + 2 * nf * hw


def write_blob_frames(root: Path, n: int, size: int, seed: int) -> tuple:
    """``n`` blob frames and their masks as TIFFs under ``root``/image and
    ``root``/label (the layout ``DataProcess`` reads)."""
    from bio_image_unet_tpu_torch.data import tiff
    from bio_image_unet_tpu_torch.utils.synth import blob_sample

    rng = np.random.default_rng(seed)
    for sub in ("image", "label"):
        (root / sub).mkdir(parents=True)
    for i in range(n):
        img, mask = blob_sample(rng, (size, size), n_blobs=10, margin=16, radius=(8, 20))
        tiff.imwrite(str(root / "image" / f"{i:04d}.tif"), img)
        tiff.imwrite(str(root / "label" / f"{i:04d}.tif"), mask)
    return (str(root / "image") + "/", str(root / "label") + "/")


def phase_train(torch, dev, kernels) -> None:
    from bio_image_unet_tpu_torch import unet

    counters = {id(k["_counter"]): k["_counter"] for k in kernels}
    k4 = kernels[-1]
    # the user's defaults: cuDNN may use TF32 for float32 convolutions
    torch.backends.cudnn.allow_tf32 = True
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        source = write_blob_frames(tmp / "frames", TRAIN_FRAMES, TILE, seed=0)
        data = unet.DataProcess(source, dim_out=(TILE, TILE), aug_factor=None,
                                data_path=str(tmp / "data"), seed=0)
        trainer = unet.Trainer(data, TRAIN_EPOCHS, n_filter=N_FILTER, batch_size=TRAIN_BATCH,
                               lr=TRAIN_LR, save_dir=str(tmp / "run"), seed=0,
                               half_precision=True, device_cache=True, device_augment=True)
        steps = trainer._n_train // TRAIN_BATCH
        log(f"[train] set-up (frames, DataProcess, Trainer, tiles to the card) "
            f"{time.perf_counter() - t0:.2f} s: {len(data)} tiles, {trainer._n_train} "
            f"training, {steps} steps of {TRAIN_BATCH} per epoch")

        # the main path: every launch count is 0 just before, read just after
        for c in counters.values():
            c.launches = 0
        torch.cuda.reset_peak_memory_stats()
        trainer.start()
        torch.cuda.synchronize()
        launches = {id(c): c.launches for c in counters.values()}
        peak = torch.cuda.max_memory_allocated()
        k4["launches"] = launches[id(k4["_counter"])]
        log("[train] launches: " + ", ".join(f"{k['name']} {launches[id(k['_counter'])]}"
                                             for k in kernels))
        if k4["launches"] != steps * TRAIN_EPOCHS:
            raise AssertionError(f"K4 launched {k4['launches']} times in "
                                 f"{steps * TRAIN_EPOCHS} steps")
        hist = trainer.history
        for h in hist:
            log(f"[train] epoch {h['epoch']}: train loss {h['train_loss']:.6f}, val loss "
                f"{h['val_loss']:.6f}, lr {h['lr']:g}, training pass {h['train_seconds']:.3f} s, "
                f"epoch {h['seconds']:.3f} s")
        if not hist[-1]["train_loss"] < hist[0]["train_loss"]:
            raise AssertionError("the training loss did not fall")
        best = min(h["train_seconds"] for h in hist)
        patches = steps * TRAIN_BATCH / best
        flops = 3 * unet_forward_flops(N_FILTER, TILE)
        log(f"[train] {patches:.1f} patches/s (best epoch), step {best / steps * 1e3:.2f} ms; "
            f"peak device memory {peak / 2**30:.2f} GiB; {flops / 1e9:.1f} GFLOP per tile "
            f"forward+backward → {flops * patches / 1e12:.1f} TFLOP/s, "
            f"{flops * patches / PEAK_BF16_FLOPS:.4f} of the bf16 dense peak")

        profile_train_epoch(torch, trainer, TRAIN_EPOCHS, best)
        predict_trained(torch, str(tmp / "run" / "model.pt"), counters)
    train_card_vs_cpu(torch)


def _stage(kernel: str, ancestors) -> str:
    """The training stage a device kernel belongs to, from its name and the
    names of the CPU ranges that launched it."""
    low = kernel.lower()
    for key, stage in (("augment_heads_volume", "K4hv augment heads (volumes)"),
                       ("augment_volume", "K4v augment (volumes)"),
                       ("augment_batch", "K4 augment"), ("augment_heads", "K4h augment heads")):
        if key in low:
            return stage
    if "augment" in ancestors:
        return "augment draws (torch.rand, uniform_, flags)"
    if "upsample" in low:
        return ("upsample backward" if "backward" in low else "upsample forward")
    if "catarray" in low:
        return "concat"
    if any("Optimizer.step" in a for a in ancestors):
        return "Adam"
    if "batch_norm" in low or "batchnorm" in low or "bn_fw" in low or "bn_bw" in low:
        backward = any(k in low for k in ("backward", "bwtr", "bn_bw"))
        return "BatchNorm backward" if backward else "BatchNorm forward"
    for key, stage in (("wgrad", "conv wgrad"), ("dgrad", "conv dgrad"), ("fprop", "conv fprop")):
        if key in low:
            return stage
    if any(k in low for k in ("conv", "cudnn", "xmma", "gemm", "implicit", "cutlass")):
        return "conv (other cuDNN kernels)"
    if "max_pool" in low:
        return "max pool"
    prefix = "autograd::engine::evaluate_function:"
    nodes = [a[len(prefix):].strip() for a in ancestors if a.startswith(prefix)]
    model_nodes = ("Convolution", "BatchNorm", "LeakyRelu", "Cat", "ToCopy", "MaxPool",
                   "AccumulateGrad", "Upsample")
    if "loss" in ancestors or any(not any(m in n for m in model_nodes) for n in nodes):
        return "loss (BCEDice, forward+backward)"
    if "reduce_kernel" in low and any("Convolution" in n for n in nodes):
        return "conv bias gradients (reductions)"
    if "copy" in low:
        return "casts and copies (bf16/float32, layout)"
    return "glue (bias add, LeakyReLU, concat, other elementwise)"


def profile_train_epoch(torch, trainer, epoch: int, unprofiled_s: float,
                        tag: str = "train") -> None:
    """One profiled training epoch (after the timed ones): device time by
    stage and the device's idle share, of the profiled pass's wall time (the
    profiler's own overhead lengthens it) and of ``unprofiled_s``, the best
    unprofiled epoch's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.model.train()
        trainer._iterate_train(epoch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    # device time per kernel name, from the device events; the device copies
    # of record_function ranges ('loss', 'augment', the optimizer step) are
    # spans over other kernels, not work
    by_name = {}
    for ev in events:
        if (ev.device_type != DeviceType.CUDA or getattr(ev, "is_user_annotation", False)
                or ev.name in ("loss", "augment")
                or ev.name.startswith(("Optimizer.", "ProfilerStep"))):
            continue
        total, count = by_name.get(ev.name, (0.0, 0))
        by_name[ev.name] = (total + ev.time_range.elapsed_us(), count + 1)
    # stages: each CPU op's kernels with the op's ancestors; what no op
    # launched (K4, through ctypes) is classified by its name alone
    by_stage, attributed = {}, {}
    for ev in events:
        if ev.device_type != DeviceType.CPU or not ev.kernels:
            continue
        ancestors, p = [], ev
        while p is not None:
            ancestors.append(p.name)
            p = p.cpu_parent
        for k in ev.kernels:
            stage = _stage(k.name, ancestors)
            by_stage[stage] = by_stage.get(stage, 0.0) + k.duration
            attributed[k.name] = attributed.get(k.name, 0.0) + k.duration
    for name, (total, _) in by_name.items():
        rest = total - attributed.get(name, 0.0)
        if rest > 0.5:
            stage = _stage(name, [])
            by_stage[stage] = by_stage.get(stage, 0.0) + rest
    busy = sum(by_stage.values())
    if busy == 0:
        log(f"[{tag}] profiler saw no device time: breakdown not measured")
        return
    n_kernels = sum(count for _, count in by_name.values())
    steps = (trainer._n_train if trainer._device_data is not None
             else len(trainer.train_loader.dataset)) // trainer.batch_size
    log(f"[{tag}] profiled epoch ({epoch}, profiler on): wall {wall_us / 1e3:.2f} ms, device "
        f"busy {busy / 1e3:.2f} ms ({busy / 1e3 / max(steps, 1):.3f} ms a step of {steps}), "
        f"idle share {1 - busy / wall_us:.4f}; against the best "
        f"unprofiled epoch ({unprofiled_s * 1e3:.2f} ms) {1 - busy / (unprofiled_s * 1e6):.4f}; "
        f"{sum(attributed.values()) / 1e3:.2f} ms of it attributed through CPU ops; "
        f"{n_kernels} device kernels")
    for stage, us in sorted(by_stage.items(), key=lambda kv: -kv[1]):
        log(f"[{tag}]   {us / 1e3:9.3f} ms ({us / busy:6.1%})  {stage}")
    for name, (total, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
        log(f"[{tag}]   {total / 1e3:9.3f} ms {count:5d}x  {name[:110]}")
    for label, key in (("K4", "augment_batch<"), ("K4h", "augment_heads<"),
                       ("K4v", "augment_volume<"), ("K4hv", "augment_heads_volume<")):
        hits = [(t, c) for name, (t, c) in by_name.items() if key in name]
        if hits:
            total, count = map(sum, zip(*hits))
            log(f"[{tag}] {label} in the step: {count} launches, {total / count / 1e3:.4f} ms "
                f"device time each (warm L2, profiler on)")


def predict_trained(torch, ckpt: str, counters) -> None:
    """The trained checkpoint through the port's ``Predict`` on a 16-frame
    blob movie of 512²: the mask IoU against the blob truth."""
    from bio_image_unet_tpu_torch.predict import Predict
    from bio_image_unet_tpu_torch.utils.synth import blob_sample

    rng = np.random.default_rng(7)
    frames = [blob_sample(rng, (512, 512), n_blobs=40, margin=16, radius=(8, 20))
              for _ in range(CHUNK)]
    movie = np.stack([f[0] for f in frames])
    truth = np.stack([f[1] for f in frames]) > 0
    before = {id(c): c.launches for c in counters.values()}
    res = Predict(movie, None, ckpt, resize_dim=(TILE, TILE), show_progress=False,
                  half_precision=True).result
    torch.cuda.synchronize()
    if res.shape != movie.shape or res.dtype != np.uint8:
        raise AssertionError(f"Predict on the trained model: {res.shape} {res.dtype}")
    pred = res > 127
    iou = float((pred & truth).sum() / max((pred | truth).sum(), 1))
    ran = [c.__name__ for c in counters.values() if c.launches > before[id(c)]]
    log(f"[train→predict] trained .pt through Predict on 16×512² blobs: mask IoU {iou:.4f} "
        f"(foreground {truth.mean():.4f} of pixels, predicted {pred.mean():.4f}); "
        f"kernels launched: {', '.join(ran)}")


def train_card_vs_cpu(torch) -> None:
    """``Unet(n_filter=8)`` on 15 blob tiles of 64² (12 training: 3 steps of
    4), float32 with TF32 off, no augmentation, one epoch: the card's
    ``metrics.csv`` rows against the CPU's, rtol 1e-3."""
    from bio_image_unet_tpu_torch.train import Trainer
    from bio_image_unet_tpu_torch.utils.synth import blob_sample

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(3)
    items = []
    for _ in range(15):
        img, mask = blob_sample(rng, (64, 64))
        items.append({"image": (img / 255.0).astype(np.float32)[None],
                      "mask": (mask / 255.0).astype(np.float32)[None]})
    rows = {}
    with tempfile.TemporaryDirectory() as tmp:
        for dev in ("cuda", "cpu"):
            t = Trainer(items, 1, n_filter=8, batch_size=4, lr=TRAIN_LR,
                        save_dir=str(Path(tmp) / dev), seed=0, device=dev)
            t.start()
            with open(Path(tmp) / dev / "metrics.csv") as fh:
                rows[dev] = np.array([[float(v) for v in r[1:4]]
                                      for r in list(csv.reader(fh))[1:]])
    rel = np.abs(rows["cuda"] - rows["cpu"]) / np.abs(rows["cpu"])
    log(f"[train] card vs CPU (n_filter=8, 64², float32, TF32 off, 1 epoch): card "
        f"{rows['cuda'].tolist()}, CPU {rows['cpu'].tolist()}, max relative difference "
        f"{rel.max():.2e}")
    if not rel.max() <= 1e-3:
        raise AssertionError("the card's training run disagrees with the CPU's")


# --- 7. kernels of the multi-head path ---------------------------------------------

# benchmarks/family_bench.py's multi-output configuration (MO_HEADS, :43-48)
MO_HEADS = {"mask": {"channels": 1, "activation": "sigmoid"},
            "orientation": {"channels": 2, "activation": None}}
HEADS_FRAMES, HEADS_PATCH, HEADS_MARGIN, HEADS_FILTER = 40, 512, 20, 32
HEADS_CLIP = (0.0, 99.98)  # PredictMultiOutput's default clip_threshold


def phase_kernels_heads(torch, dev) -> list:
    """K2h, K5 and K5s at the shapes of the multi-head path: a 16-frame chunk
    of 1024² uint8 frames in 512² tiles (64 tiles, UNet++'s forward batch of
    16 divides it), bf16 tiles, heads of 1 and 2 channels, margin 20."""
    import torch.nn.functional as F
    from bio_image_unet_tpu_torch.ops import histogram as hist
    from bio_image_unet_tpu_torch.ops.stitch import (margin_stitch, margin_stitch_plain,
                                                      tile_sum, tile_sum_plain)
    from bio_image_unet_tpu_torch.predict.normalize import (normalize_tile_float,
                                                            normalize_tile_plain)
    from bio_image_unet_tpu_torch.predict.tiling import TilePlan, _margin_factors, grid_starts

    timer = Timer(torch, dev)
    g = torch.Generator(device=dev).manual_seed(1)
    P = HEADS_PATCH
    xs, ys = grid_starts(H, P), grid_starts(W, P)
    plan = TilePlan(H, W, P, P, xs, ys, dev,
                    _margin_factors((len(xs), len(ys)), (P, P), HEADS_MARGIN))
    n = CHUNK * plan.per_frame
    rows = []

    def row(*args):
        rows.append(kernel_row("kernels heads", *args))

    x = torch.randint(0, 256, (CHUNK, H, W), generator=g, device=dev,
                      dtype=torch.int32).to(torch.uint8)
    bounds = hist.clip_bounds(x, *HEADS_CLIP)
    ours = normalize_tile_float(x, bounds, plan, n, torch.bfloat16)
    torch.cuda.synchronize()
    ref = normalize_tile_plain(x, bounds, plan, n, False, torch.bfloat16)
    if not torch.equal(ours.view(torch.int16), ref.view(torch.int16)):
        raise AssertionError("K2h: kernel differs from its plain version")
    row("k2h_normalize_tile_float[uint8->bf16]",
        "bio_image_unet_tpu_torch/csrc/normalize_tile.cu",
        "bio_image_unet_tpu/predict/predictor.py:1101", normalize_tile_float,
        (ours.float() - ref.float()).abs().max().item(),
        timer(lambda: normalize_tile_float(x, bounds, plan, n, torch.bfloat16)),
        timer(lambda: normalize_tile_plain(x, bounds, plan, n, False, torch.bfloat16), 3),
        # read each source pixel once, write each bf16 tile pixel once; about
        # five float operations per tile pixel (clip, subtract, divide, scale)
        bound_ms(x.numel() + bounds.numel() * 4 + n * P * P * 2, 5 * n * P * P), None)
    del x, ours, ref

    for c in (1, 2):
        tiles = (torch.rand((n, c, P, P), generator=g, device=dev) * 4 - 2).half()
        for out_dtype, view in ((torch.float16, torch.int16), (torch.float32, torch.int32)):
            ours = margin_stitch(tiles, CHUNK, plan, out_dtype)
            torch.cuda.synchronize()
            ref = margin_stitch_plain(tiles, CHUNK, plan, out_dtype)
            if not torch.equal(ours.view(view), ref.view(view)):
                raise AssertionError(f"K5 c={c} {out_dtype}: kernel differs from plain")
        # the library call: F.fold of the weighted tiles, the weighted sum of
        # this regular (stride = tile) grid; the division and the float16
        # rounding are not in it
        fx, fy = plan.fx_t, plan.fy_t
        wt = torch.stack([torch.minimum(fx[i][:, None], fy[j][None, :])
                          for i in range(plan.nx) for j in range(plan.ny)])
        cols = ((tiles.float().reshape(CHUNK, plan.per_frame, c, P, P) * wt[None, :, None])
                .permute(0, 2, 3, 4, 1).reshape(CHUNK, c * P * P, plan.per_frame).contiguous())
        out_px = CHUNK * c * H * W
        row(f"k5_margin_stitch[c={c}]", "bio_image_unet_tpu_torch/csrc/margin_stitch.cu",
            "bio_image_unet_tpu/ops/stitch.py:163", margin_stitch, 0.0,
            timer(lambda: margin_stitch(tiles, CHUNK, plan, torch.float16)),
            timer(lambda: margin_stitch_plain(tiles, CHUNK, plan, torch.float16), 3),
            # read each real tile value once (float16) and write each output
            # pixel once (float16); per tile value a min, a multiply and two
            # adds, per output pixel a divide
            bound_ms(n * c * P * P * 2 + out_px * 2, 4 * n * c * P * P + out_px),
            timer(lambda: F.fold(cols, (H, W), (P, P), stride=(P, P)), 5))
        del cols, wt
        total = tile_sum(tiles, n)
        torch.cuda.synchronize()
        want = tile_sum_plain(tiles, n)
        count = n * c * P * P
        fill, want_fill = (np.float16(np.float32(v.item() / count)) for v in (total, want))
        ulps = abs(int(fill.view(np.int16)) - int(want_fill.view(np.int16)))
        if ulps > 1:
            raise AssertionError(f"K5s c={c}: fill {fill} vs plain {want_fill} ({ulps} ulps)")
        log(f"[kernels heads] k5s_tile_sum[c={c}]: sum {total.item()!r} vs plain "
            f"{want.item()!r}; fill {fill} vs {want_fill} ({ulps} float16 ulps)")
        row(f"k5s_tile_sum[c={c}]", "bio_image_unet_tpu_torch/csrc/margin_stitch.cu",
            "bio_image_unet_tpu/predict/predictor.py:1133", tile_sum,
            abs(total.item() - want.item()),
            timer(lambda: tile_sum(tiles, n)), timer(lambda: tile_sum_plain(tiles, n), 3),
            # read each real tile value once, one add each
            bound_ms(count * 2, count),
            timer(lambda: torch.sum(tiles, dtype=torch.float64), 5))
        del tiles, ours, ref
    torch.cuda.empty_cache()
    return rows


# --- 8. the multi-head path ------------------------------------------------------

def nested_unet_forward_flops(nf: int, s: int, levels: int = 4, out_channels: int = 3) -> float:
    """Multiply-add FLOPs of one s² tile through ``MultiOutputNestedUNet``:
    the two 3×3 convs of every VGG block of the dense grid (column x_{i,0}
    takes nb[i-1] channels, x_{i,j} takes nb[i]·j + nb[i+1]) and the 1×1
    heads; the bilinear upsampling is not counted."""
    nb = [nf * 2 ** i for i in range(levels + 1)]

    def vgg(ci, co, hw):
        return 2 * 9 * (ci * co + co * co) * hw

    f = 0.0
    for i in range(levels + 1):
        hw = s * s / 4 ** i
        f += vgg(1 if i == 0 else nb[i - 1], nb[i], hw)
        for j in range(1, levels + 1 - i):
            f += vgg(nb[i] * j + nb[i + 1], nb[i], hw)
    return f + 2 * nf * out_channels * s * s


def counted(torch, tag: str, counters, what: str, call, expect: dict):
    """``call()`` with every launch count 0 just before and read just after;
    each kernel must have launched exactly as ``expect`` says (kernels it
    does not name: never)."""
    for c in counters:
        c.launches = 0
    out = call()
    torch.cuda.synchronize()
    got = {c: c.launches for c in counters}
    log(f"[{tag}] launches, {what}: " + ", ".join(f"{c.__name__} {n}" for c, n in got.items()))
    for c, n in got.items():
        if n != expect.get(c, 0):
            raise AssertionError(f"{what}: {c.__name__} launched {n} times, "
                                 f"want {expect.get(c, 0)}")
    return out, got


def check_heads(name: str, res: dict, shape) -> None:
    for head, cfg in MO_HEADS.items():
        want = shape if cfg["channels"] == 1 else (shape[0], cfg["channels"]) + shape[1:]
        r = res[head]
        if r.shape != tuple(want) or r.dtype != np.float32 or not np.isfinite(r).all():
            raise AssertionError(f"{name} {head}: {r.shape} {r.dtype}, want {want} float32 "
                                 "and finite")


def phase_heads(torch, dev, kernels, heads) -> None:
    from bio_image_unet_tpu_torch.ops import histogram as hist
    from bio_image_unet_tpu_torch.ops.stitch import margin_stitch, tile_sum
    from bio_image_unet_tpu_torch.predict import PredictMultiOutput
    from bio_image_unet_tpu_torch.predict.normalize import normalize_tile_float
    from bio_image_unet_tpu_torch.predict.predictor import _Engine
    from bio_image_unet_tpu_torch.predict.tiling import _margin_factors, grid_starts

    torch.backends.cudnn.allow_tf32 = True  # the user's default
    counters = list({id(k["_counter"]): k["_counter"] for k in kernels + heads}.values())
    P = HEADS_PATCH
    rng = np.random.default_rng(2)
    movie = rng.integers(0, 255, (HEADS_FRAMES, H, W), dtype=np.uint8)
    movie_u16 = rng.integers(0, 65535, (CHUNK, 1000, 1000), dtype=np.uint16)
    movie_f32 = (rng.standard_normal((CHUNK, 1000, 500)) * 40 + 5).astype(np.float32)
    kw = dict(max_patch_size=(P, P), half_precision=True, safe_margin=HEADS_MARGIN,
              show_progress=False)
    main = "UNet++ uint8 40x1024^2 exact (family_bench)"
    # the main movie runs in 3 chunks (16 + 16 + a tail of 8); per chunk K1
    # launches a histogram pass per key byte and a finalize (2 for uint8),
    # K2h once, K5 and K5s once per head (the exact grid leaves pixels
    # uncovered, so K5s runs); the host-staged path launches K5 and K5s only
    # (it normalizes and tiles on the host)
    n_chunks, n_heads = -(-HEADS_FRAMES // CHUNK), len(MO_HEADS)
    fused_expect = {hist.int_clip_bounds: 2 * n_chunks, normalize_tile_float: n_chunks,
                    margin_stitch: n_chunks * n_heads, tile_sum: n_chunks * n_heads}
    host_expect = {margin_stitch: n_chunks * n_heads, tile_sum: n_chunks * n_heads}

    def max_diff(a, b) -> dict:
        return {h: float(np.abs(a[h] - b[h]).max()) for h in MO_HEADS}

    def fmt(d: dict) -> str:
        return ", ".join(f"{h} {v:.3e}" for h, v in d.items())

    with tempfile.TemporaryDirectory() as tmp:
        nested = str(Path(tmp) / "nested_nf32.pt")
        write_checkpoint(torch, nested, "MultiOutputNestedUNet", HEADS_FILTER,
                         output_heads=MO_HEADS)
        mo = str(Path(tmp) / "mo_unet_nf32.pt")
        write_checkpoint(torch, mo, "MultiOutputUnet", HEADS_FILTER, seed=1,
                         output_heads=MO_HEADS)

        # the main path, fused: a warm-up call and two timed calls, each
        # counted on its own
        torch.cuda.reset_peak_memory_stats()
        best = float("inf")
        for rep in ("warm-up", "timed 1", "timed 2"):
            t0 = time.perf_counter()
            res, got = counted(torch, "heads", counters, f"{main}, {rep}",
                               lambda: PredictMultiOutput(movie, nested, **kw).result,
                               fused_expect)
            if rep != "warm-up":
                best = min(best, time.perf_counter() - t0)
        results = {main: res}
        peak = torch.cuda.max_memory_allocated()
        check_heads(main, res, movie.shape)
        for k in heads:
            k["launches"] = got[k["_counter"]]
        log(f"[heads] K1 on the multi-head path: {got[hist.int_clip_bounds]} launches "
            "(its JSON entry counts the Predict path)")

        # the main path, host-staged, at the fused path's forward batch (16):
        # the JAX package's fused-vs-host contract, atol 2e-3 on every head
        # and pixel, fill included (at the default batch of 8 cuDNN picks
        # other bf16 algorithms and the heads move by up to 6e-2)
        t0 = time.perf_counter()
        engine = _Engine(nested, None, batch_size=8, half_precision=True, device=dev)
        t_engine = time.perf_counter() - t0
        bs = engine.heads_batch(CHUNK * (H // P) * (W // P), P, P)
        host, _ = counted(torch, "heads", counters, f"{main}, host-staged at batch {bs}",
                          lambda: PredictMultiOutput(movie, nested, device_pipeline=False,
                                                     batch_size=bs, **kw).result,
                          host_expect)
        check_heads(main + " host", host, movie.shape)
        diff = max_diff(res, host)
        log(f"[heads] {main}: {best:.3f} s end to end "
            f"({HEADS_FRAMES * H * W / 1e6 / best:.2f} MP/s); bf16 fused vs host-staged at "
            f"batch {bs}, every pixel: max {fmt(diff)}; "
            + ", ".join(f"{h} mean {res[h].mean():.4f} std {res[h].std():.4f}"
                        for h in MO_HEADS))
        if max(diff.values()) > 2e-3:
            raise AssertionError(f"{main}: fused and host-staged paths differ beyond "
                                 "atol 2e-3")
        del host

        # coverage: the plain trunk on an overlapping grid, a reflect-padded
        # float32 movie with fixed bounds; fused against host-staged logged
        for name, ckpt, imgs, extra in (
                ("MultiOutputUnet uint16 16x1000^2 add_tile=1", mo, movie_u16, {"add_tile": 1}),
                ("UNet++ float32 16x1000x500 'first' (reflect pad)", nested, movie_f32,
                 {"normalization_mode": "first"})):
            t0 = time.perf_counter()
            fused = PredictMultiOutput(imgs, ckpt, **kw, **extra).result
            dt = time.perf_counter() - t0
            check_heads(name, fused, imgs.shape)
            host = PredictMultiOutput(imgs, ckpt, device_pipeline=False, **kw, **extra).result
            check_heads(name + " host", host, imgs.shape)
            log(f"[heads] {name}: {dt:.3f} s end to end "
                f"({imgs.shape[0] * imgs.shape[1] * imgs.shape[2] / 1e6 / dt:.2f} MP/s, one "
                f"call, set-up included); bf16 fused vs host at the default batch max "
                f"{fmt(max_diff(fused, host))}")

        # the fused-vs-host contract in float32 (TF32 off), the precision the
        # JAX package holds it in: the full-width UNet++ on 16 frames
        torch.backends.cudnn.allow_tf32 = False
        f32 = dict(kw, half_precision=False)
        fused = PredictMultiOutput(movie[:CHUNK], nested, **f32).result
        host = PredictMultiOutput(movie[:CHUNK], nested, device_pipeline=False, **f32).result
        diff = max_diff(fused, host)
        log(f"[heads] float32 (TF32 off) UNet++ 16x1024^2: fused vs host max {fmt(diff)}")
        if max(diff.values()) > 2e-3:
            raise AssertionError("float32 fused and host paths differ beyond atol 2e-3")
        torch.backends.cudnn.allow_tf32 = True
        del fused, host

        # device-resident: the same chunk program on a movie already on the card
        xs, ys = grid_starts(H, P), grid_starts(W, P)
        factors = _margin_factors((len(xs), len(ys)), (P, P), HEADS_MARGIN)
        fn, n_chunk, plan = engine.heads_runner(H, W, xs, ys, (P, P), HEADS_CLIP, factors,
                                                n_frames=HEADS_FRAMES)
        movie_dev = torch.from_numpy(movie).to(dev)
        real = [min(n_chunk, HEADS_FRAMES - i) for i in range(0, HEADS_FRAMES, n_chunk)]

        def run():
            outs = []
            for i, k in zip(range(0, HEADS_FRAMES, n_chunk), real):
                chunk = movie_dev[i:i + n_chunk]
                if k < n_chunk:  # the tail chunk repeats its last frame
                    chunk = torch.cat([chunk, chunk[-1:].expand(n_chunk - k, H, W)])
                outs.append(fn(chunk, k))
            return outs

        run()
        torch.cuda.synchronize()
        best_dev = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            outs = run()
            torch.cuda.synchronize()
            best_dev = min(best_dev, time.perf_counter() - t0)
        # the same program as PredictMultiOutput's: the covered pixels of all
        # 40 frames must be equal, and so must the fill made from K5s's sums
        covered = torch.from_numpy(~plan.uncovered).to(dev)
        for h, cfg in MO_HEADS.items():
            c = cfg["channels"]
            ours = torch.cat([o[h][:k] for (o, _), k in zip(outs, real)]).float()
            ref = torch.from_numpy(res[h].reshape(HEADS_FRAMES, c, H, W)).to(dev)
            same = (ours - ref).abs()[..., covered].max().item()
            total = sum(float(sums[h]) for _, sums in outs)
            fill = np.float32(total / (HEADS_FRAMES * plan.per_frame * c * P * P))
            fill = np.float32(fill.astype(np.float16))
            fill_ok = bool((res[h].reshape(HEADS_FRAMES, c, H, W)[:, :, plan.uncovered]
                            == fill).all())
            log(f"[heads] device-resident run vs its PredictMultiOutput run, {h}: covered "
                f"pixels max {same:.3e}; fill {fill!r} {'equal' if fill_ok else 'differs'}")
            if same != 0.0 or not fill_ok:
                raise AssertionError(f"{h}: the device-resident chunk program disagrees with "
                                     "PredictMultiOutput")
            del ours, ref
        profile_pass(torch, run, "heads", f"{HEADS_FRAMES} frames")
        del movie_dev, outs

        mp = HEADS_FRAMES * H * W / 1e6
        e2e, resident = mp / best, mp / best_dev
        tiles_per_mp = len(xs) * len(ys) / (H * W / 1e6)
        flops = nested_unet_forward_flops(HEADS_FILTER, P)
        log(f"[heads] end-to-end {e2e:.2f} MP/s; device-resident {resident:.2f} MP/s; engine "
            f"set-up {t_engine:.3f} s; peak device memory {peak / 2**30:.2f} GiB; "
            f"{flops / 1e9:.1f} GFLOP per {P}² tile → {flops * tiles_per_mp * e2e / 1e12:.1f} "
            f"TFLOP/s end to end ({flops * tiles_per_mp * e2e / PEAK_BF16_FLOPS:.4f} of the "
            f"bf16 dense peak), {flops * tiles_per_mp * resident / 1e12:.1f} TFLOP/s "
            f"device-resident ({flops * tiles_per_mp * resident / PEAK_BF16_FLOPS:.4f})")

        # a small float32 reference: the card's PredictMultiOutput against the
        # CPU's (plain versions of the kernels, CPU convolutions), TF32 off
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        for name, seed, mode, add, m in (
                ("MultiOutputNestedUNet", 3, "single", 0,
                 rng.integers(0, 255, (18, 80, 72), dtype=np.uint8)),
                ("MultiOutputUnet", 4, "all", 1,
                 (rng.standard_normal((3, 100, 90)) * 30).astype(np.float32))):
            small = str(Path(tmp) / f"{name}_nf4.pt")
            write_checkpoint(torch, small, name, 4, seed=seed, output_heads=MO_HEADS)
            skw = dict(max_patch_size=(32, 32), add_tile=add, normalization_mode=mode,
                       safe_margin=4, show_progress=False, batch_size=4)
            on_card = PredictMultiOutput(m, small, **skw).result
            on_cpu = PredictMultiOutput(m, small, device="cpu", **skw).result
            worst = max(float((np.abs(on_card[h] - on_cpu[h])
                               / (1e-3 + 1e-3 * np.abs(on_cpu[h]))).max()) for h in MO_HEADS)
            log(f"[heads] small float32 {name} {m.dtype} '{mode}' add_tile={add}: card vs CPU "
                f"{worst:.3f} of the tolerance 1e-3 + 1e-3·|CPU|")
            if worst > 1.0:
                raise AssertionError("the card's PredictMultiOutput disagrees with the CPU's")



# --- 9. the kernel of the multi-head training path ----------------------------------

# family_bench.py's training heads (MO_HEADS with their losses, :43-48)
MO_TRAIN_HEADS = {"mask": {"channels": 1, "activation": "sigmoid", "loss": "BCEDiceLoss",
                           "weight": 1.0},
                  "orientation": {"channels": 2, "activation": None, "loss": "MSELoss",
                                  "weight": 1.0}}
# 40 frames of 256² at aug_factor 2: 80 tiles, 64 training (16 steps of 4)
MO_FRAMES, MO_BATCH, MO_EPOCHS, MO_LR = 40, 4, 3, 1e-4


def phase_kernel_augment_heads(torch, dev) -> dict:
    """K4h at the multi-output training shapes: 4 of 64 resident 256² tiles,
    image 1 channel, targets mask (1) + orientation (2), the draws the
    Trainer makes; four launches force the 16 (k, flip_h, flip_v) cases
    once each, one of them with a sample gated off."""
    import itertools

    from bio_image_unet_tpu_torch.data.augment_device import (HeadLayout, augment_heads_apply,
                                                              augment_heads_apply_plain, draw)

    timer = Timer(torch, dev)
    g = torch.Generator(device=dev).manual_seed(3)
    n, b, s = 64, MO_BATCH, TILE
    layout = HeadLayout.of({"mask": 1, "orientation": 2}, ("orientation",), dev)
    image = torch.rand((n, 1, s, s), generator=g, device=dev)
    theta = torch.rand((n, 1, s, s), generator=g, device=dev) * 6.2832
    target = torch.cat([(torch.rand((n, 1, s, s), generator=g, device=dev) > 0.5).float(),
                        theta.cos(), theta.sin()], 1).contiguous()
    index = torch.randperm(n, generator=g, device=dev)[:b]

    def ulps(a, ref):
        return (a.view(torch.int32).long() - ref.view(torch.int32).long()).abs().max().item()

    cases = list(itertools.product(range(4), (0, 1), (0, 1)))
    err = 0.0
    for i in range(0, len(cases), b):
        d = draw(g, b, (b, 1, s, s))
        d.flags[:, :4] = torch.tensor([[1, *c] for c in cases[i:i + b]], dtype=torch.int32,
                                      device=dev)
        if i == 0:
            d.flags[0, 0] = 0  # the gate off: the tile passes through
        ours = augment_heads_apply(image, target, layout.codes, d, index=index)
        torch.cuda.synchronize()
        ref = augment_heads_apply_plain(image, target, layout.codes, d, index=index)
        if not torch.equal(ours[1], ref[1]) or ulps(ours[0], ref[0]) > 1:
            raise AssertionError(f"K4h cases {cases[i:i + b]}: targets equal "
                                 f"{torch.equal(ours[1], ref[1])}, image "
                                 f"{ulps(ours[0], ref[0])} ulps from the plain version")
        err = max(err, (ours[0] - ref[0]).abs().max().item())

    d = draw(g, b, (b, 1, s, s))
    ms = timer(lambda: augment_heads_apply(image, target, layout.codes, d, index=index))
    # what the event-timed call above is made of when the host is slower
    # than the kernel: the wrapper's host time (checks, allocation, ctypes
    # call) and the kernel's own device time (profiler, L2 flushed)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        augment_heads_apply(image, target, layout.codes, d, index=index)
    host_ms = (time.perf_counter() - t0) / 200 * 1e3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            timer.flush.fill_(1)
            augment_heads_apply(image, target, layout.codes, d, index=index)
        torch.cuda.synchronize()
    dev_us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA and "augment_heads" in e.name]
    log(f"[kernels heads training] k4h wrapper host time {host_ms:.4f} ms a call; kernel "
        + (f"device time {np.mean(dev_us) / 1e3:.4f} ms ({len(dev_us)} launches, L2 flushed)"
           if dev_us else "device time not measured (the profiler saw no kernel)"))
    plain_ms = timer(lambda: augment_heads_apply_plain(image, target, layout.codes, d,
                                                       index=index), 3)
    flags = d.flags.cpu()
    n_mult = int(((flags[:, 0] != 0) & (flags[:, 5] != 0)).sum())
    n_on = int((flags[:, 0] != 0).sum())
    plane = s * s * 4
    # least work for this draw: index, flags, coefficients and the code
    # table; each gathered image and target pixel read once (1 + 3 planes per
    # sample); the multiplier field for the samples whose gate and noise flag
    # are on; each output pixel written once; about six float operations per
    # augmented image pixel and three per augmented orientation component
    n_bytes = b * (8 + 7 * 4 + 2 * 4) + 3 * 4 + 4 * b * plane + n_mult * plane + 4 * b * plane
    bound, by = bound_ms(n_bytes, (6 + 2 * 3) * n_on * s * s)
    log(f"[kernels heads training] k4h_augment_heads: 16 (k, flip) cases, targets bit-equal, "
        f"image max_abs_err {err} (<= 1 ulp) | kernel {ms:.4f} ms | plain {plain_ms:.4f} ms | "
        f"bound {bound:.4f} ms ({by}, {n_bytes / 1e6:.2f} MB) | library none")
    return {"name": "k4h_augment_heads", "route": "cuda",
            "source": "bio_image_unet_tpu_torch/csrc/augment_batch.cu",
            "replaces": "bio_image_unet_tpu/data/augment_jax.py:192", "launches": 0,
            "max_abs_err": float(err), "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "library_ms": None, "_counter": augment_heads_apply}


# --- 10. the multi-output training path -------------------------------------------

def write_head_frames(root: Path, n: int, size: int, seed: int) -> tuple:
    """``n`` blob frames with their mask and an orientation-angle target
    (the direction of the smoothed mask's gradient, NaN where it is below 1%
    of its largest value) as TIFFs under ``root``/image, /mask,
    /orientation."""
    from scipy import ndimage

    from bio_image_unet_tpu_torch.data import tiff
    from bio_image_unet_tpu_torch.utils.synth import blob_sample

    rng = np.random.default_rng(seed)
    dirs = {k: root / k for k in ("image", "mask", "orientation")}
    for d in dirs.values():
        d.mkdir(parents=True)
    for i in range(n):
        img, mask = blob_sample(rng, (size, size), n_blobs=10, margin=16, radius=(8, 20))
        gy, gx = np.gradient(ndimage.gaussian_filter(mask / 255.0, 8.0))
        angle = (np.arctan2(gy, gx) % (2 * np.pi)).astype(np.float32)
        mag = np.hypot(gy, gx)
        angle[mag < 0.01 * mag.max()] = np.nan
        tiff.imwrite(str(dirs["image"] / f"{i:04d}.tif"), img)
        tiff.imwrite(str(dirs["mask"] / f"{i:04d}.tif"), (mask / 255.0).astype(np.float32))
        tiff.imwrite(str(dirs["orientation"] / f"{i:04d}.tif"), angle)
    return str(dirs["image"]), [str(dirs["mask"]), str(dirs["orientation"])]


def phase_train_heads(torch, dev, kernels) -> None:
    from bio_image_unet_tpu_torch import multi_output_unet

    counters = {id(k["_counter"]): k["_counter"] for k in kernels}
    k4h = kernels[-1]
    torch.backends.cudnn.allow_tf32 = True  # the user's default
    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        image_dir, target_dirs = write_head_frames(tmp / "frames", MO_FRAMES, TILE, seed=4)
        data = multi_output_unet.DataProcess(
            image_dir, target_dirs, {"mask": "mask", "orientation": "mask"},
            data_dir=str(tmp / "data"), dim_out=(TILE, TILE), aug_factor=2, seed=0)
        t_data = time.perf_counter() - t0
        trainer = multi_output_unet.Trainer(
            data, MO_EPOCHS, n_filter=HEADS_FILTER, output_heads=MO_TRAIN_HEADS,
            batch_size=MO_BATCH, lr=MO_LR, save_dir=str(tmp / "run"), seed=0,
            half_precision=True, device_cache=True, device_augment=True)
        steps = trainer._n_train // MO_BATCH
        nan_filled = sum(int((data[i]["orientation"] == 0).all(0).sum()) for i in range(len(data)))
        log(f"[train heads] set-up {time.perf_counter() - t0:.2f} s (frames and DataProcess "
            f"{t_data:.2f} s): {len(data)} tiles, {trainer._n_train} training, {steps} steps "
            f"of {MO_BATCH} per epoch; {nan_filled} orientation pixels NaN-filled")

        # the main path: every launch count is 0 just before, read just after
        for c in counters.values():
            c.launches = 0
        torch.cuda.reset_peak_memory_stats()
        trainer.start()
        torch.cuda.synchronize()
        launches = {id(c): c.launches for c in counters.values()}
        peak = torch.cuda.max_memory_allocated()
        k4h["launches"] = launches[id(k4h["_counter"])]
        log("[train heads] launches: " + ", ".join(
            f"{c.__name__} {launches[id(c)]}" for c in counters.values()))
        for c in counters.values():
            want = steps * MO_EPOCHS if c is k4h["_counter"] else 0
            if launches[id(c)] != want:
                raise AssertionError(f"{c.__name__} launched {launches[id(c)]} times in "
                                     f"{steps * MO_EPOCHS} steps, want {want}")
        hist = trainer.history
        for h in hist:
            log(f"[train heads] epoch {h['epoch']}: train loss {h['train_loss']:.6f}, val loss "
                f"{h['val_loss']:.6f}, lr {h['lr']:g}, training pass {h['train_seconds']:.3f} s, "
                f"epoch {h['seconds']:.3f} s")
        if not hist[-1]["train_loss"] < hist[0]["train_loss"]:
            raise AssertionError("the multi-output training loss did not fall")
        best = min(h["train_seconds"] for h in hist)
        patches = steps * MO_BATCH / best
        flops = 3 * nested_unet_forward_flops(HEADS_FILTER, TILE)
        log(f"[train heads] {patches:.1f} patches/s (best epoch), step {best / steps * 1e3:.2f} "
            f"ms; peak device memory {peak / 2**30:.2f} GiB; {flops / 1e9:.1f} GFLOP per tile "
            f"forward+backward → {flops * patches / 1e12:.1f} TFLOP/s, "
            f"{flops * patches / PEAK_BF16_FLOPS:.4f} of the bf16 dense peak")
        profile_train_epoch(torch, trainer, MO_EPOCHS, best, tag="train heads")

        # deep supervision: one epoch of the 3-level UNet++, then its .pt
        # through PredictMultiOutput
        deep = multi_output_unet.Trainer(
            data, 1, network="MultiOutputNestedUNet_3Levels", n_filter=HEADS_FILTER,
            output_heads=MO_TRAIN_HEADS, deep_supervision=True, batch_size=MO_BATCH, lr=MO_LR,
            save_dir=str(tmp / "deep"), seed=0, half_precision=True, device_cache=True,
            device_augment=True)
        deep.start()
        loss = deep.history[0]["train_loss"]
        if not np.isfinite(loss):
            raise AssertionError(f"deep supervision: training loss {loss}")
        res = predict_heads_trained(torch, str(tmp / "deep" / "model.pt"), frames=2)
        log(f"[train heads] MultiOutputNestedUNet_3Levels, deep supervision, 1 epoch: train "
            f"loss {loss:.6f}, val loss {deep.history[0]['val_loss']:.6f}; its .pt through "
            f"PredictMultiOutput: " + ", ".join(f"{h} {v.shape}" for h, v in res.items()))
        predict_heads_trained(torch, str(tmp / "run" / "model.pt"), frames=CHUNK, iou=True)
    train_heads_card_vs_cpu(torch)


def predict_heads_trained(torch, ckpt: str, frames: int, iou: bool = False) -> dict:
    """A trained multi-output ``.pt`` through ``PredictMultiOutput`` on blob
    frames of 512²: finite heads, the mask in [0, 1]; with ``iou`` the mask
    IoU against the blob truth is printed."""
    from bio_image_unet_tpu_torch.predict import PredictMultiOutput
    from bio_image_unet_tpu_torch.utils.synth import blob_sample

    rng = np.random.default_rng(9)
    pairs = [blob_sample(rng, (512, 512), n_blobs=40, margin=16, radius=(8, 20))
             for _ in range(frames)]
    movie = np.stack([p[0] for p in pairs])
    truth = np.stack([p[1] for p in pairs]) > 0
    t0 = time.perf_counter()
    res = PredictMultiOutput(movie, ckpt, max_patch_size=(TILE, TILE), half_precision=True,
                             show_progress=False).result
    dt = time.perf_counter() - t0
    for head, cfg in MO_TRAIN_HEADS.items():
        r = res[head]
        want = movie.shape if cfg["channels"] == 1 else (frames, cfg["channels"]) + movie.shape[1:]
        if r.shape != want or not np.isfinite(r).all():
            raise AssertionError(f"PredictMultiOutput on the trained model, {head}: {r.shape}, "
                                 f"finite {np.isfinite(r).all()}")
    if not (res["mask"].min() >= 0.0 and res["mask"].max() <= 1.0):
        raise AssertionError("the trained model's mask head leaves [0, 1]")
    if iou:
        pred = res["mask"] > 0.5
        score = float((pred & truth).sum() / max((pred | truth).sum(), 1))
        norm = np.sqrt((res["orientation"] ** 2).sum(1))
        log(f"[train heads→predict] trained .pt through PredictMultiOutput on {frames}×512² "
            f"blobs ({dt:.3f} s): mask IoU {score:.4f} (foreground {truth.mean():.4f} of "
            f"pixels, predicted {pred.mean():.4f}); orientation |(cos, sin)| on the mask "
            f"{norm[truth].mean():.4f}, off it {norm[~truth].mean():.4f}")
    return res


def train_heads_card_vs_cpu(torch) -> None:
    """``MultiOutputNestedUNet(n_filter=4)`` with both heads on 15 tiles of 64²
    (12 training: 3 steps of 4), float32 with TF32 off, resident tiles, no
    augmentation, one epoch: the card's ``metrics.csv`` rows against the
    CPU's, rtol 1e-3 (the bilinear upsample's backward accumulates with
    atomics on the card)."""
    from bio_image_unet_tpu_torch.train import Trainer
    from bio_image_unet_tpu_torch.utils.synth import blob_sample

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[:64, :64]
    items = []
    for _ in range(15):
        img, mask = blob_sample(rng, (64, 64))
        theta = np.arctan2(yy - rng.uniform(0, 64), xx - rng.uniform(0, 64))
        items.append({"image": (img / 255.0).astype(np.float32)[None],
                      "mask": (mask / 255.0).astype(np.float32)[None],
                      "orientation": np.stack([np.cos(theta), np.sin(theta)]).astype(np.float32)})
    rows = {}
    with tempfile.TemporaryDirectory() as tmp:
        for dev in ("cuda", "cpu"):
            t = Trainer(items, 1, network="MultiOutputNestedUNet", n_filter=4,
                        output_heads=MO_TRAIN_HEADS, batch_size=4, lr=MO_LR, grad_clip=1.0,
                        save_dir=str(Path(tmp) / dev), seed=0, device=dev, device_cache=True)
            t.start()
            with open(Path(tmp) / dev / "metrics.csv") as fh:
                rows[dev] = np.array([[float(v) for v in r[1:4]]
                                      for r in list(csv.reader(fh))[1:]])
    rel = np.abs(rows["cuda"] - rows["cpu"]) / np.abs(rows["cpu"])
    log(f"[train heads] card vs CPU (UNet++ n_filter=4, 64², float32, TF32 off, 1 epoch): card "
        f"{rows['cuda'].tolist()}, CPU {rows['cpu'].tolist()}, max relative difference "
        f"{rel.max():.2e}")
    if not rel.max() <= 1e-3:
        raise AssertionError("the card's multi-output training run disagrees with the CPU's")


# --- 11. kernels of the 3D paths ---------------------------------------------------

# benchmarks/family_bench.py's 3D configuration (ours_unet3d, :368-406)
VOL_D, VOL_H, VOL_W, VOL_TILE, VOL_FILTER, VOL_BATCH = 64, 512, 512, (32, 128, 128), 32, 4
VOL_CLIP = (0.0, 99.8)  # Predict3D's default clip_threshold
# PredictMultiOutput3D's defaults (predictor.py:2164-2168) on 2 volumes, with
# the heads of tests/test_quant_families.py:26-27
MO3_HEADS = {"mask": {"channels": 1, "activation": "sigmoid"},
             "vec": {"channels": 2, "activation": None}}
MO3_VOLS, MO3_PATCH, MO3_OVERLAP, MO3_MARGIN, MO3_BATCH = 2, (64, 256, 256), 0.1, 16, 2
MO3_CLIP = (0.0, 99.98)  # PredictMultiOutput3D's default clip_threshold


def vol_grid(tile, add: int = 0) -> list:
    from bio_image_unet_tpu_torch.predict.tiling import grid_starts

    return [grid_starts(e, t, add) for e, t in zip((VOL_D, VOL_H, VOL_W), tile)]


def heads3d_grid() -> tuple:
    """The starts and blend factors of ``PredictMultiOutput3D``'s grid."""
    from bio_image_unet_tpu_torch.predict.tiling import _blend_factors, overlap_starts

    starts = [overlap_starts(e, t, MO3_OVERLAP) for e, t in zip((VOL_D, VOL_H, VOL_W), MO3_PATCH)]
    return starts, _blend_factors([len(s) for s in starts], MO3_PATCH, MO3_MARGIN)


def phase_kernels_3d(torch, dev) -> list:
    """K1 on whole volumes, K2v, K3v and K5v at the 3D paths' shapes."""
    from bio_image_unet_tpu_torch.ops import histogram as hist
    from bio_image_unet_tpu_torch.ops.stitch import (blend_stitch_3d, blend_stitch_3d_plain,
                                                      sigmoid_stitch_3d, sigmoid_stitch_3d_plain)
    from bio_image_unet_tpu_torch.predict.normalize import (normalize_tile_3d,
                                                            normalize_tile_3d_plain)
    from bio_image_unet_tpu_torch.predict.tiling import TilePlan3D

    timer = Timer(torch, dev)
    g = torch.Generator(device=dev).manual_seed(4)
    n_vox = VOL_D * VOL_H * VOL_W
    rows = []

    def row(*args):
        rows.append(kernel_row("kernels 3d", *args))

    # K1 on one whole volume: N = 1 row (the ranks reach 16.7 M, 67 M for uint16)
    for dt, top, n in ((torch.uint8, 256, n_vox), (torch.uint16, 65536, 4 * n_vox)):
        x = torch.randint(0, top, (1, n), generator=g, device=dev, dtype=torch.int32).to(dt)
        ours = hist.int_clip_bounds(x, *VOL_CLIP)
        torch.cuda.synchronize()
        ref = hist.clip_bounds_plain(x, *VOL_CLIP)
        if not torch.equal(ours.view(torch.int32), ref.view(torch.int32)):
            raise AssertionError(f"K1 on a {dt} volume row: {ours.tolist()} != {ref.tolist()}")
        log(f"[kernels 3d] k1_int_clip_bounds, one {dt} row of {n} voxels: bit-equal to plain "
            f"{ours[:, 0].tolist()} | kernel {timer(lambda: hist.int_clip_bounds(x, *VOL_CLIP)):.4f}"
            f" ms | bound {bound_ms(x.numel() * x.element_size(), n)[0]:.4f} ms")
        del x

    # K2v (uint8 mode) and K3v on the Predict3D grid: 32 tiles of (32, 128, 128)
    vol = torch.randint(0, 256, (1, VOL_D, VOL_H, VOL_W), generator=g, device=dev,
                        dtype=torch.int32).to(torch.uint8)
    plan = TilePlan3D(VOL_D, VOL_H, VOL_W, VOL_TILE, *vol_grid(VOL_TILE), dev)
    n = plan.per_volume
    tvox = int(np.prod(VOL_TILE))
    bounds = hist.clip_bounds(vol, *VOL_CLIP)
    ours = normalize_tile_3d(vol, bounds, plan, n)
    torch.cuda.synchronize()
    ref = normalize_tile_3d_plain(vol, bounds, plan, n)
    err = (ours.int() - ref.int()).abs().max().item()
    if err != 0:
        raise AssertionError(f"K2v uint8: kernel differs from plain by {err} levels")
    row("k2v_normalize_tile_3d[uint8]", "bio_image_unet_tpu_torch/csrc/normalize_tile.cu",
        "bio_image_unet_tpu/predict/predictor.py:1222", normalize_tile_3d, err,
        timer(lambda: normalize_tile_3d(vol, bounds, plan, n)),
        timer(lambda: normalize_tile_3d_plain(vol, bounds, plan, n), 3),
        # read each voxel once, write each tile voxel once; about five float
        # operations per tile voxel (clip, subtract, divide, scale)
        bound_ms(vol.numel() + 16 + n * tvox, 5 * n * tvox), None)

    logits = (torch.randn((n, 1) + VOL_TILE, generator=g, device=dev) * 4).to(torch.bfloat16)
    ours = sigmoid_stitch_3d(logits, plan)
    torch.cuda.synchronize()
    ref = sigmoid_stitch_3d_plain(logits, plan)
    err = (ours.int() - ref.int()).abs().max().item()
    if err > 1:
        raise AssertionError(f"K3v: kernel differs from plain by {err} levels")
    row("k3v_sigmoid_stitch_3d", "bio_image_unet_tpu_torch/csrc/sigmoid_stitch.cu",
        "bio_image_unet_tpu/ops/stitch.py:95", sigmoid_stitch_3d, err,
        timer(lambda: sigmoid_stitch_3d(logits, plan)),
        timer(lambda: sigmoid_stitch_3d_plain(logits, plan), 3),
        # read each real logit once (bf16), write each voxel once; about four
        # operations per logit (exp, add, divide, scale) and the sum
        bound_ms(n * tvox * 2 + n_vox, 5 * n * tvox), None)
    # the overlapping grid of add_patch=1 (3 × 5 × 5 tiles): averages
    over = TilePlan3D(VOL_D, VOL_H, VOL_W, VOL_TILE, *vol_grid(VOL_TILE, 1), dev)
    logits = (torch.randn((over.per_volume, 1) + VOL_TILE, generator=g, device=dev) * 4
              ).to(torch.bfloat16)
    ours = sigmoid_stitch_3d(logits, over)
    torch.cuda.synchronize()
    diff = (ours.int() - sigmoid_stitch_3d_plain(logits, over).int()).abs()
    log(f"[kernels 3d] k3v on the add_patch=1 grid ({over.per_volume} tiles): max "
        f"{diff.max().item()} levels on {diff.gt(0).float().mean().item():.2e} of voxels | kernel "
        f"{timer(lambda: sigmoid_stitch_3d(logits, over)):.4f} ms")
    if diff.max().item() > 1:
        raise AssertionError("K3v on the overlapping grid differs from plain by > 1 level")
    del vol, logits, ours, ref, diff

    # K2v (float mode) and K5v on PredictMultiOutput3D's grid: 2 volumes, 18
    # tiles of (64, 256, 256), bf16 tiles, heads of 1 and 2 channels
    starts, factors = heads3d_grid()
    hplan = TilePlan3D(VOL_D, VOL_H, VOL_W, MO3_PATCH, *starts, dev, factors)
    nh = MO3_VOLS * hplan.per_volume
    hvox = int(np.prod(MO3_PATCH))
    vols = torch.randint(0, 256, (MO3_VOLS, VOL_D, VOL_H, VOL_W), generator=g, device=dev,
                         dtype=torch.int32).to(torch.uint8)
    bounds = hist.clip_bounds(vols, *MO3_CLIP)
    ours = normalize_tile_3d(vols, bounds, hplan, nh, False, torch.bfloat16)
    torch.cuda.synchronize()
    ref = normalize_tile_3d_plain(vols, bounds, hplan, nh, False, torch.bfloat16)
    if not torch.equal(ours.view(torch.int16), ref.view(torch.int16)):
        raise AssertionError("K2v bf16: kernel differs from its plain version")
    row("k2v_normalize_tile_3d[uint8->bf16 heads]",
        "bio_image_unet_tpu_torch/csrc/normalize_tile.cu",
        "bio_image_unet_tpu/predict/predictor.py:1324", normalize_tile_3d,
        (ours.float() - ref.float()).abs().max().item(),
        timer(lambda: normalize_tile_3d(vols, bounds, hplan, nh, False, torch.bfloat16)),
        timer(lambda: normalize_tile_3d_plain(vols, bounds, hplan, nh, False, torch.bfloat16), 3),
        bound_ms(vols.numel() + 32 + nh * hvox * 2, 5 * nh * hvox), None)
    del vols, ours, ref

    for c in (1, 2):
        tiles = (torch.rand((nh, c) + MO3_PATCH, generator=g, device=dev) * 4 - 2).half()
        for out_dtype, view in ((torch.float16, torch.int16), (torch.float32, torch.int32)):
            ours = blend_stitch_3d(tiles, MO3_VOLS, hplan, out_dtype)
            torch.cuda.synchronize()
            ref = blend_stitch_3d_plain(tiles, MO3_VOLS, hplan, out_dtype)
            if not torch.equal(ours.view(view), ref.view(view)):
                bad = (ours.view(view) != ref.view(view)).sum().item()
                raise AssertionError(f"K5v c={c} {out_dtype}: {bad} values differ from plain")
            del ours, ref
        out_vox = MO3_VOLS * c * n_vox
        row(f"k5v_blend_stitch_3d[c={c}]", "bio_image_unet_tpu_torch/csrc/margin_stitch.cu",
            "bio_image_unet_tpu/ops/stitch.py:163", blend_stitch_3d, 0.0,
            timer(lambda: blend_stitch_3d(tiles, MO3_VOLS, hplan, torch.float16)),
            timer(lambda: blend_stitch_3d_plain(tiles, MO3_VOLS, hplan, torch.float16), 3),
            # read each real tile value once (float16), write each voxel once
            # (float16); per tile value two mins, a multiply-add and an add,
            # per voxel a divide
            bound_ms(nh * c * hvox * 2 + out_vox * 2, 4 * nh * c * hvox + out_vox), None)
        del tiles
    torch.cuda.empty_cache()
    return rows


# --- 12. the 3D path --------------------------------------------------------------

def unet3d_forward_flops(nf: int, nearest_decoder: bool = False, out_channels: int = 1) -> float:
    """Multiply-add FLOPs per tile voxel through ``UNet3D(n_filter=nf)`` —
    or, with ``nearest_decoder``, ``MultiOutputUnet3D``'s nearest ×2 + conv
    block decoder: the 3×3×3 convs of each level, the decoder's 2×2×2
    stride-2 transposed convs (per input voxel) or ``up<i>_conv`` blocks (at
    the upsampled resolution), the 1×1×1 output convs.  Pools, resampling
    and concats are not counted."""
    def conv(ci, co, frac, taps=27):
        return 2 * ci * co * taps * frac

    h = nf // 2
    f = conv(1, h, 1) + conv(h, nf, 1) + conv(nf, nf, 1 / 8) + conv(nf, 2 * nf, 1 / 8)
    f += conv(2 * nf, 2 * nf, 1 / 64) + conv(2 * nf, 4 * nf, 1 / 64)
    f += conv(4 * nf, 4 * nf, 1 / 512) + conv(4 * nf, 8 * nf, 1 / 512)
    for width, frac in ((8 * nf, 1 / 512), (4 * nf, 1 / 64), (2 * nf, 1 / 8)):
        f += conv(width, width, 8 * frac) if nearest_decoder else conv(width, width, frac, 8)
    f += conv(12 * nf, 4 * nf, 1 / 64) + conv(4 * nf, 4 * nf, 1 / 64)
    f += conv(6 * nf, 2 * nf, 1 / 8) + conv(2 * nf, 2 * nf, 1 / 8)
    f += conv(3 * nf, nf, 1) + conv(nf, h, 1)
    return f + 2 * h * out_channels


def check_u8_volume(tag: str, what: str, ours: np.ndarray, ref: np.ndarray, shape) -> None:
    """The uint8 contract: within one level on at most 0.1% of voxels."""
    if ours.shape != tuple(shape) or ours.dtype != np.uint8 or ref.shape != ours.shape:
        raise AssertionError(f"{what}: {ours.shape} {ours.dtype} vs {ref.shape}, want {shape}")
    diff = np.abs(ours.astype(np.int16) - ref.astype(np.int16))
    frac = float(np.mean(diff > 0))
    log(f"[{tag}] {what}: max {int(diff.max())} levels on {frac:.6f} of voxels; mean "
        f"{ours.mean():.2f}, std {ours.std():.2f}")
    if diff.max() > 1 or frac > 1e-3:
        raise AssertionError(f"{what}: beyond the uint8 contract")


def phase_3d(torch, dev, kernels, k3d) -> None:
    from bio_image_unet_tpu_torch.ops import histogram as hist
    from bio_image_unet_tpu_torch.ops.stitch import sigmoid_stitch_3d
    from bio_image_unet_tpu_torch.predict import Predict3D
    from bio_image_unet_tpu_torch.predict.normalize import normalize_tile_3d
    from bio_image_unet_tpu_torch.predict.predictor import _Engine

    torch.backends.cudnn.allow_tf32 = True  # the user's default
    counters = list({id(k["_counter"]): k["_counter"] for k in kernels + k3d}.values())
    rows = {k["name"]: k for k in k3d}
    shape = (VOL_D, VOL_H, VOL_W)
    rng = np.random.default_rng(10)
    vol = rng.integers(0, 255, shape, dtype=np.uint8)
    vol_u16 = rng.integers(0, 65535, shape, dtype=np.uint16)
    kw = dict(resize_dim=VOL_TILE, show_progress=False, batch_size=VOL_BATCH, half_precision=True)
    main = "UNet3D uint8 64x512^2 (family_bench)"
    # per call: K1's two uint8 launches over the whole volume, K2v once, K3v once
    fused_expect = {hist.int_clip_bounds: 2, normalize_tile_3d: 1, sigmoid_stitch_3d: 1}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = str(Path(tmp) / "unet3d_nf32.pt")
        write_checkpoint(torch, ckpt, "UNet3D", VOL_FILTER, seed=5)
        torch.cuda.reset_peak_memory_stats()
        best = float("inf")
        for rep in ("warm-up", "timed 1", "timed 2"):
            t0 = time.perf_counter()
            res, got = counted(torch, "3d", counters, f"{main}, {rep}",
                               lambda: Predict3D(vol, None, ckpt, **kw).result, fused_expect)
            if rep != "warm-up":
                best = min(best, time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        rows["k2v_normalize_tile_3d[uint8]"]["launches"] = got[normalize_tile_3d]
        rows["k3v_sigmoid_stitch_3d"]["launches"] = got[sigmoid_stitch_3d]

        # host-staged at the fused path's forward batch: the same uint8 tiles
        # up to the host's float64 percentiles, into the same batches
        t0 = time.perf_counter()
        engine = _Engine(ckpt, "UNet3D", batch_size=VOL_BATCH, half_precision=True, device=dev)
        t_engine = time.perf_counter() - t0
        fn, plan, bs = engine.volume_runner(*shape, *vol_grid(VOL_TILE), VOL_TILE, VOL_CLIP)
        host, _ = counted(torch, "3d", counters, f"{main}, host-staged at batch {bs}",
                          lambda: Predict3D(vol, None, ckpt, device_pipeline=False,
                                            **dict(kw, batch_size=bs)).result,
                          {sigmoid_stitch_3d: 1})
        check_u8_volume("3d", f"{main}: fused vs host-staged", res, host, shape)

        # device-resident: the same program on a volume already on the card
        vol_dev = torch.from_numpy(vol).to(dev)
        fn(vol_dev)
        torch.cuda.synchronize()
        best_dev = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            out = fn(vol_dev)
            torch.cuda.synchronize()
            best_dev = min(best_dev, time.perf_counter() - t0)
        same = int(np.abs(out.cpu().numpy().astype(np.int16) - res).max())
        log(f"[3d] device-resident run vs its Predict3D run: max {same} levels")
        if same != 0:
            raise AssertionError("the device-resident program disagrees with Predict3D")
        # two passes: the profiler misses the first launches of its window
        profile_pass(torch, lambda: [fn(vol_dev) for _ in range(2)], "3d",
                     "two passes over one volume")
        del vol_dev, out
        mvox = VOL_D * VOL_H * VOL_W / 1e6
        e2e, resident = mvox / best, mvox / best_dev
        flops = unet3d_forward_flops(VOL_FILTER)
        tile_vox_per_vox = plan.per_volume * np.prod(VOL_TILE) / (mvox * 1e6)
        log(f"[3d] {main}: end-to-end {e2e:.2f} Mvox/s ({best:.3f} s); device-resident "
            f"{resident:.2f} Mvox/s ({best_dev * 1e3:.2f} ms); forward batch {bs}; engine set-up "
            f"{t_engine:.3f} s; peak device memory {peak / 2**30:.2f} GiB; {flops / 1e6:.4f} MFLOP "
            f"per tile voxel ({flops * np.prod(VOL_TILE) / 1e9:.1f} GFLOP per tile) → "
            f"{flops * tile_vox_per_vox * e2e / 1e6:.1f} TFLOP/s end to end "
            f"({flops * tile_vox_per_vox * e2e * 1e6 / PEAK_BF16_FLOPS:.4f} of the bf16 dense "
            f"peak), {flops * tile_vox_per_vox * resident / 1e6:.1f} TFLOP/s device-resident "
            f"({flops * tile_vox_per_vox * resident * 1e6 / PEAK_BF16_FLOPS:.4f})")

        # coverage: the trilinear decoder; uint16 on the add_patch=1 grid
        tri = str(Path(tmp) / "unet3d_trilinear_nf32.pt")
        write_checkpoint(torch, tri, "UNet3D", VOL_FILTER, seed=6, use_interpolation=True)
        for name, path, v, extra in (
                ("UNet3D trilinear uint8 64x512^2", tri, vol, {}),
                ("UNet3D uint16 64x512^2 add_patch=1", ckpt, vol_u16, {"add_patch": 1})):
            t0 = time.perf_counter()
            fused = Predict3D(v, None, path, **kw, **extra).result
            dt = time.perf_counter() - t0
            host = Predict3D(v, None, path, device_pipeline=False, **dict(kw, batch_size=16),
                             **extra).result
            log(f"[3d] {name}: {dt:.3f} s end to end ({mvox / dt:.2f} Mvox/s, one call, set-up "
                "included)")
            check_u8_volume("3d", f"{name}: fused vs host-staged at batch 16", fused, host, shape)

        # a small float32 reference: the card against the CPU, TF32 off
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        small = str(Path(tmp) / "unet3d_nf8.pt")
        for interp, add, v in ((False, 0, rng.integers(0, 255, (16, 64, 64), dtype=np.uint8)),
                               (True, 1, rng.integers(0, 65535, (12, 40, 36), dtype=np.uint16))):
            write_checkpoint(torch, small, "UNet3D", 8, seed=7, use_interpolation=interp)
            skw = dict(resize_dim=(8, 32, 32), add_patch=add, show_progress=False)
            check_u8_volume("3d", f"small float32 {v.dtype} add_patch={add} interp={interp}: "
                            "card vs CPU", Predict3D(v, None, small, **skw).result,
                            Predict3D(v, None, small, device="cpu", **skw).result, v.shape)
        torch.backends.cudnn.allow_tf32 = True


# --- 13. the multi-head 3D path ------------------------------------------------------

def check_heads3d(name: str, res: dict, shape) -> None:
    for head, cfg in MO3_HEADS.items():
        want = shape if cfg["channels"] == 1 else (shape[0], cfg["channels"]) + shape[1:]
        r = res[head]
        if r.shape != tuple(want) or r.dtype != np.float32 or not np.isfinite(r).all():
            raise AssertionError(f"{name} {head}: {r.shape} {r.dtype}, want {want} float32 "
                                 "and finite")


def heads_within(tag: str, what: str, ours: dict, ref: dict) -> None:
    """Every head and voxel within 2e-3 + 1e-3·|ref| (float16 heads)."""
    worst = {h: float((np.abs(ours[h] - ref[h]) / (2e-3 + 1e-3 * np.abs(ref[h]))).max())
             for h in MO3_HEADS}
    log(f"[{tag}] {what}: " + ", ".join(
        f"{h} max {float(np.abs(ours[h] - ref[h]).max()):.3e} (|ref| up to "
        f"{float(np.abs(ref[h]).max()):.3f}; {worst[h]:.3f} of the tolerance)" for h in MO3_HEADS))
    if max(worst.values()) > 1.0:
        raise AssertionError(f"{what}: beyond 2e-3 + 1e-3·|ref|")


def phase_3d_heads(torch, dev, kernels, k3d) -> None:
    from bio_image_unet_tpu_torch.ops import histogram as hist
    from bio_image_unet_tpu_torch.ops.stitch import blend_stitch_3d
    from bio_image_unet_tpu_torch.predict import PredictMultiOutput3D
    from bio_image_unet_tpu_torch.predict.normalize import normalize_tile_3d
    from bio_image_unet_tpu_torch.predict.predictor import _Engine

    torch.backends.cudnn.allow_tf32 = True  # the user's default
    counters = list({id(k["_counter"]): k["_counter"] for k in kernels + k3d}.values())
    rows = {k["name"]: k for k in k3d}
    shape = (MO3_VOLS, VOL_D, VOL_H, VOL_W)
    rng = np.random.default_rng(11)
    vols = rng.integers(0, 255, shape, dtype=np.uint8)
    kw = dict(max_patch_size=MO3_PATCH, overlap_factor=MO3_OVERLAP, blend_margin=MO3_MARGIN,
              batch_size=MO3_BATCH, half_precision=True, show_progress=False)
    main = "MultiOutputUnet3D uint8 2x64x512^2 (class defaults)"
    # per call: K1's two uint8 launches (one row per volume), K2v once, K5v once per head
    expect = {hist.int_clip_bounds: 2, normalize_tile_3d: 1, blend_stitch_3d: len(MO3_HEADS)}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = str(Path(tmp) / "mo_unet3d_nf32.pt")
        write_checkpoint(torch, ckpt, "MultiOutputUnet3D", VOL_FILTER, seed=8,
                            output_heads=MO3_HEADS)
        torch.cuda.reset_peak_memory_stats()
        best = float("inf")
        for rep in ("warm-up", "timed 1", "timed 2"):
            t0 = time.perf_counter()
            res, got = counted(torch, "3d heads", counters, f"{main}, {rep}",
                               lambda: PredictMultiOutput3D(vols, ckpt, **kw).result, expect)
            if rep != "warm-up":
                best = min(best, time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        check_heads3d(main, res, shape)
        rows["k2v_normalize_tile_3d[uint8->bf16 heads]"]["launches"] = got[normalize_tile_3d]
        for c in (1, 2):
            rows[f"k5v_blend_stitch_3d[c={c}]"]["launches"] = got[blend_stitch_3d]

        t0 = time.perf_counter()
        engine = _Engine(ckpt, None, batch_size=MO3_BATCH, half_precision=True, device=dev)
        t_engine = time.perf_counter() - t0
        starts, factors = heads3d_grid()
        fn, plan, bs = engine.heads_3d_runner(*shape, *starts, MO3_PATCH, MO3_CLIP, factors)
        host, _ = counted(torch, "3d heads", counters, f"{main}, host-staged at batch {bs}",
                          lambda: PredictMultiOutput3D(vols, ckpt, device_pipeline=False,
                                                       **dict(kw, batch_size=bs)).result,
                          {blend_stitch_3d: len(MO3_HEADS)})
        check_heads3d(main + " host", host, shape)
        heads_within("3d heads", f"{main}: bf16 fused vs host-staged at batch {bs}", res, host)
        del host

        vols_dev = torch.from_numpy(vols).to(dev)
        fn(vols_dev)
        torch.cuda.synchronize()
        best_dev = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            out = fn(vols_dev)
            torch.cuda.synchronize()
            best_dev = min(best_dev, time.perf_counter() - t0)
        for h, cfg in MO3_HEADS.items():
            ours = out[h].float().cpu().numpy()
            ref = res[h].reshape(ours.shape)
            same = float(np.abs(ours - ref).max())
            log(f"[3d heads] device-resident run vs its PredictMultiOutput3D run, {h}: max {same}")
            if same != 0.0:
                raise AssertionError(f"{h}: the device-resident program disagrees")
        profile_pass(torch, lambda: [fn(vols_dev) for _ in range(2)], "3d heads",
                     f"two passes over {MO3_VOLS} volumes")
        del vols_dev, out
        mvox = MO3_VOLS * VOL_D * VOL_H * VOL_W / 1e6
        e2e, resident = mvox / best, mvox / best_dev
        flops = unet3d_forward_flops(VOL_FILTER, nearest_decoder=True, out_channels=3)
        tile_vox_per_vox = MO3_VOLS * plan.per_volume * np.prod(MO3_PATCH) / (mvox * 1e6)
        log(f"[3d heads] {main}: end-to-end {e2e:.2f} Mvox/s ({best:.3f} s); device-resident "
            f"{resident:.2f} Mvox/s ({best_dev * 1e3:.2f} ms); {plan.per_volume} tiles a volume, "
            f"forward batch {bs}; engine set-up {t_engine:.3f} s; peak device memory "
            f"{peak / 2**30:.2f} GiB; {flops / 1e6:.4f} MFLOP per tile voxel, "
            f"{tile_vox_per_vox:.3f} tile voxels per voxel → "
            f"{flops * tile_vox_per_vox * e2e / 1e6:.1f} TFLOP/s end to end "
            f"({flops * tile_vox_per_vox * e2e * 1e6 / PEAK_BF16_FLOPS:.4f} of the bf16 dense "
            f"peak), {flops * tile_vox_per_vox * resident / 1e6:.1f} TFLOP/s device-resident "
            f"({flops * tile_vox_per_vox * resident * 1e6 / PEAK_BF16_FLOPS:.4f})")

        # a small float32 reference: the card against the CPU, TF32 off
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        small = str(Path(tmp) / "mo_unet3d_nf4.pt")
        for interp, mode, v in (
                (True, "single", rng.integers(0, 255, (2, 12, 40, 36), dtype=np.uint8)),
                (False, "all", (rng.standard_normal((2, 10, 36, 40)) * 30).astype(np.float32))):
            write_checkpoint(torch, small, "MultiOutputUnet3D", 4, seed=9,
                                output_heads=MO3_HEADS, use_interpolation=interp)
            skw = dict(max_patch_size=(8, 32, 32), normalization_mode=mode, blend_margin=4,
                       show_progress=False)
            heads_within("3d heads", f"small float32 {v.dtype} '{mode}' interp={interp}: card vs "
                         "CPU", PredictMultiOutput3D(v, small, **skw).result,
                         PredictMultiOutput3D(v, small, device="cpu", **skw).result)
        torch.backends.cudnn.allow_tf32 = True


# --- 14. kernels of the 3D training paths ------------------------------------------

# benchmarks/family_bench.py's 3D training (ours_unet3d, :408-432): UNet3D(32)
# through the unet3d facade, 40 resident volumes of (16, 64, 64), batch 4, bf16,
# val_split 0, a warm-up epoch and 3 timed ones; K4v on (device_augment)
T3_VOLS, T3_SHAPE, T3_BATCH, T3_EPOCHS = 40, (16, 64, 64), 4, 4
# the multi-output 3D coverage path: MultiOutputUnet3D(32) through its facade,
# 16 resident volumes of (32, 128, 128), batch 2, the heads of [train heads]
T3H_VOLS, T3H_SHAPE, T3H_BATCH, T3H_EPOCHS = 16, (32, 128, 128), 2, 3


def _k4v_bound(flags, b: int, planes_in: int, planes_out: int, vol_bytes: int, n_ops: float):
    """Least work of one K4v / K4hv call on these draws: index, flags and
    coefficients (and the code table); each gathered input channel read
    once; the multiplier field for the samples whose gate and noise flag are
    on; each output channel written once."""
    n_mult = int(((flags[:, 0] != 0) & (flags[:, 5] != 0)).sum())
    n_bytes = (b * (8 + 7 * 4 + 2 * 4) + 3 * 4 + planes_in * b * vol_bytes
               + n_mult * vol_bytes + planes_out * b * vol_bytes)
    return n_bytes, bound_ms(n_bytes, n_ops)


def phase_kernels_3d_training(torch, dev) -> list:
    """K4v at the main path's shapes (4 of 40 resident (1, 16, 64, 64)
    volumes) and K4hv at the coverage path's (2 of 16 resident volumes of
    (32, 128, 128), targets mask + orientation), each against its plain
    version on the same draws with every (k, flip_h, flip_v) case forced
    once and a sample gated off: targets bit-equal, image within one float32
    ulp; timed beside its byte bound."""
    import itertools

    from bio_image_unet_tpu_torch.data.augment_device import (HeadLayout, augment_apply_plain,
                                                              augment_heads_apply_plain,
                                                              augment_heads_volume_apply,
                                                              augment_volume_apply, draw)

    timer = Timer(torch, dev)
    g = torch.Generator(device=dev).manual_seed(12)
    cases = list(itertools.product(range(4), (0, 1), (0, 1)))

    def ulps(a, ref):
        return (a.view(torch.int32).long() - ref.view(torch.int32).long()).abs().max().item()

    def check(name, apply, plain, shape, b, src, tgt, extra):
        err = 0.0
        for i in range(0, len(cases), b):
            d = draw(g, b, (b,) + shape)
            d.flags[:, :4] = torch.tensor([[1, *c] for c in cases[i:i + b]], dtype=torch.int32,
                                          device=dev)
            if i == 0:
                d.flags[0, 0] = 0  # the gate off: the volume passes through
            index = torch.randperm(src.shape[0], generator=g, device=dev)[:b]
            ours = apply(src, tgt, *extra, d, index=index)
            torch.cuda.synchronize()
            ref = plain(src, tgt, *extra, d, index=index)
            if not torch.equal(ours[1], ref[1]) or ulps(ours[0], ref[0]) > 1:
                raise AssertionError(f"{name} cases {cases[i:i + b]}: targets equal "
                                     f"{torch.equal(ours[1], ref[1])}, image "
                                     f"{ulps(ours[0], ref[0])} ulps from the plain version")
            err = max(err, (ours[0] - ref[0]).abs().max().item())
        return err

    rows = []
    # K4v: the main path
    b, shape = T3_BATCH, (1,) + T3_SHAPE
    image = torch.rand((T3_VOLS,) + shape, generator=g, device=dev)
    mask = (torch.rand((T3_VOLS,) + shape, generator=g, device=dev) > 0.5).float()
    err = check("K4v", augment_volume_apply, augment_apply_plain, shape, b, image, mask, ())
    d = draw(g, b, (b,) + shape)
    index = torch.randperm(T3_VOLS, generator=g, device=dev)[:b]
    ms = timer(lambda: augment_volume_apply(image, mask, d, index=index))
    plain_ms = timer(lambda: augment_apply_plain(image, mask, d, index=index), 3)
    vox = int(np.prod(T3_SHAPE))
    n_on = int((d.flags[:, 0] != 0).sum())
    n_bytes, (bound, by) = _k4v_bound(d.flags.cpu(), b, 2, 2, vox * 4, 6 * n_on * vox)
    log(f"[kernels 3d training] k4v_augment_volume: 16 (k, flip) cases, mask bit-equal, image "
        f"max_abs_err {err} (<= 1 ulp) | kernel {ms:.4f} ms | plain {plain_ms:.4f} ms | bound "
        f"{bound:.4f} ms ({by}, {n_bytes / 1e6:.2f} MB) | library none")
    rows.append({"name": "k4v_augment_volume", "route": "cuda",
                 "source": "bio_image_unet_tpu_torch/csrc/augment_batch.cu",
                 "replaces": "bio_image_unet_tpu/data/augment_jax.py:132", "launches": 0,
                 "max_abs_err": float(err), "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                 "bound_by": by, "library_ms": None, "_counter": augment_volume_apply})
    del image, mask

    # K4hv: the multi-output coverage path
    b, shape = T3H_BATCH, (1,) + T3H_SHAPE
    layout = HeadLayout.of({"mask": 1, "orientation": 2}, ("orientation",), dev)
    image = torch.rand((T3H_VOLS,) + shape, generator=g, device=dev)
    theta = torch.rand((T3H_VOLS,) + shape, generator=g, device=dev) * 6.2832
    target = torch.cat([(torch.rand((T3H_VOLS,) + shape, generator=g, device=dev) > 0.5).float(),
                        theta.cos(), theta.sin()], 1).contiguous()
    del theta
    err = check("K4hv", augment_heads_volume_apply, augment_heads_apply_plain, shape, b, image,
                target, (layout.codes,))
    d = draw(g, b, (b,) + shape)
    index = torch.randperm(T3H_VOLS, generator=g, device=dev)[:b]
    ms = timer(lambda: augment_heads_volume_apply(image, target, layout.codes, d, index=index))
    plain_ms = timer(lambda: augment_heads_apply_plain(image, target, layout.codes, d,
                                                       index=index), 3)
    vox = int(np.prod(T3H_SHAPE))
    n_on = int((d.flags[:, 0] != 0).sum())
    n_bytes, (bound, by) = _k4v_bound(d.flags.cpu(), b, 4, 4, vox * 4,
                                      (6 + 2 * 3) * n_on * vox)
    log(f"[kernels 3d training] k4hv_augment_heads_volume: 16 (k, flip) cases, targets "
        f"bit-equal, image max_abs_err {err} (<= 1 ulp) | kernel {ms:.4f} ms | plain "
        f"{plain_ms:.4f} ms | bound {bound:.4f} ms ({by}, {n_bytes / 1e6:.2f} MB) | library none")
    rows.append({"name": "k4hv_augment_heads_volume", "route": "cuda",
                 "source": "bio_image_unet_tpu_torch/csrc/augment_batch.cu",
                 "replaces": "bio_image_unet_tpu/data/augment_jax.py:192", "launches": 0,
                 "max_abs_err": float(err), "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                 "bound_by": by, "library_ms": None, "_counter": augment_heads_volume_apply})
    del image, target
    torch.cuda.empty_cache()
    return rows


# --- 15. the 3D training paths --------------------------------------------------------

class _Items:
    """In-memory training items, dicts of channels-first float32 arrays (the
    form of ``family_bench.py``'s ``Synth3D`` and ``SynthMO``: uniform random
    volumes; here the mask is the volume above 0.5, so the loss has something
    to learn)."""

    def __init__(self, items):
        self.items = items

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def _report_epochs(torch, tag: str, trainer, steps: int, batch: int, flops_per_volume: float,
                   timed) -> float:
    """The per-epoch losses; volumes/s over the best of the ``timed`` epochs
    (``family_bench.py``'s definition, steps·batch over the best training
    pass); the loss must fall.  Returns the best epoch's seconds."""
    hist = trainer.history
    for h in hist:
        log(f"[{tag}] epoch {h['epoch']}: train loss {h['train_loss']:.6f}, val loss "
            f"{h['val_loss']:.6f}, lr {h['lr']:g}, training pass {h['train_seconds']:.3f} s, "
            f"epoch {h['seconds']:.3f} s")
    if not hist[-1]["train_loss"] < hist[0]["train_loss"]:
        raise AssertionError(f"[{tag}] the training loss did not fall")
    best = min(hist[e]["train_seconds"] for e in timed)
    vps = steps * batch / best
    peak = torch.cuda.max_memory_allocated()
    log(f"[{tag}] {vps:.2f} volumes/s (best of epochs {list(timed)}), step "
        f"{best / steps * 1e3:.2f} ms; peak device memory {peak / 2**30:.2f} GiB; "
        f"{flops_per_volume / 1e9:.1f} GFLOP per volume forward+backward → "
        f"{flops_per_volume * vps / 1e12:.1f} TFLOP/s, "
        f"{flops_per_volume * vps / PEAK_BF16_FLOPS:.4f} of the bf16 dense peak")
    return best


def phase_train_3d(torch, dev, kernels) -> None:
    from bio_image_unet_tpu_torch import multi_output_unet3d, unet3d
    from bio_image_unet_tpu_torch.data.augment_device import (augment_heads_volume_apply,
                                                              augment_volume_apply)
    from bio_image_unet_tpu_torch.ops import histogram as hist
    from bio_image_unet_tpu_torch.ops.stitch import blend_stitch_3d, sigmoid_stitch_3d
    from bio_image_unet_tpu_torch.predict import Predict3D, PredictMultiOutput3D
    from bio_image_unet_tpu_torch.predict.normalize import normalize_tile_3d

    counters = list({id(k["_counter"]): k["_counter"] for k in kernels}.values())
    rows = {k["name"]: k for k in kernels}
    torch.backends.cudnn.allow_tf32 = True  # the user's default
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # the main path: family_bench's Synth3D through the unet3d facade
        t0 = time.perf_counter()
        vols = [rng.random((1,) + T3_SHAPE).astype(np.float32) for _ in range(T3_VOLS)]
        data = _Items([{"image": v, "mask": (v > 0.5).astype(np.float32)} for v in vols])
        trainer = unet3d.Trainer(data, T3_EPOCHS, batch_size=T3_BATCH, n_filter=VOL_FILTER,
                                 val_split=0.0, device_cache=True, half_precision=True,
                                 device_augment=True, save_dir=str(tmp / "u3d"), seed=0)
        steps = trainer._n_train // T3_BATCH
        log(f"[train 3d] set-up {time.perf_counter() - t0:.2f} s: UNet3D(n_filter="
            f"{VOL_FILTER}), {trainer._n_train} resident volumes of {T3_SHAPE}, {steps} steps "
            f"of {T3_BATCH} per epoch, time_loss_weight {trainer.time_loss_weight}")
        torch.cuda.reset_peak_memory_stats()
        _, got = counted(torch, "train 3d", counters, f"{T3_EPOCHS} epochs", trainer.start,
                         {augment_volume_apply: steps * T3_EPOCHS})
        rows["k4v_augment_volume"]["launches"] = got[augment_volume_apply]
        flops = 3 * unet3d_forward_flops(VOL_FILTER) * np.prod(T3_SHAPE)
        best = _report_epochs(torch, "train 3d", trainer, steps, T3_BATCH, flops,
                              range(1, T3_EPOCHS))
        profile_train_epoch(torch, trainer, T3_EPOCHS, best, tag="train 3d")
        u3d_ckpt = str(tmp / "u3d" / "model.pt")

        # the coverage path: MultiOutputUnet3D with heads through its facade
        t0 = time.perf_counter()
        yy, xx = np.mgrid[:T3H_SHAPE[1], :T3H_SHAPE[2]]
        items = []
        for _ in range(T3H_VOLS):
            theta = np.broadcast_to(np.arctan2(yy - rng.uniform(0, T3H_SHAPE[1]),
                                               xx - rng.uniform(0, T3H_SHAPE[2])), T3H_SHAPE)
            v = rng.random((1,) + T3H_SHAPE).astype(np.float32)
            items.append({"image": v, "mask": (v > 0.5).astype(np.float32),
                          "orientation": np.stack([np.cos(theta), np.sin(theta)])
                          .astype(np.float32)})
        heads = multi_output_unet3d.Trainer(
            _Items(items), MO_TRAIN_HEADS, T3H_EPOCHS, batch_size=T3H_BATCH, n_filter=VOL_FILTER,
            val_split=0.0, device_cache=True, half_precision=True, device_augment=True,
            save_dir=str(tmp / "mo3d"), seed=0)
        h_steps = heads._n_train // T3H_BATCH
        log(f"[train 3d heads] set-up {time.perf_counter() - t0:.2f} s: MultiOutputUnet3D("
            f"n_filter={VOL_FILTER}, use_interpolation={heads.model.use_interpolation}), heads "
            f"{list(MO_TRAIN_HEADS)} "
            f"({', '.join(type(v).__name__ for v in heads.head_losses.values())}), "
            f"{heads._n_train} resident volumes of {T3H_SHAPE}, {h_steps} steps of {T3H_BATCH}")
        torch.cuda.reset_peak_memory_stats()
        _, got = counted(torch, "train 3d heads", counters, f"{T3H_EPOCHS} epochs", heads.start,
                         {augment_heads_volume_apply: h_steps * T3H_EPOCHS})
        rows["k4hv_augment_heads_volume"]["launches"] = got[augment_heads_volume_apply]
        flops = 3 * unet3d_forward_flops(VOL_FILTER, out_channels=3) * np.prod(T3H_SHAPE)
        best = _report_epochs(torch, "train 3d heads", heads, h_steps, T3H_BATCH, flops,
                              range(T3H_EPOCHS))
        profile_train_epoch(torch, heads, T3H_EPOCHS, best, tag="train 3d heads")
        mo3d_ckpt = str(tmp / "mo3d" / "model.pt")
        del trainer, heads, data, vols, items
        torch.cuda.empty_cache()

        # each trained .pt through the port's 3D Predict classes on the card
        vol = rng.integers(0, 255, (32, 128, 128), dtype=np.uint8)
        res, _ = counted(torch, "train 3d→predict", counters, "UNet3D .pt through Predict3D",
                         lambda: Predict3D(vol, None, u3d_ckpt, resize_dim=T3_SHAPE,
                                           show_progress=False, half_precision=True).result,
                         {hist.int_clip_bounds: 2, normalize_tile_3d: 1, sigmoid_stitch_3d: 1})
        if res.shape != vol.shape or res.dtype != np.uint8:
            raise AssertionError(f"Predict3D on the trained UNet3D: {res.shape} {res.dtype}")
        log(f"[train 3d→predict] Predict3D: {res.shape} uint8, mean {res.mean():.2f}")
        res, _ = counted(torch, "train 3d→predict", counters,
                         "MultiOutputUnet3D .pt through PredictMultiOutput3D",
                         lambda: PredictMultiOutput3D(vol, mo3d_ckpt, max_patch_size=T3H_SHAPE,
                                                      show_progress=False,
                                                      half_precision=True).result,
                         {hist.int_clip_bounds: 2, normalize_tile_3d: 1,
                          blend_stitch_3d: len(MO_TRAIN_HEADS)})
        for head, cfg in MO_TRAIN_HEADS.items():
            want = vol.shape if cfg["channels"] == 1 else (cfg["channels"],) + vol.shape
            if res[head].shape != want or not np.isfinite(res[head]).all():
                raise AssertionError(f"PredictMultiOutput3D on the trained model, {head}: "
                                     f"{res[head].shape}")
        log("[train 3d→predict] PredictMultiOutput3D: " + ", ".join(
            f"{h} {v.shape} in [{v.min():.3f}, {v.max():.3f}]" for h, v in res.items()))
    train_3d_card_vs_cpu(torch)


def train_3d_card_vs_cpu(torch) -> None:
    """``UNet3D(n_filter=4)`` with the facade's temporal loss on 10 volumes of
    (8, 32, 32) (8 training: 2 steps of 4), float32 with TF32 off, resident
    volumes, no augmentation, one epoch: the card's ``metrics.csv`` rows
    against the CPU's, rtol 1e-3."""
    from bio_image_unet_tpu_torch import unet3d

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(6)
    items = _Items([{"volume": rng.random((1, 8, 32, 32)).astype(np.float32),
                     "mask": (rng.random((1, 8, 32, 32)) > 0.6).astype(np.float32)}
                    for _ in range(10)])
    rows, weights = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for dev in ("cuda", "cpu"):
            t = unet3d.Trainer(items, 1, n_filter=4, batch_size=4, lr=1e-4,
                               save_dir=str(Path(tmp) / dev), seed=0, device=dev,
                               device_cache=True)
            if next(t.model.parameters()).device.type != dev:
                raise AssertionError(f"the {dev} run's model is not on {dev}")
            t.start()
            weights[dev] = {k: v.float().cpu() for k, v in t.model.state_dict().items()}
            with open(Path(tmp) / dev / "metrics.csv") as fh:
                rows[dev] = np.array([[float(v) for v in r[1:4]]
                                      for r in list(csv.reader(fh))[1:]])
    rel = np.abs(rows["cuda"] - rows["cpu"]) / np.abs(rows["cpu"])
    dw = max(float((weights["cuda"][k] - v).abs().max()) for k, v in weights["cpu"].items())
    log(f"[train 3d] card vs CPU (UNet3D n_filter=4, (8, 32, 32), float32, TF32 off, 1 epoch): "
        f"card {rows['cuda'].tolist()}, CPU {rows['cpu'].tolist()}, max relative difference "
        f"{rel.max():.2e}; final weights max |card − CPU| {dw:.2e}")
    if not rel.max() <= 1e-3:
        raise AssertionError("the card's 3D training run disagrees with the CPU's")
    torch.backends.cudnn.allow_tf32 = True


if __name__ == "__main__":
    sys.exit(main())
