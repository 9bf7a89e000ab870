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
7. the kernels' JSON line, then the last line
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

    def row(name, source, replaces, counter, err, ms, plain_ms, bound, library_ms):
        b, by = bound
        rows.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": 0, "max_abs_err": float(err), "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b, "bound_by": by, "library_ms": library_ms,
                     "_counter": counter})
        log(f"[kernels] {name}: max_abs_err {err} | kernel {ms:.4f} ms | plain {plain_ms:.4f} ms"
            f" | bound {b:.4f} ms ({by}) | library "
            + ("none" if library_ms is None else f"{library_ms:.4f} ms"))

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

def write_checkpoint(torch, path: str, n_filter: int, seed: int = 0) -> None:
    """A reference-schema ``.pt`` of a ``Unet`` with seeded random weights and
    random BatchNorm statistics (so the BN fold has something to fold)."""
    from bio_image_unet_tpu_torch.models import Unet
    from bio_image_unet_tpu_torch.ops.blocks import init_weights_

    net = init_weights_(Unet(n_filter=n_filter), torch.Generator().manual_seed(seed),
                        random_bn_stats=True)
    torch.save({"state_dict": net.state_dict(), "epoch": 0, "best_loss": None,
                "model_name": "Unet", "n_filter": n_filter, "in_channels": 1,
                "out_channels": 1}, path)


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
        write_checkpoint(torch, ckpt, N_FILTER)

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
        write_checkpoint(torch, small, 8, seed=1)
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


# kernel-name fragments of each stage of the chunk program
STAGES = (("k1 clip bounds", ("hist_pass", "finalize")),
          ("k2 normalize+tile", ("normalize_tile",)),
          ("k3 sigmoid+stitch", ("sigmoid_stitch",)),
          ("convolutions", ("conv", "cudnn", "xmma", "gemm", "sm90", "implicit", "cutlass",
                            "fprop", "dgrad")),
          ("max pool", ("max_pool",)))


def profile_device_resident(torch, fn, movie_dev, n_chunk) -> None:
    """One profiled device-resident pass over the bench movie: device time
    by stage (kernel names) and the device's idle share of the pass's wall
    time.  The profiler's own overhead lengthens the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(0, FRAMES, n_chunk):
            fn(movie_dev[i:i + n_chunk])
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
        log("[main] profiler saw no device time: breakdown not measured")
        return
    log(f"[main] device-resident profile ({FRAMES} frames, profiler on): wall {wall_us / 1e3:.2f} ms, "
        f"device busy {busy / 1e3:.2f} ms, idle share {1 - busy / wall_us:.4f}; "
        + ", ".join(f"{k} {v / 1e3:.2f} ms ({v / busy:.1%})" for k, v in by_stage.items()))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    for name, (total, count) in top:
        log(f"[main]   {total / 1e3:8.2f} ms {count:5d}x  {name[:110]}")


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
    if "augment_batch" in low:
        return "K4 augment"
    if "augment" in ancestors:
        return "augment draws (torch.rand, uniform_, flags)"
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
                   "AccumulateGrad")
    if "loss" in ancestors or any(not any(m in n for m in model_nodes) for n in nodes):
        return "loss (BCEDice, forward+backward)"
    if "reduce_kernel" in low and any("Convolution" in n for n in nodes):
        return "conv bias gradients (reductions)"
    if "copy" in low:
        return "casts and copies (bf16/float32, layout)"
    return "glue (bias add, LeakyReLU, concat, other elementwise)"


def profile_train_epoch(torch, trainer, epoch: int, unprofiled_s: float) -> None:
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
        log("[train] profiler saw no device time: breakdown not measured")
        return
    log(f"[train] profiled epoch ({epoch}, profiler on): wall {wall_us / 1e3:.2f} ms, device "
        f"busy {busy / 1e3:.2f} ms, idle share {1 - busy / wall_us:.4f}; against the best "
        f"unprofiled epoch ({unprofiled_s * 1e3:.2f} ms) {1 - busy / (unprofiled_s * 1e6):.4f}; "
        f"{sum(attributed.values()) / 1e3:.2f} ms of it attributed through CPU ops")
    for stage, us in sorted(by_stage.items(), key=lambda kv: -kv[1]):
        log(f"[train]   {us / 1e3:9.3f} ms ({us / busy:6.1%})  {stage}")
    for name, (total, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
        log(f"[train]   {total / 1e3:9.3f} ms {count:5d}x  {name[:110]}")
    k4 = [(t, c) for name, (t, c) in by_name.items() if "augment_batch" in name]
    if k4:
        total, count = map(sum, zip(*k4))
        log(f"[train] K4 in the step: {count} launches, {total / count / 1e3:.4f} ms device "
            f"time each (warm L2, profiler on)")


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


if __name__ == "__main__":
    sys.exit(main())
