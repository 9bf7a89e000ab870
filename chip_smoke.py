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
5. the kernels' JSON line, then the last line
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Without CUDA, or outside a checkout of the repository, it exits with code 2.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent

# published peaks of one H100 SXM (NVIDIA's data sheet): HBM3 bandwidth and
# float32 rate outside the tensor cores (the kernels here do scalar work)
PEAK_BYTES_PER_S = 3.35e12
PEAK_SCALAR_OPS_PER_S = 67e12

FRAMES, H, W, TILE, N_FILTER = 64, 1024, 1024, 256, 32
CHUNK = 16
L2_FLUSH_BYTES = 128 << 20


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
    phase_main_path(torch, dev, kernels)
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


if __name__ == "__main__":
    sys.exit(main())
