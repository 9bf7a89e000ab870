"""Time the kernels redesigned for Hopper -- K9 (``requant``), K10
(``maxpool_i8``), K11 (``upsample2x_i8``), K6 (``depthwise_xcorr``), K6b
(its two gradients, ``depthwise_xcorr_grad_input`` / ``_kernel``), K11v
(``upsample2x_i8_3d``), K3 (``sigmoid_stitch``, and its C-channel form K3c),
K5 (``margin_stitch``), K5v (``blend_stitch_3d``), K1 (``clip_bounds``, its
Siam chunk and pair rows too) and K2 (``normalize_tile``, and its float mode
K2h) -- and the other stitch and normalize kernels K2v, K2p, K5s and K3v on
the card at the shapes ``chip_smoke.py`` gives them, under two timers, with
the store floors of K11's and K11v's output layouts.  K1 and K2 are timed on
uniform random frames and on frames of microscopy statistics
(``microscopy_frames``: most pixels on a few background levels), in uint8
and in their uint16 and float32 twins.

    python3 <checkout>/bio_image_unet_tpu_torch/utils/kernel_ab_times.py [--package DIR]

Each form's mean time over 10 launches (CUDA events, the 50 MB L2 flushed
before each) is taken twice: ``lead`` spins the device ~0.5 ms after the
flush, so the host has enqueued the launch before the device reaches it and
the time is the device's alone (``chip_smoke.py``'s timer); ``no_lead``
records the start event right after the flush, so a form also holds the
wrapper's host work where that outlasts the flush.  ``--package`` imports
``bio_image_unet_tpu_torch`` from another checkout (by default the one this
file lies in): two versions of the kernels are compared under the same
timers by running this file in turns (A, B, B, A) in one call on one card;
``--forms k6,k10`` times only the forms whose names start so (and builds only
their libraries).  K6, K6b and the forms from K11v on print the sha256 of
their output (``sha256``), K6b and the forms from K11v on drawing their inputs
from a generator seeded per form, so two versions' outputs on the same inputs
can be compared.  The store floor is
the time of 16-byte stores alone into 64 of every 192 bytes of the UNet++ row
buffer (K11's output) and into 64 of every 96 bytes of the 3D concat buffer
(K11v's at up3), the load floor that of 16-byte loads alone of 32 of every
192 bytes (K10's UNet++ input), each against the same bytes contiguous, and
the read floor of K1's 16-frame chunk in each key type (16-byte loads alone),
the read floor of K5s's one-channel chunk (64 float16 tiles of 512², 33.5 MB)
and the store floor of K2v's float mode (18 bf16 tiles of (64, 256, 256),
151 MB, 16-byte stores alone): yardsticks compiled here, not kernels of the
port.  Prints one JSON line; without a card it exits with code 2.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import hashlib
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
HOST_LEAD_CYCLES = 1_000_000  # ~0.5 ms of device spin at the H100's clocks
ITERS = 10
N2D, TILE, NF = 256, 256, 32  # config 1's forward batch, Unet(32)
NNEST, P = 16, 512  # config 4's forward batch of UNet++ tiles
N3D, VOL_TILE = 16, (32, 128, 128)  # config 5's forward batch, UNet3D(32)
CHUNK, FRAME = 16, 1024  # a Predict chunk of 1024^2 frames
VOL = (64, 512, 512)  # config 5's volume
# K6b at chip_smoke.py's XCORR_GRAD_SHAPES: cur (B, C, H, W), the kernel,
# dtype, channels_last
K6B_SHAPES = (((12, 256, 16, 16), (16, 16), "bfloat16", True),
              ((4, 256, 16, 16), (16, 16), "float32", False),
              ((12, 256, 15, 15), (15, 15), "bfloat16", True),
              ((12, 256, 32, 32), (16, 16), "bfloat16", True))

PROBE_CU = r"""
#include <cuda_runtime.h>
#include <stdint.h>
// 16 bytes a thread into bytes [off, off + 16 * cv) of rows of `stride` bytes
__global__ void store16(int8_t* out, long long rows, int cv, int stride, int off) {
  const long long total = rows * cv;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const long long r = e / cv;
    *reinterpret_cast<uint4*>(out + r * stride + off + (e - r * cv) * 16) = make_uint4(1, 2, 3, 4);
  }
}
extern "C" int store16_rows(void* out, long long rows, int cv, int stride, int off, void* st) {
  store16<<<132 * 32, 256, 0, (cudaStream_t)st>>>((int8_t*)out, rows, cv, stride, off);
  return (int)cudaGetLastError();
}
// 16-byte loads of the same bytes, folded into one word a thread (kept)
__global__ void load16(const int8_t* x, long long rows, int cv, int stride, int off,
                       unsigned* sink) {
  const long long total = rows * cv;
  unsigned acc = 0;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const long long r = e / cv;
    const uint4 v = *reinterpret_cast<const uint4*>(x + r * stride + off + (e - r * cv) * 16);
    acc ^= v.x ^ v.y ^ v.z ^ v.w;
  }
  sink[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}
extern "C" int load16_rows(const void* x, long long rows, int cv, int stride, int off, void* sink,
                           void* st) {
  load16<<<132 * 32, 256, 0, (cudaStream_t)st>>>((const int8_t*)x, rows, cv, stride, off,
                                                 (unsigned*)sink);
  return (int)cudaGetLastError();
}
// 16-byte loads of n contiguous 16-byte words, four in flight a thread
__global__ void load16_flat(const uint4* x, long long n, unsigned* sink) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  unsigned acc = 0;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < n; e += 4 * stride) {
    uint4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      v[u] = e + u * stride < n ? __ldg(x + e + u * stride) : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int u = 0; u < 4; ++u) acc ^= v[u].x ^ v[u].y ^ v[u].z ^ v[u].w;
  }
  sink[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}
extern "C" int load16_flat_n(const void* x, long long n, void* sink, void* st) {
  load16_flat<<<132 * 8, 256, 0, (cudaStream_t)st>>>((const uint4*)x, n, (unsigned*)sink);
  return (int)cudaGetLastError();
}
"""


@functools.lru_cache(maxsize=None)
def _probe(_cuda):
    """The probes' library, compiled here: yardsticks, not kernels of the port."""
    _cuda.BUILD.mkdir(parents=True, exist_ok=True)
    src, lib = _cuda.BUILD / "probes.cu", _cuda.BUILD / "libprobes.so"
    src.write_text(PROBE_CU)
    subprocess.run([_cuda._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", str(lib), str(src)], check=True,
                   capture_output=True, timeout=300)
    return ctypes.CDLL(str(lib))


def store_floor(torch, _cuda, timed, rows=NNEST * P * P, width=2 * NF, stride=6 * NF,
                off=NF) -> dict:
    """The store floor of ``width`` bytes at ``off`` of each of ``rows`` rows
    of ``stride`` bytes (by default K11's main-shape output: channels [32, 96)
    of the (16, 512², 192) row buffer), and of the same bytes contiguous."""
    fn = _probe(_cuda).store16_rows
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    out = torch.empty((rows, stride), dtype=torch.int8, device="cuda")

    def run(st, o):
        err = fn(out.data_ptr(), rows, width // 16, st, o, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"store probe: CUDA error {err}")

    return {"slot": timed(lambda: run(stride, off), True),
            "dense": timed(lambda: run(width, 0), True)}


def load_floor(torch, _cuda, timed) -> dict:
    """The load floor of K10's UNet++ input: 16-byte loads alone of channels
    [0, 32) of every pixel of the (16, 512², 192) row buffer, and of the
    same bytes contiguous."""
    fn = _probe(_cuda).load16_rows
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p, ctypes.c_void_p])
    rows, width, stride = NNEST * P * P, NF, 6 * NF
    x = torch.ones((rows, stride), dtype=torch.int8, device="cuda")
    sink = torch.empty(132 * 32 * 256, dtype=torch.int32, device="cuda")

    def run(st):
        err = fn(x.data_ptr(), rows, width // 16, st, 0, sink.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"load probe: CUDA error {err}")

    return {"slot": timed(lambda: run(stride), True), "dense": timed(lambda: run(width), True)}


def microscopy_frames(seed: int, n: int = CHUNK, size: int = FRAME):
    """``n`` uint8 frames of ``size``^2 with microscopy statistics, made by
    ``utils.synth.blob_sample`` from a numpy generator seeded ``seed``: a dark
    background clipped at 0 holds most pixels on a few levels (0 about half
    of them), with 24 bright Gaussian blobs (sigmas 8 to 39 pixels at 1024^2,
    scaled with ``size``); and their twins: uint16 (the
    frames ×16 plus a camera offset of 96, a 12-bit range) and float32 (the
    uint16 frames / 4095)."""
    import numpy as np
    from bio_image_unet_tpu_torch.utils.synth import blob_sample

    rng = np.random.default_rng(seed)
    u8 = np.stack([blob_sample(rng, (size, size), n_blobs=24, margin=min(48, size // 4),
                               radius=(max(2, size // 128), max(3, size // 25)),
                               noise=3.0)[0] for _ in range(n)])
    u16 = (u8.astype(np.uint16) * 16 + 96).astype(np.uint16)
    return u8, u16, u16.astype(np.float32) / np.float32(4095)


def read_floor(torch, _cuda, timed, n_bytes: int) -> float:
    """The read floor of ``n_bytes`` of contiguous device memory (K1's chunk):
    16-byte loads alone, four in flight a thread, L2 flushed before each."""
    fn = _probe(_cuda).load16_flat_n
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
    x = torch.ones(n_bytes, dtype=torch.uint8, device="cuda")
    sink = torch.empty(132 * 8 * 256, dtype=torch.int32, device="cuda")

    def run():
        err = fn(x.data_ptr(), n_bytes // 16, sink.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"load probe: CUDA error {err}")

    return timed(run, True)


def write_floor(torch, _cuda, timed, n_bytes: int) -> float:
    """The store floor of ``n_bytes`` of contiguous device memory (K2v's
    bf16 tiles): 16-byte stores alone, L2 flushed before each."""
    fn = _probe(_cuda).store16_rows
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    out = torch.empty(n_bytes, dtype=torch.uint8, device="cuda")

    def run():
        err = fn(out.data_ptr(), n_bytes // 16, 1, 16, 0, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"store probe: CUDA error {err}")

    return timed(run, True)


def sha(torch, t) -> str:
    """The sha256 of a tensor's bytes (first 16 hex digits)."""
    return hashlib.sha256(t.contiguous().reshape(-1).view(torch.uint8).cpu().numpy().tobytes()
                          ).hexdigest()[:16]


def stitch_forms(torch, dev, both, pkg) -> None:
    """K11v at up1–up3, K3's four forms, and K1, K2, K5, K5v, K3v at
    ``chip_smoke.py``'s row shapes; each form's inputs from its own seeded
    generator, its output hashed."""
    k8, hist, stitch, normalize, tiling = pkg

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    # K11v: the trilinear UNet3D(32) decoder's x2 into its concat buffer
    for seed, (name, shift, c) in enumerate((("up1", 3, 8 * NF), ("up2", 2, 4 * NF),
                                             ("up3", 1, 2 * NF))):
        d, h, w = (t >> shift for t in VOL_TILE)
        g = gen(100 + seed)
        x = torch.randint(-128, 128, (N3D, d, h, w, c), generator=g, device=dev,
                          dtype=torch.int32).to(torch.int8)
        buf = torch.zeros((N3D, 2 * d, 2 * h, 2 * w, 3 * c // 2), dtype=torch.int8, device=dev)
        both(f"k11v {name} ({N3D}, {d}x{h}x{w}, {c}) -> {c} of {3 * c // 2}",
             lambda: k8.upsample2x_i8_3d(x, out=buf), buf)
        del x, buf
    torch.cuda.empty_cache()

    # K3: exact bf16, overlapping bf16 (uint16 1000^2, add_tile=1), a Siam
    # chunk and the float32 exact grid at Predict's defaults (512^2 tiles)
    for seed, (name, n_frames, side, tile, add, dtype) in enumerate((
            ("exact bf16 (256, 256^2) -> (16, 1024^2)", CHUNK, FRAME, 256, 0, torch.bfloat16),
            ("overlap bf16 (400, 256^2) -> (16, 1000^2)", CHUNK, 1000, 256, 1, torch.bfloat16),
            ("siam chunk bf16 (128, 256^2) -> (8, 1024^2)", 8, FRAME, 256, 0, torch.bfloat16),
            ("exact float32 (64, 512^2) -> (16, 1024^2)", CHUNK, FRAME, 512, 0, torch.float32))):
        starts = tiling.grid_starts(side, tile, add)
        plan = tiling.TilePlan(side, side, tile, tile, starts, starts, dev)
        g = gen(200 + seed)
        logits = (torch.randn((n_frames * plan.per_frame, 1, tile, tile), generator=g, device=dev)
                  * 4).to(dtype)
        both(f"k3 {name}", lambda: stitch.sigmoid_stitch(logits, n_frames, plan), True)
        del logits
    torch.cuda.empty_cache()

    # K3c: K3 over C channels (Predict of a Unet with out_channels C > 1), at
    # chip_smoke.py's [kernels multichannel] shapes
    for seed, (name, side, tile, add, dtype, c) in enumerate((
            ("c2 exact bf16 (256, 2, 256^2) -> (16, 2, 1024^2)", FRAME, 256, 0, torch.bfloat16, 2),
            ("c2 overlap bf16 (400, 2, 256^2) -> (16, 2, 1000^2)", 1000, 256, 1, torch.bfloat16,
             2),
            ("c2 exact float32 (64, 2, 512^2) -> (16, 2, 1024^2)", FRAME, 512, 0, torch.float32,
             2),
            ("c3 exact bf16 (256, 3, 256^2) -> (16, 3, 1024^2)", FRAME, 256, 0, torch.bfloat16,
             3))):
        starts = tiling.grid_starts(side, tile, add)
        plan = tiling.TilePlan(side, side, tile, tile, starts, starts, dev)
        g = gen(400 + seed)
        logits = (torch.randn((CHUNK * plan.per_frame, c, tile, tile), generator=g, device=dev)
                  * 4).to(dtype)
        both(f"k3c {name}", lambda: stitch.sigmoid_stitch(logits, CHUNK, plan), True)
        del logits
    torch.cuda.empty_cache()

    # K1 / K1f: a 16-frame chunk of 1024^2 frames, uniform random and of
    # microscopy statistics (microscopy_frames), each in uint8, uint16, float32
    qs = (0.0, 99.8)
    g = gen(300)
    uniform = (torch.randint(0, 256, (CHUNK, FRAME, FRAME), generator=g, device=dev,
                             dtype=torch.int32).to(torch.uint8),
               torch.randint(0, 65536, (CHUNK, FRAME, FRAME), generator=g, device=dev,
                             dtype=torch.int32).to(torch.uint16),
               torch.randn((CHUNK, FRAME, FRAME), generator=g, device=dev) * 40 + 5)
    skewed = tuple(torch.from_numpy(m).to(dev) for m in microscopy_frames(301))
    for kind, movies in (("", uniform), ("skewed ", skewed)):
        for dt, x in zip(("uint8", "uint16", "float32"), movies):
            fn = hist.float_clip_bounds if dt == "float32" else hist.int_clip_bounds
            both(f"k1 {kind}{dt} (16, 1024^2)", lambda: fn(x, *qs), True)
            if dt == "float32":
                continue
            # K2 on the exact grid (uint8) and the gather grid (uint16 1000^2, add_tile=1)
            frames, side, add = (x, FRAME, 0) if dt == "uint8" else (
                x[:, :1000, :1000].contiguous(), 1000, 1)
            starts = tiling.grid_starts(side, 256, add)
            plan = tiling.TilePlan(side, side, 256, 256, starts, starts, dev)
            n = CHUNK * plan.per_frame
            n_pad = -(-n // max(8, min(n, (1 << 24) // (256 * 256)))) * max(
                8, min(n, (1 << 24) // (256 * 256)))
            bounds = hist.clip_bounds(frames, *qs)
            both(f"k2 {kind}{'exact' if add == 0 else 'gather'} {dt} -> ({n_pad}, 256^2)",
                 lambda: normalize.normalize_tile(frames, bounds, plan, n_pad, False), True)
    del uniform, skewed
    torch.cuda.empty_cache()

    # K5 and K5s: one head's float16 tiles of a 16-frame chunk in 512^2
    # tiles, margin 20, float16 out (the fused path) and float32 (the
    # host-staged path); K5 also on 1000x1003 frames (column starts 0 and
    # 491) and on a view at an odd float16 offset
    starts = tiling.grid_starts(FRAME, 512)
    plan = tiling.TilePlan(FRAME, FRAME, 512, 512, starts, starts, dev,
                           tiling._margin_factors((len(starts), len(starts)), (512, 512), 20))
    g = gen(400)
    for c in (1, 2):
        tiles = (torch.rand((CHUNK * plan.per_frame, c, 512, 512), generator=g, device=dev) * 4
                 - 2).half()
        for out_dtype, out_name in ((torch.float16, "f16"), (torch.float32, "f32")):
            both(f"k5 c={c} {out_name} (64, {c}, 512^2) -> (16, {c}, 1024^2)",
                 lambda: stitch.margin_stitch(tiles, CHUNK, plan, out_dtype), True)
        both(f"k5s c={c} (64, {c}, 512^2) -> f64",
             lambda: stitch.tile_sum(tiles, CHUNK * plan.per_frame), True)
        if c == 1:
            view = offset_view(torch, tiles, 1)
            both("k5 c=1 f16 odd-offset view (64, 1, 512^2) -> (16, 1, 1024^2)",
                 lambda: stitch.margin_stitch(view, CHUNK, plan, torch.float16), True)
            del view
        del tiles
    xs, ys = tiling.grid_starts(1000, 512), tiling.grid_starts(1003, 512)
    oplan = tiling.TilePlan(1000, 1003, 512, 512, xs, ys, dev,
                            tiling._margin_factors((len(xs), len(ys)), (512, 512), 20))
    tiles = (torch.rand((CHUNK * oplan.per_frame, 1, 512, 512), generator=g, device=dev) * 4
             - 2).half()
    both("k5 c=1 f16 starts 0, 491 (64, 1, 512^2) -> (16, 1, 1000x1003)",
         lambda: stitch.margin_stitch(tiles, CHUNK, oplan, torch.float16), True)
    del tiles

    # K3v on Predict3D's grid (32 tiles of (32, 128, 128)) and K5v on
    # PredictMultiOutput3D's (2 volumes, 18 tiles of (64, 256, 256))
    plan = tiling.TilePlan3D(*VOL, VOL_TILE,
                             *[tiling.grid_starts(e, t) for e, t in zip(VOL, VOL_TILE)], dev)
    g = gen(500)
    logits = (torch.randn((plan.per_volume, 1) + VOL_TILE, generator=g, device=dev) * 4
              ).to(torch.bfloat16)
    both("k3v bf16 (32, 32x128^2) -> (64, 512^2)",
         lambda: stitch.sigmoid_stitch_3d(logits, plan), True)
    del logits
    patch = (64, 256, 256)
    starts = [tiling.overlap_starts(e, t, 0.1) for e, t in zip(VOL, patch)]
    hplan = tiling.TilePlan3D(*VOL, patch, *starts, dev,
                              tiling._blend_factors([len(s) for s in starts], patch, 16))
    for c in (1, 2):
        tiles = (torch.rand((2 * hplan.per_volume, c) + patch, generator=g, device=dev) * 4
                 - 2).half()
        for out_dtype, out_name in ((torch.float16, "f16"), (torch.float32, "f32")):
            both(f"k5v c={c} {out_name} (18, {c}, 64x256^2) -> (2, {c}, 64, 512^2)",
                 lambda: stitch.blend_stitch_3d(tiles, 2, hplan, out_dtype), True)
        if c == 1:
            view = offset_view(torch, tiles, 1)
            both("k5v c=1 f16 odd-offset view (18, 1, 64x256^2) -> (2, 1, 64, 512^2)",
                 lambda: stitch.blend_stitch_3d(view, 2, hplan, torch.float16), True)
            del view
        del tiles
    torch.cuda.empty_cache()


def normalize_forms(torch, dev, both, pkg, prefixes) -> None:
    """K1 on a Siam chunk and its pair rows, K2h, K2v (both rows) and K2p at
    ``chip_smoke.py``'s row shapes, on device time (their PERF.md rows from
    PR 3-7 held host work); each form's inputs from its own seeded
    generator, its output hashed."""
    _, hist, _, normalize, tiling = pkg

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def u8(shape, g):
        return torch.randint(0, 256, shape, generator=g, device=dev,
                             dtype=torch.int32).to(torch.uint8)

    # a Siam chunk: the (9, 1024^2) block of 8 frames and the next one
    block = u8((9, FRAME, FRAME), gen(600))
    clip = (0.0, 99.98)
    both("k1 siam chunk uint8 (9, 1024^2)", lambda: hist.int_clip_bounds(block, *clip), True)
    both("k1 pair rows uint8 (9, 1024^2) -> 8 rows",
         lambda: hist.pair_clip_bounds(block, *clip), True)
    if "k2p " in prefixes:
        plan = tiling.TilePlan(FRAME, FRAME, 256, 256, tiling.grid_starts(FRAME, 256),
                               tiling.grid_starts(FRAME, 256), dev)
        bounds = hist.clip_bounds(block, *clip)
        both("k2p uint8 (9, 1024^2) -> 2x(128, 256^2)",
             lambda: normalize.normalize_tile_pairs(block, bounds, plan, 8 * plan.per_frame,
                                                    False), True)
    del block

    if not {"k2h ", "k2v "} & set(prefixes):
        return
    # K2h: the multi-head chunk, 16 frames of 1024^2 in 512^2 tiles, bf16
    x = u8((CHUNK, FRAME, FRAME), gen(601))
    starts = tiling.grid_starts(FRAME, 512)
    plan = tiling.TilePlan(FRAME, FRAME, 512, 512, starts, starts, dev,
                           tiling._margin_factors((len(starts), len(starts)), (512, 512), 20))
    bounds = hist.clip_bounds(x, *clip)
    both("k2h uint8 (16, 1024^2) -> (64, 512^2) bf16",
         lambda: normalize.normalize_tile_float(x, bounds, plan, CHUNK * plan.per_frame,
                                                torch.bfloat16), True)
    del x

    # K2v: Predict3D's volume in (32, 128, 128) tiles, and the two volumes of
    # PredictMultiOutput3D in (64, 256, 256) tiles, bf16
    vol = u8((1,) + VOL, gen(602))
    plan = tiling.TilePlan3D(*VOL, VOL_TILE,
                             *[tiling.grid_starts(e, t) for e, t in zip(VOL, VOL_TILE)], dev)
    bounds = hist.clip_bounds(vol, 0.0, 99.8)
    both("k2v uint8 (1, 64, 512^2) -> (32, 32x128^2)",
         lambda: normalize.normalize_tile_3d(vol, bounds, plan, plan.per_volume), True)
    vols = u8((2,) + VOL, gen(603))
    patch = (64, 256, 256)
    starts = [tiling.overlap_starts(e, t, 0.1) for e, t in zip(VOL, patch)]
    hplan = tiling.TilePlan3D(*VOL, patch, *starts, dev,
                              tiling._blend_factors([len(s) for s in starts], patch, 16))
    bounds = hist.clip_bounds(vols, *clip)
    both("k2v heads uint8 (2, 64, 512^2) -> (18, 64x256^2) bf16",
         lambda: normalize.normalize_tile_3d(vols, bounds, hplan, 2 * hplan.per_volume, False,
                                             torch.bfloat16), True)
    del vol, vols
    torch.cuda.empty_cache()


def xcorr_grad_forms(torch, dev, both, depthwise_xcorr_grad_input,
                     depthwise_xcorr_grad_kernel) -> None:
    """K6b's grad input and grad kernel at ``K6B_SHAPES``, each shape's
    operands from its own seeded generator, each output hashed."""
    for seed, (shape, kernel, dtype_name, cl) in enumerate(K6B_SHAPES):
        g = torch.Generator(device=dev).manual_seed(700 + seed)
        dtype = getattr(torch, dtype_name)
        cur, grad = (torch.randn(shape, generator=g, device=dev).to(dtype) for _ in range(2))
        prev = torch.randn(shape[:2] + kernel, generator=g, device=dev).to(dtype)
        if cl:
            cur, grad, prev = (t.contiguous(memory_format=torch.channels_last)
                               for t in (cur, grad, prev))
        name = (f"{dtype_name}{' channels_last' if cl else ''} {shape} "
                f"k{kernel[0]}x{kernel[1]}")
        both(f"k6b in {name}", lambda: depthwise_xcorr_grad_input(grad, prev), True)
        both(f"k6b kernel {name}", lambda: depthwise_xcorr_grad_kernel(grad, cur, kernel), True)
        del cur, grad, prev
    torch.cuda.empty_cache()


def offset_view(torch, t, offset: int):
    """A contiguous copy of ``t`` that starts ``offset`` elements into its
    buffer (1: an odd float16 offset, 2 bytes past a 4-byte boundary)."""
    buf = torch.empty(offset + t.numel(), dtype=t.dtype, device=t.device)
    view = buf[offset:].view(t.shape)
    view.copy_(t)
    return view


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", type=Path, default=ROOT,
                    help="checkout whose bio_image_unet_tpu_torch is timed")
    ap.add_argument("--forms",
                    default="k9,k10,k11,k6,k6b,k11v,k3,k3c,k1,k2,k5,k5v,k3v,k5s,k2h,k2v,k2p",
                    help="comma-separated prefixes of the forms to time (default: all)")
    args = ap.parse_args()
    prefixes = tuple(f"{p.strip()} " for p in args.forms.split(",") if p.strip())
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab_times: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.package.resolve()))
    from bio_image_unet_tpu_torch.ops import _cuda
    from bio_image_unet_tpu_torch.ops import histogram as hist
    from bio_image_unet_tpu_torch.ops import int8 as k8
    from bio_image_unet_tpu_torch.ops import stitch
    from bio_image_unet_tpu_torch.ops.functional import (depthwise_xcorr,
                                                         depthwise_xcorr_grad_input,
                                                         depthwise_xcorr_grad_kernel)
    from bio_image_unet_tpu_torch.predict import normalize, tiling

    libs = {"k9 ": "int8_trunk", "k10 ": "int8_trunk", "k11 ": "int8_resample",
            "k6 ": "depthwise_xcorr", "k6b ": "depthwise_xcorr", "k11v ": "int8_resample",
            "k3 ": "sigmoid_stitch",
            "k3c ": "sigmoid_stitch",
            "k1 ": "clip_bounds", "k2 ": "normalize_tile", "k5 ": "margin_stitch",
            "k5v ": "margin_stitch", "k3v ": "sigmoid_stitch", "k5s ": "margin_stitch",
            "k2h ": "normalize_tile", "k2v ": "normalize_tile", "k2p ": "normalize_tile"}
    _cuda.build(sorted({lib for form, lib in libs.items() if form in prefixes}))
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)

    def timed(fn, lead):
        fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(ITERS):
            flush.fill_(1)
            if lead:
                torch.cuda._sleep(HOST_LEAD_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / ITERS

    def i8(shape):
        return torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8)

    def bf16(shape):
        return (torch.randn(shape, generator=g, device=dev) * 2).to(torch.bfloat16)

    ms = {}

    def both(name, fn, hashed=None):
        """Time form ``name``; ``hashed``: the tensor to hash after one call
        (True: the call's result), None: no hash."""
        if not name.startswith(prefixes):
            return
        ms[name] = {"lead": timed(fn, True), "no_lead": timed(fn, False)}
        if hashed is not None:
            result = fn()
            torch.cuda.synchronize()
            ms[name]["sha256"] = sha(torch, result if hashed is True else hashed)

    # K9, 2D: chip_smoke.py's [kernels int8] forms
    shape = (N2D, TILE, TILE, NF)
    e1, skip, cat = bf16(shape), i8(shape), i8(shape[:-1] + (2 * NF,))
    buf = torch.zeros(shape[:-1] + (2 * NF,), dtype=torch.int8, device=dev)
    attended = torch.randn(shape, generator=g, device=dev) * 2
    both("k9 e1 bf16 -> int8", lambda: k8.requant(e1, 1.0, 0.05))
    both("k9 skip -> concat [C, 2C)", lambda: k8.requant(skip, 0.031, 0.037, out=buf, offset=NF))
    both("k9 dequant -> bf16", lambda: k8.requant(skip, 0.031))
    both("k9 attention strided dequant", lambda: k8.requant(cat[..., NF:], 0.031))
    both("k9 attention f32 -> concat [0, C)",
         lambda: k8.requant(attended, 1.0, 0.037, out=buf, offset=0))
    del e1, skip, cat, buf, attended
    torch.cuda.empty_cache()
    # K9, UNet++: g0_0's quantize and the dequant of row 0's slot 4
    e = bf16((NNEST, P, P, NF))
    row0 = i8((NNEST, P, P, 6 * NF))
    both("k9 UNet++ g0_0 bf16 -> int8", lambda: k8.requant(e, 1.0, 0.05))
    both("k9 UNet++ dequant row0 slot 4", lambda: k8.requant(row0[..., 4 * NF:5 * NF], 0.031))
    # K11 at the main shape: row 1 slot 0 into channels [32, 96) of row 0
    row1 = i8((NNEST, P // 2, P // 2, 10 * NF))
    both("k11 row1 slot 0 -> row0 [32, 96)",
         lambda: k8.upsample2x_i8(row1[..., :2 * NF], out=row0, offset=NF))
    del e, row0, row1
    torch.cuda.empty_cache()
    # K9, 3D: e1, the raw skip into the concat buffer, the d6 dequant
    full = (N3D,) + VOL_TILE
    e1, skip, d6 = bf16(full + (NF // 2,)), i8(full + (NF,)), i8(full + (NF // 2,))
    buf = torch.zeros(full + (3 * NF,), dtype=torch.int8, device=dev)
    both("k9 3d e1 bf16 -> int8", lambda: k8.requant(e1, 1.0, 0.05))
    both("k9 3d raw skip -> concat", lambda: k8.requant(skip, 1.0, 1.0, out=buf, offset=2 * NF))
    both("k9 3d d6 dequant", lambda: k8.requant(d6, 0.031))
    del e1, skip, d6, buf
    torch.cuda.empty_cache()

    # K10, 2D: every encoder level of config 1's forward batch
    for level in range(4):
        x = i8((N2D, TILE >> level, TILE >> level, NF << level))
        both(f"k10 level {level} ({N2D}, {TILE >> level}^2, {NF << level})",
             lambda: k8.maxpool_i8(x))
        del x
    # K10, UNet++: slot 0 of row 0 (32 of 192 channels)
    row0 = i8((NNEST, P, P, 6 * NF))
    both("k10 UNet++ row0 slot 0", lambda: k8.maxpool_i8(row0[..., :NF]))
    del row0
    torch.cuda.empty_cache()
    # K6: the bf16 Siam forward batch at 256^2 tiles, PredictSiam's float32
    # default (512^2 tiles, 32 pairs a forward batch, Siam_UNet(32)) and the
    # wider float32 timing shape
    for name, shape, dtype, cl in (
            ("k6 bf16 channels_last (128, 256, 16, 16)", (128, 256, 16, 16), torch.bfloat16, True),
            ("k6 float32 (32, 256, 32, 32)", (32, 256, 32, 32), torch.float32, False),
            ("k6 float32 (16, 1024, 32, 32)", (16, 1024, 32, 32), torch.float32, False)):
        cur = torch.randn(shape, generator=g, device=dev).to(dtype)
        prev = torch.randn(shape, generator=g, device=dev).to(dtype)
        if cl:
            cur = cur.contiguous(memory_format=torch.channels_last)
            prev = prev.contiguous(memory_format=torch.channels_last)
        both(name, lambda: depthwise_xcorr(cur, prev), True)
        del cur, prev
    torch.cuda.empty_cache()
    xcorr_grad_forms(torch, dev, both, depthwise_xcorr_grad_input, depthwise_xcorr_grad_kernel)

    stitch_forms(torch, dev, both, (k8, hist, stitch, normalize, tiling))
    normalize_forms(torch, dev, both, (k8, hist, stitch, normalize, tiling), prefixes)

    floor = store_floor(torch, _cuda, timed) if "k11 " in prefixes else None
    k11v_floor = (store_floor(torch, _cuda, timed, N3D * math.prod(VOL_TILE), 2 * NF, 3 * NF, 0)
                  if "k11v " in prefixes else None)
    k10_floor = load_floor(torch, _cuda, timed) if "k10 " in prefixes else None
    k1_floor = ({dt: read_floor(torch, _cuda, timed, CHUNK * FRAME * FRAME * size)
                 for dt, size in (("uint8", 1), ("uint16", 2), ("float32", 4))}
                if "k1 " in prefixes else None)
    # K5s's chunk: 64 float16 tiles of 512^2; K2v's float mode: 18 bf16 tiles
    # of (64, 256, 256)
    k5s_floor = (read_floor(torch, _cuda, timed, CHUNK * 4 * P * P * 2)
                 if "k5s " in prefixes else None)
    k2v_floor = (write_floor(torch, _cuda, timed, 18 * VOL[0] * 256 * 256 * 2)
                 if "k2v " in prefixes else None)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"package": str(args.package.resolve()), "card": card, "ms": ms,
                      "k11_store_floor_ms": floor, "k11v_store_floor_ms": k11v_floor,
                      "k10_load_floor_ms": k10_floor, "k1_read_floor_ms": k1_floor,
                      "k5s_read_floor_ms": k5s_floor, "k2v_store_floor_ms": k2v_floor}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
