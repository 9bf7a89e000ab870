"""Time K9 (``requant``) and K11 (``upsample2x_i8``) on the card at the
shapes ``chip_smoke.py`` gives them, under two timers, and the store floor of
K11's output layout.

    python3 <checkout>/bio_image_unet_tpu_torch/utils/k9_k11_times.py [--package DIR]

Each form's mean time over 10 launches (CUDA events, the 50 MB L2 flushed
before each) is taken twice: ``lead`` spins the device ~0.5 ms after the
flush, so the host has enqueued the launch before the device reaches it and
the time is the device's alone (``chip_smoke.py``'s timer); ``no_lead``
records the start event right after the flush, so a form also holds the
wrapper's host work where that outlasts the flush.  ``--package`` imports
``bio_image_unet_tpu_torch`` from another checkout (by default the one this
file lies in): two versions of the kernels are compared under the same
timers by running this file in turns (A, B, B, A) in one call on one card.
The store floor is the time of 16-byte stores alone into 64 of every 192
bytes of the UNet++ row buffer, against the same bytes contiguous: a
yardstick compiled here, not a kernel of the port.  Prints one JSON line;
without a card it exits with code 2.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
HOST_LEAD_CYCLES = 1_000_000  # ~0.5 ms of device spin at the H100's clocks
ITERS = 10
N2D, TILE, NF = 256, 256, 32  # config 1's forward batch, Unet(32)
NNEST, P = 16, 512  # config 4's forward batch of UNet++ tiles
N3D, VOL_TILE = 16, (32, 128, 128)  # config 5's forward batch, UNet3D(32)

STORE_PROBE_CU = r"""
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
"""


def store_floor(torch, _cuda, timed) -> dict:
    """The store floor of K11's main-shape output: channels [32, 96) of the
    (16, 512², 192) row buffer, and the same bytes contiguous."""
    _cuda.BUILD.mkdir(parents=True, exist_ok=True)
    src, lib = _cuda.BUILD / "store_probe.cu", _cuda.BUILD / "libstore_probe.so"
    src.write_text(STORE_PROBE_CU)
    subprocess.run([_cuda._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", str(lib), str(src)], check=True,
                   capture_output=True, timeout=300)
    fn = ctypes.CDLL(str(lib)).store16_rows
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    rows, width, stride, off = NNEST * P * P, 2 * NF, 6 * NF, NF
    out = torch.empty((rows, stride), dtype=torch.int8, device="cuda")

    def run(st, o):
        err = fn(out.data_ptr(), rows, width // 16, st, o, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"store probe: CUDA error {err}")

    return {"slot": timed(lambda: run(stride, off), True),
            "dense": timed(lambda: run(width, 0), True)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", type=Path, default=ROOT,
                    help="checkout whose bio_image_unet_tpu_torch is timed")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("k9_k11_times: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.package.resolve()))
    from bio_image_unet_tpu_torch.ops import _cuda
    from bio_image_unet_tpu_torch.ops import int8 as k8

    _cuda.build(["int8_trunk", "int8_resample"])
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

    def both(name, fn):
        ms[name] = {"lead": timed(fn, True), "no_lead": timed(fn, False)}

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

    floor = store_floor(torch, _cuda, timed)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"package": str(args.package.resolve()), "card": card, "ms": ms,
                      "k11_store_floor_ms": floor}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
