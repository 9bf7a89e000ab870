"""Time every int8 conv and up-conv layer of one forward batch on the card.

    python3 <checkout>/bio_image_unet_tpu_torch/utils/qconv_layers.py

K7 / K8 at each of the 17 + 4 layers of ``Unet(n_filter=32)``'s int8 trunk
on config 1's forward batch (256 tiles of 256²), K7v / K8v at each of the
13 + 3 layers of ``UNet3D(n_filter=32)``'s on config 5's (16 tiles of
(32, 128, 128)), on seeded random int8 operands: each layer's mean device
time over 10 launches (CUDA events, the 50 MB L2 flushed before each, as
``chip_smoke.py`` times its rows), the sum of each trunk's layers and the
registers and spills ptxas reports for each ``qconv`` instance, as one JSON
line.  The script imports the package of the checkout it lies in, so two
checkouts are compared by running each one's copy in turns (A, B, B, A) in
one call on one card.  Without a card it exits with code 2.
"""

from __future__ import annotations

import json
import re
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

# (name, side of the tile at that level, cin, cout): Unet(32), 256² tiles
UNET_CONVS = [("encode2", 256, 32, 32), ("encode3", 128, 32, 64), ("encode4", 128, 64, 64),
              ("encode5", 64, 64, 128), ("encode6", 64, 128, 128), ("encode7", 32, 128, 256),
              ("encode8", 32, 256, 256), ("middle_conv1", 16, 256, 512),
              ("middle_conv2", 16, 512, 512), ("decode1", 32, 512, 256),
              ("decode2", 32, 256, 256), ("decode3", 64, 256, 128), ("decode4", 64, 128, 128),
              ("decode5", 128, 128, 64), ("decode6", 128, 64, 64), ("decode7", 256, 64, 32),
              ("decode8", 256, 32, 32)]
# (name, input side, cin, cout): the up-convs into the first half of the concat buffer
UNET_UPS = [("up1", 16, 512, 256), ("up2", 32, 256, 128), ("up3", 64, 128, 64),
            ("up4", 128, 64, 32)]
# UNet3D(32), (32, 128, 128) tiles: (name, level, cin, cout); level k is the
# tile halved k times
LEVELS = [(32, 128, 128), (16, 64, 64), (8, 32, 32), (4, 16, 16)]
UNET3D_CONVS = [("encode2", 0, 16, 32), ("encode3", 1, 32, 32), ("encode4", 1, 32, 64),
                ("encode5", 2, 64, 64), ("encode6", 2, 64, 128), ("middle_conv1", 3, 128, 128),
                ("middle_conv2", 3, 128, 256), ("decode1", 2, 384, 128),
                ("decode2", 2, 128, 128), ("decode3", 1, 192, 64), ("decode4", 1, 64, 64),
                ("decode5", 0, 96, 32), ("decode6", 0, 32, 16)]
# (name, input level, channels): into the first channels of a (c + c/2) buffer
UNET3D_UPS = [("up1", 3, 256), ("up2", 2, 128), ("up3", 1, 64)]


def ptxas_summary(log: str) -> dict:
    """``qconv`` instance (its template arguments) → ptxas's spill and
    register lines."""
    out, entry = {}, None
    for line in log.splitlines():
        if "Compiling entry" in line:
            m = re.search(r"qconvI((?:L[bi]\d+E)+)E", line)
            entry = ",".join(v for _, v in re.findall(r"L([bi])(\d+)E", m.group(1))) if m else None
        elif entry and ("spill" in line or "Used" in line):
            out.setdefault(entry, []).append(line.split(":", 1)[-1].strip())
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("qconv_layers: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from bio_image_unet_tpu_torch.ops import _cuda
    from bio_image_unet_tpu_torch.ops import int8 as k8

    t0 = time.perf_counter()
    logs = _cuda.build(["int8_trunk"])
    build_s = time.perf_counter() - t0
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)

    def i8(shape):
        return torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8)

    def packed(lead, cin):
        w = torch.zeros(lead + (32 * -(-cin // 32),), dtype=torch.int8, device=dev)
        w[..., :cin] = i8(lead + (cin,))
        return w

    def timed(fn, iters=10):
        fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(iters):
            flush.fill_(1)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / iters

    def scales(c):
        return torch.full((c,), 1e-3, device=dev), torch.zeros(c, device=dev)

    ms = {}
    for name, s, cin, cout in UNET_CONVS:
        x, w = i8((256, s, s, cin)), packed((cout, 3, 3), cin)
        sw, b = scales(cout)
        ms[f"k7 {name}"] = timed(lambda: k8.qconv3x3(x, w, sw, b, 0.02, 0.05))
    for name, s, cin, cout in UNET_UPS:
        x, w = i8((256, s, s, cin)), packed((2, 2, cout), cin)
        sw, b = scales(cout)
        buf = torch.zeros((256, 2 * s, 2 * s, 2 * cout), dtype=torch.int8, device=dev)
        ms[f"k8 {name}"] = timed(lambda: k8.qconvt2x2(x, w, sw, b, 0.02, 0.05, out=buf))
    for name, k, cin, cout in UNET3D_CONVS:
        x, w = i8((16,) + LEVELS[k] + (cin,)), packed((cout, 3, 3, 3), cin)
        sw, b = scales(cout)
        ms[f"k7v {name}"] = timed(lambda: k8.qconv3x3x3(x, w, sw, b, 0.05))
    for name, k, c in UNET3D_UPS:
        x, w = i8((16,) + LEVELS[k] + (c,)), packed((2, 2, 2, c), c)
        sw, b = scales(c)
        buf = torch.zeros((16,) + LEVELS[k - 1] + (c + c // 2,), dtype=torch.int8, device=dev)
        ms[f"k8v {name}"] = timed(lambda: k8.qconvt2x2x2(x, w, sw, b, 0.05, out=buf))
    del x, w, buf
    print(json.dumps({
        "root": str(ROOT), "card": torch.cuda.get_device_name(0), "build_s": build_s,
        "unet_batch_ms": sum(v for k, v in ms.items() if k.startswith(("k7 ", "k8 "))),
        "unet3d_batch_ms": sum(v for k, v in ms.items() if k.startswith(("k7v", "k8v"))),
        "layers_ms": ms, "ptxas": ptxas_summary(logs.get("int8_trunk", ""))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
