"""K3: sigmoid·255 → uint8 per tile, then the mean-overlap stitch
(counterpart of ``bio_image_unet_tpu/predict/predictor.py:450-463``'s epilogue,
``:117 _stitch_chunk_u8`` and ``ops/stitch.py:35 _stitch_xla``).

``sigmoid_stitch(logits, n_frames, plan)`` takes the forward's logits for a
chunk's tiles in frame-major grid order — (n, th, tw) or (n, 1, th, tw),
float32 or bfloat16, ``n >= n_frames · nx · ny`` (batch padding is ignored) —
and returns the stitched (n_frames, h, w) uint8 masks.  Each tile pixel is
quantized as trunc(sigmoid(z)·255); where tiles overlap the uint8 values are
averaged in float32 and truncated, exactly as the JAX programs do.

On a CUDA tensor the wrapper launches ``csrc/sigmoid_stitch.cu`` or raises;
on a CPU tensor it takes the plain PyTorch version.
"""

from __future__ import annotations

import torch

from . import _cuda


def _tiles(logits: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    if logits.dim() == 4:
        if logits.shape[1] != 1:
            raise ValueError("sigmoid_stitch takes single-channel logits")
        logits = logits[:, 0]
    if tuple(logits.shape[1:]) != (th, tw):
        raise ValueError(f"logit tiles {tuple(logits.shape[1:])} do not match "
                         f"the plan's tile {(th, tw)}")
    return logits


def sigmoid_stitch_plain(logits: torch.Tensor, n_frames: int, plan) -> torch.Tensor:
    """Plain PyTorch K3."""
    th, tw = plan.th, plan.tw
    tiles = _tiles(logits, th, tw)[: n_frames * plan.per_frame]
    u8 = (torch.sigmoid(tiles.float()) * 255.0).to(torch.uint8)
    framed = u8.reshape(n_frames, plan.nx, plan.ny, th, tw)
    if plan.exact:
        out = framed.permute(0, 1, 3, 2, 4).reshape(n_frames, plan.nx * th, plan.ny * tw)
        return out[:, : plan.h, : plan.w].contiguous()
    out_h, out_w = max(th, plan.h), max(tw, plan.w)
    acc = torch.zeros((n_frames, out_h, out_w), dtype=torch.float32, device=u8.device)
    cnt = torch.zeros((out_h, out_w), dtype=torch.float32, device=u8.device)
    for i, x0 in enumerate(plan.xs.tolist()):
        for j, y0 in enumerate(plan.ys.tolist()):
            acc[:, x0:x0 + th, y0:y0 + tw] += framed[:, i, j].float()
            cnt[x0:x0 + th, y0:y0 + tw] += 1.0
    out = (acc / torch.clamp(cnt, min=1.0)).to(torch.uint8)
    return out[:, : plan.h, : plan.w].contiguous()


def sigmoid_stitch(logits: torch.Tensor, n_frames: int, plan) -> torch.Tensor:
    """K3 (see the module docstring)."""
    tiles = _tiles(logits, plan.th, plan.tw)
    if tiles.shape[0] < n_frames * plan.per_frame:
        raise ValueError(f"{tiles.shape[0]} tiles for {n_frames} frames of "
                         f"{plan.per_frame} tiles each")
    if tiles.device.type == "cpu":
        return sigmoid_stitch_plain(tiles, n_frames, plan)
    dev = tiles.device
    _cuda.require_cuda(tiles, "sigmoid_stitch")
    _cuda.require_cuda(plan.xs_t, "sigmoid_stitch plan", dev)
    if tiles.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"sigmoid_stitch takes float32/bfloat16 logits, got {tiles.dtype}")
    out = torch.empty((n_frames, plan.h, plan.w), dtype=torch.uint8, device=dev)
    A = _cuda
    fn = A.function("sigmoid_stitch", "k3_sigmoid_stitch",
                    [A.P, A.I32, A.I32, A.I32, A.I32, A.I32, A.I32, A.I32, A.I32]
                    + [A.P] * 8)
    A.launch(fn, dev, tiles.data_ptr(), int(tiles.dtype == torch.bfloat16), n_frames,
             plan.h, plan.w, plan.th, plan.tw, plan.nx, plan.ny,
             plan.xs_t.data_ptr(), plan.ys_t.data_ptr(), plan.row_lo.data_ptr(),
             plan.row_hi.data_ptr(), plan.col_lo.data_ptr(), plan.col_hi.data_ptr(),
             out.data_ptr())
    sigmoid_stitch.launches += 1
    return out


sigmoid_stitch.launches = 0
