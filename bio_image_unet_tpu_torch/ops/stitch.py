"""The stitches of the device pipelines: K3 (single-head masks), K5 and K5s
(multi-head safe-margin stitch and its fill).

K3: sigmoid·255 → uint8 per tile, then the mean-overlap stitch
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

K5 (counterpart of ``ops/stitch.py:163 _stitch_factored_xla`` with
``predictor.py:1130-1145``, and of the host form ``ops/stitch.py:138
_stitch_weighted_xla`` / ``:203 _stitch_weighted_frames``):
``margin_stitch(tiles, n_frames, plan, out_dtype)`` takes one head's float16
tiles, (n, C, th, tw) in frame-major grid order (``n >= n_frames · nx · ny``;
batch padding is ignored), and the plan's factor tables, and returns the
(n_frames, C, h, w) stitch: Σ tile·w / Σ w in float32 where Σ w > 0, summed
in grid order, written as float16 (the fused path) or float32 (the host
path); pixels no tile weighs are 0, and the caller writes the fill there.

K5s (the ``jnp.mean`` fill of ``predictor.py:1133`` / ``ops/stitch.py:208``):
``tile_sum(tiles, n_real)`` is the float64 sum of the first ``n_real`` tiles
(every channel), a 0-d tensor on the tiles' device.  The fill of a movie is
the total over its chunks divided by the count of real tile values.

Each wrapper launches ``csrc/margin_stitch.cu`` on a CUDA tensor or raises,
and takes the plain PyTorch version on a CPU tensor.
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


# --- K5 / K5s ---------------------------------------------------------------

def _check_heads(tiles: torch.Tensor, n_frames: int, plan) -> None:
    if tiles.dim() != 4 or tuple(tiles.shape[2:]) != (plan.th, plan.tw):
        raise ValueError(f"head tiles {tuple(tiles.shape)} are not (n, C, {plan.th}, {plan.tw})")
    if tiles.dtype != torch.float16:
        raise ValueError(f"margin_stitch takes float16 head tiles, got {tiles.dtype}")
    if tiles.shape[0] < n_frames * plan.per_frame:
        raise ValueError(f"{tiles.shape[0]} tiles for {n_frames} frames of "
                         f"{plan.per_frame} tiles each")
    if plan.factors is None:
        raise ValueError("margin_stitch needs a TilePlan built with factor tables")


def margin_stitch_plain(tiles: torch.Tensor, n_frames: int, plan,
                        out_dtype: torch.dtype = torch.float16) -> torch.Tensor:
    """Plain PyTorch K5: the JAX scan's arithmetic, tile by tile in grid order."""
    _check_heads(tiles, n_frames, plan)
    th, tw, c = plan.th, plan.tw, tiles.shape[1]
    t = tiles[: n_frames * plan.per_frame].float().reshape(n_frames, plan.nx, plan.ny, c, th, tw)
    out_h, out_w = max(th, plan.h), max(tw, plan.w)
    dev = tiles.device
    acc = torch.zeros((n_frames, c, out_h, out_w), dtype=torch.float32, device=dev)
    wsum = torch.zeros((out_h, out_w), dtype=torch.float32, device=dev)
    fx, fy = (torch.as_tensor(f, device=dev) for f in plan.factors)
    for i, x0 in enumerate(plan.xs.tolist()):
        for j, y0 in enumerate(plan.ys.tolist()):
            wt = torch.minimum(fx[i][:, None], fy[j][None, :])
            win = (slice(x0, x0 + th), slice(y0, y0 + tw))
            acc[(...,) + win] = acc[(...,) + win] + t[:, i, j] * wt
            wsum[win] = wsum[win] + wt
    covered = wsum > 0
    out = torch.where(covered, acc / torch.where(covered, wsum, torch.ones_like(wsum)),
                      torch.zeros((), dtype=torch.float32, device=dev))
    return out[..., : plan.h, : plan.w].to(out_dtype).contiguous()


def margin_stitch(tiles: torch.Tensor, n_frames: int, plan,
                  out_dtype: torch.dtype = torch.float16) -> torch.Tensor:
    """K5 (see the module docstring)."""
    _check_heads(tiles, n_frames, plan)
    if out_dtype not in (torch.float16, torch.float32):
        raise ValueError(f"margin_stitch writes float16/float32, got {out_dtype}")
    if tiles.device.type == "cpu":
        return margin_stitch_plain(tiles, n_frames, plan, out_dtype)
    dev = tiles.device
    _cuda.require_cuda(tiles, "margin_stitch")
    _cuda.require_cuda(plan.fx_t, "margin_stitch plan", dev)
    c = tiles.shape[1]
    out = torch.empty((n_frames, c, plan.h, plan.w), dtype=out_dtype, device=dev)
    A = _cuda
    fn = A.function("margin_stitch", "k5_margin_stitch",
                    [A.P] + [A.I32] * 8 + [A.P] * 8 + [A.I32, A.P, A.P])
    A.launch(fn, dev, tiles.data_ptr(), n_frames, c, plan.h, plan.w, plan.th, plan.tw,
             plan.nx, plan.ny, plan.xs_t.data_ptr(), plan.ys_t.data_ptr(),
             plan.row_lo.data_ptr(), plan.row_hi.data_ptr(), plan.col_lo.data_ptr(),
             plan.col_hi.data_ptr(), plan.fx_t.data_ptr(), plan.fy_t.data_ptr(),
             int(out_dtype == torch.float32), out.data_ptr())
    margin_stitch.launches += 1
    return out


margin_stitch.launches = 0

# blocks of K5s's first pass: two per SM of an H100
_SUM_BLOCKS = 264


def tile_sum_plain(tiles: torch.Tensor, n_real: int) -> torch.Tensor:
    """Plain PyTorch K5s."""
    return tiles[:n_real].double().sum()


def tile_sum(tiles: torch.Tensor, n_real: int) -> torch.Tensor:
    """K5s (see the module docstring)."""
    if tiles.dtype != torch.float16:
        raise ValueError(f"tile_sum takes float16 head tiles, got {tiles.dtype}")
    if not 0 < n_real <= tiles.shape[0]:
        raise ValueError(f"n_real {n_real} outside 1..{tiles.shape[0]}")
    if tiles.device.type == "cpu":
        return tile_sum_plain(tiles, n_real)
    dev = tiles.device
    _cuda.require_cuda(tiles, "tile_sum")
    partials = torch.empty(_SUM_BLOCKS, dtype=torch.float64, device=dev)
    out = torch.empty((), dtype=torch.float64, device=dev)
    A = _cuda
    fn = A.function("margin_stitch", "k5s_tile_sum", [A.P, A.I64, A.I32, A.P, A.P, A.P])
    A.launch(fn, dev, tiles.data_ptr(), n_real * tiles[0].numel(), _SUM_BLOCKS,
             partials.data_ptr(), out.data_ptr())
    tile_sum.launches += 1
    return out


tile_sum.launches = 0
