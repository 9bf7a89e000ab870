"""The stitches of the device pipelines: K3 (single-head masks), K5 and K5s
(multi-head safe-margin stitch and its fill), and their 3D forms K3v (the
volume's mean stitch) and K5v (the multi-head linear-blend stitch).

K3: sigmoid·255 → uint8 per tile, then the mean-overlap stitch
(counterpart of ``bio_image_unet_tpu/predict/predictor.py:450-463``'s epilogue,
``:117 _stitch_chunk_u8`` and ``ops/stitch.py:35 _stitch_xla``).

``sigmoid_stitch(logits, n_frames, plan)`` takes the forward's logits for a
chunk's tiles in frame-major grid order — (n, th, tw) or (n, C, th, tw),
float32 or bfloat16, ``n >= n_frames · nx · ny`` (batch padding is ignored) —
and returns the stitched uint8 masks, (n_frames, h, w) for one channel and
(n_frames, C, h, w) for more.  Each tile pixel of each channel is quantized
as trunc(sigmoid(z)·255); where tiles overlap the uint8 values are averaged
in float32 and truncated, exactly as the JAX programs do.  The form with C >
1 (K3c) is that of ``Predict`` on a ``Unet`` with ``out_channels != 1``
(``predictor.py:1508-1595``: ``_forward_with``'s quantize, then
``ops/stitch.py:80 stitch_mean_frames_device`` over every channel); it
launches the kernel once a channel.

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
the total over its chunks divided by the count of real tile values.  One
launch (16-byte loads, an exact fixed-point split of each value, the blocks'
partials added in a fixed order by the last block; ``_k5s_geometry`` lays
it out), so the sum is exact and equal to the plain one wherever the
float64 sum is exact; NaN and ±inf give what IEEE addition gives.

Each wrapper launches ``csrc/margin_stitch.cu`` on a CUDA tensor or raises,
and takes the plain PyTorch version on a CPU tensor.

K3v (counterpart of ``predictor.py:1242-1256``, the quantize of
``_forward_with`` :460-462, and ``ops/stitch.py:95 _stitch_xla_3d`` / ``:114
_stitch_3d_jit``): ``sigmoid_stitch_3d(logits, plan)`` takes the logits of
one volume's tiles in z/x/y grid order — (n, tz, tx, ty) or (n, 1, tz, tx,
ty), float32 or bfloat16, ``n >= nz·nx·ny`` — and returns the (d, h, w)
uint8 volume: each tile voxel quantized as trunc(sigmoid(z)·255), the
covering tiles' uint8 values averaged in float32 and truncated.  Kernel in
``csrc/sigmoid_stitch.cu``.

K5v (counterpart of ``ops/stitch.py:163 _stitch_factored_xla`` with the 3D
linear-blend factors of ``predict/tiling.py:113 _blend_factors`` and the
epilogue ``predictor.py:1354-1365``; host form ``ops/stitch.py:138`` /
``:204`` with ``fill_mean=False``): ``blend_stitch_3d(tiles, n_vols, plan,
out_dtype)`` takes one head's float16 tiles, (n, C, tz, tx, ty) in
volume-major grid order, and the plan's three factor tables, and returns
(n_vols, C, d, h, w): each tile weighs min(fz, fx, fy), Σ tile·w / Σ w in
float32 accumulated in the scan's order where Σ w > 0, else 0; float16 (the
fused path) or float32 (the host path).  Each step of the weighted sum is
one fused multiply-add, ``fma(tile, w, acc)`` rounded once: XLA contracts the
scan's ``block + patch * w`` so (the blend weights are fractions, so the two
roundings of a separate multiply and add would differ from it).  Kernel in
``csrc/margin_stitch.cu``.

``stitch_mean_device(patches, starts_per_axis, out_spatial, quantize_u8)`` is
the JAX package's API function of that name (``ops/stitch.py:232``): the
mean-overlap stitch of one frame's channels-last patches, in plain PyTorch on
the patches' device.  No path of the port calls it; the predict paths stitch
with K3.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _cuda


def _tiles(logits: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """The logits as (n, C, th, tw): (n, th, tw) is one channel."""
    if logits.dim() == 3:
        logits = logits[:, None]
    if logits.dim() != 4 or tuple(logits.shape[2:]) != (th, tw):
        raise ValueError(f"logit tiles {tuple(logits.shape)} are not (n[, C], {th}, {tw}), "
                         "the plan's tile")
    return logits


def _masks(out: torch.Tensor) -> torch.Tensor:
    """(n_frames, C, h, w) masks as the wrapper returns them: one channel as
    (n_frames, h, w)."""
    return out[:, 0] if out.shape[1] == 1 else out


def sigmoid_stitch_plain(logits: torch.Tensor, n_frames: int, plan) -> torch.Tensor:
    """Plain PyTorch K3 (K3c for C > 1)."""
    th, tw = plan.th, plan.tw
    tiles = _tiles(logits, th, tw)[: n_frames * plan.per_frame]
    c = tiles.shape[1]
    u8 = (torch.sigmoid(tiles.float()) * 255.0).to(torch.uint8)
    framed = u8.reshape(n_frames, plan.nx, plan.ny, c, th, tw)
    if plan.exact:
        out = framed.permute(0, 3, 1, 4, 2, 5).reshape(n_frames, c, plan.nx * th, plan.ny * tw)
        return _masks(out[..., : plan.h, : plan.w].contiguous())
    out_h, out_w = max(th, plan.h), max(tw, plan.w)
    acc = torch.zeros((n_frames, c, out_h, out_w), dtype=torch.float32, device=u8.device)
    cnt = torch.zeros((out_h, out_w), dtype=torch.float32, device=u8.device)
    for i, x0 in enumerate(plan.xs.tolist()):
        for j, y0 in enumerate(plan.ys.tolist()):
            acc[..., x0:x0 + th, y0:y0 + tw] += framed[:, i, j].float()
            cnt[x0:x0 + th, y0:y0 + tw] += 1.0
    out = (acc / torch.clamp(cnt, min=1.0)).to(torch.uint8)
    return _masks(out[..., : plan.h, : plan.w].contiguous())


def sigmoid_stitch(logits: torch.Tensor, n_frames: int, plan) -> torch.Tensor:
    """K3, and K3c for C > 1 (see the module docstring)."""
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
    c = tiles.shape[1]
    out = torch.empty((n_frames, c, plan.h, plan.w), dtype=torch.uint8, device=dev)
    A = _cuda
    fn = A.function("sigmoid_stitch", "k3_sigmoid_stitch",
                    [A.P, A.I32, A.I32, A.I32, A.I32, A.I32, A.I32, A.I32, A.I32, A.I32]
                    + [A.P] * 8)
    A.launch(fn, dev, tiles.data_ptr(), int(tiles.dtype == torch.bfloat16), n_frames, c,
             plan.h, plan.w, plan.th, plan.tw, plan.nx, plan.ny,
             plan.xs_t.data_ptr(), plan.ys_t.data_ptr(), plan.row_lo.data_ptr(),
             plan.row_hi.data_ptr(), plan.col_lo.data_ptr(), plan.col_hi.data_ptr(),
             out.data_ptr())
    sigmoid_stitch.launches += c  # one launch a channel
    return _masks(out)


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

_K5S_THREADS = 256       # csrc/margin_stitch.cu K5S_THREADS
_K5S_MAX_VECTORS = 511   # K5S_MAX_VECTORS: 16-byte vectors a thread at most
_K5S_BLOCKS = 4 * 132    # about four blocks on each SM of an H100
_SUM_SCRATCH = {}        # (device index, stream) -> (int32 scratch, float64 partials)


def _k5s_geometry(n: int, address: int):
    """K5s's launch layout for ``n`` float16 values at byte ``address``:
    ``(head, n_vec, tail, blocks)``.  The ``head`` values before the first
    16-byte boundary (all ``n`` where they do not reach it), then ``n_vec``
    aligned vectors of 8 values, then ``tail`` values; ``blocks`` of 256
    threads.  Thread g sums vectors g, g + stride, … (stride = 256 ·
    blocks: at most 511 of them, so at most 4090 values a thread) and value
    g of the head and of the tail where g is below their length."""
    head = min(n, (-address % 16) // 2)
    n_vec = (n - head) // 8
    tail = n - head - 8 * n_vec
    blocks = max(_K5S_BLOCKS, -(-n_vec // (_K5S_THREADS * _K5S_MAX_VECTORS)))
    return head, n_vec, tail, blocks


def _sum_scratch(dev: torch.device, blocks: int):
    """K5s's scratch on the current stream of ``dev``: int32 arrivals (word
    0, zero at rest: the last block resets it) and block flags, and the
    blocks' float64 partials; kept per stream, since launches on one stream
    never overlap."""
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    buf = _SUM_SCRATCH.get(key)
    if buf is None or buf[1].numel() < blocks:
        buf = (torch.zeros(1 + blocks, dtype=torch.int32, device=dev),
               torch.empty(blocks, dtype=torch.float64, device=dev))
        _SUM_SCRATCH[key] = buf
    return buf


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
    head, n_vec, tail, blocks = _k5s_geometry(n_real * tiles[0].numel(), tiles.data_ptr())
    scratch, partials = _sum_scratch(dev, blocks)
    out = torch.empty((), dtype=torch.float64, device=dev)
    A = _cuda
    fn = A.function("margin_stitch", "k5s_tile_sum",
                    [A.P, A.I32, A.I64, A.I32, A.I32, A.P, A.P, A.P, A.P])
    A.launch(fn, dev, tiles.data_ptr(), head, n_vec, tail, blocks, partials.data_ptr(),
             scratch.data_ptr(), out.data_ptr())
    tile_sum.launches += 1
    return out


tile_sum.launches = 0


# --- K3v / K5v ---------------------------------------------------------------

def _tiles_3d(logits: torch.Tensor, plan) -> torch.Tensor:
    if logits.dim() == 5:
        if logits.shape[1] != 1:
            raise ValueError("sigmoid_stitch_3d takes single-channel logits")
        logits = logits[:, 0]
    if logits.dim() != 4 or tuple(logits.shape[1:]) != plan.tile:
        raise ValueError(f"logit tiles {tuple(logits.shape)} do not match the plan's tile "
                         f"{plan.tile}")
    if logits.shape[0] < plan.per_volume:
        raise ValueError(f"{logits.shape[0]} tiles for a volume of {plan.per_volume}")
    return logits


def sigmoid_stitch_3d_plain(logits: torch.Tensor, plan) -> torch.Tensor:
    """Plain PyTorch K3v."""
    tz, tx, ty = plan.tile
    tiles = _tiles_3d(logits, plan)[: plan.per_volume]
    u8 = (torch.sigmoid(tiles.float()) * 255.0).to(torch.uint8)
    grid = u8.reshape(plan.nz, plan.nx, plan.ny, tz, tx, ty)
    if plan.exact:
        out = grid.permute(0, 3, 1, 4, 2, 5).reshape(plan.nz * tz, plan.nx * tx, plan.ny * ty)
        return out[: plan.d, : plan.h, : plan.w].contiguous()
    shape = (max(tz, plan.d), max(tx, plan.h), max(ty, plan.w))
    acc = torch.zeros(shape, dtype=torch.float32, device=u8.device)
    cnt = torch.zeros(shape, dtype=torch.float32, device=u8.device)
    for k, z0 in enumerate(plan.zs.tolist()):
        for i, x0 in enumerate(plan.xs.tolist()):
            for j, y0 in enumerate(plan.ys.tolist()):
                win = (slice(z0, z0 + tz), slice(x0, x0 + tx), slice(y0, y0 + ty))
                acc[win] += grid[k, i, j].float()
                cnt[win] += 1.0
    out = (acc / torch.clamp(cnt, min=1.0)).to(torch.uint8)
    return out[: plan.d, : plan.h, : plan.w].contiguous()


def sigmoid_stitch_3d(logits: torch.Tensor, plan) -> torch.Tensor:
    """K3v (see the module docstring)."""
    tiles = _tiles_3d(logits, plan)
    if tiles.device.type == "cpu":
        return sigmoid_stitch_3d_plain(tiles, plan)
    dev = tiles.device
    _cuda.require_cuda(tiles, "sigmoid_stitch_3d")
    _cuda.require_cuda(plan.zs_t, "sigmoid_stitch_3d plan", dev)
    if tiles.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"sigmoid_stitch_3d takes float32/bfloat16 logits, got {tiles.dtype}")
    out = torch.empty((plan.d, plan.h, plan.w), dtype=torch.uint8, device=dev)
    A = _cuda
    fn = A.function("sigmoid_stitch", "k3v_sigmoid_stitch_3d",
                    [A.P] + [A.I32] * 9 + [A.P] * 11)
    A.launch(fn, dev, tiles.data_ptr(), int(tiles.dtype == torch.bfloat16), plan.d, plan.h,
             plan.w, *plan.tile, plan.nx, plan.ny, *_plan_tables(plan), out.data_ptr())
    sigmoid_stitch_3d.launches += 1
    return out


sigmoid_stitch_3d.launches = 0


def _plan_tables(plan) -> list:
    """The device pointers of a :class:`TilePlan3D`'s start and cover tables."""
    return [t.data_ptr() for t in (plan.zs_t, plan.xs_t, plan.ys_t, plan.z_lo, plan.z_hi,
                                   plan.row_lo, plan.row_hi, plan.col_lo, plan.col_hi)]


def _check_heads_3d(tiles: torch.Tensor, n_vols: int, plan) -> None:
    if tiles.dim() != 5 or tuple(tiles.shape[2:]) != plan.tile:
        raise ValueError(f"head tiles {tuple(tiles.shape)} are not (n, C, *{plan.tile})")
    if tiles.dtype != torch.float16:
        raise ValueError(f"blend_stitch_3d takes float16 head tiles, got {tiles.dtype}")
    if tiles.shape[0] < n_vols * plan.per_volume:
        raise ValueError(f"{tiles.shape[0]} tiles for {n_vols} volumes of "
                         f"{plan.per_volume} tiles each")
    if plan.factors is None:
        raise ValueError("blend_stitch_3d needs a TilePlan3D built with factor tables")


def _fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a·b + c`` of float32 tensors rounded once to float32, as a fused
    multiply-add.  The product is exact in float64 and the float64 sum ``s``
    carries its rounding error ``e`` (TwoSum); rounding ``s`` to float32 is
    then the correct rounding except where ``s`` is exactly a float32
    midpoint and ``e`` breaks the tie."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    z = s - p
    e = (p - (s - z)) + (cd - z)
    r = s.float()
    inf = torch.tensor(float("inf"), device=r.device)
    up = torch.where(r.double() > s, r, torch.nextafter(r, inf))
    down = torch.where(r.double() < s, r, torch.nextafter(r, -inf))
    tie = (r.double() != s) & ((up.double() + down.double()) * 0.5 == s)
    return torch.where(tie & (e > 0), up, torch.where(tie & (e < 0), down, r))


def blend_stitch_3d_plain(tiles: torch.Tensor, n_vols: int, plan,
                          out_dtype: torch.dtype = torch.float16) -> torch.Tensor:
    """Plain PyTorch K5v: the JAX scan's arithmetic, tile by tile in grid
    order."""
    _check_heads_3d(tiles, n_vols, plan)
    (tz, tx, ty), c, dev = plan.tile, tiles.shape[1], tiles.device
    t = (tiles[: n_vols * plan.per_volume].float()
         .reshape(n_vols, plan.nz, plan.nx, plan.ny, c, tz, tx, ty))
    shape = (max(tz, plan.d), max(tx, plan.h), max(ty, plan.w))
    acc = torch.zeros((n_vols, c) + shape, dtype=torch.float32, device=dev)
    wsum = torch.zeros(shape, dtype=torch.float32, device=dev)
    fz, fx, fy = (torch.as_tensor(f, device=dev) for f in plan.factors)
    for k, z0 in enumerate(plan.zs.tolist()):
        for i, x0 in enumerate(plan.xs.tolist()):
            for j, y0 in enumerate(plan.ys.tolist()):
                wt = torch.minimum(torch.minimum(fz[k][:, None, None], fx[i][None, :, None]),
                                   fy[j][None, None, :])
                win = (slice(z0, z0 + tz), slice(x0, x0 + tx), slice(y0, y0 + ty))
                acc[(...,) + win] = _fma_f32(t[:, k, i, j], wt, acc[(...,) + win])
                wsum[win] = wsum[win] + wt
    covered = wsum > 0
    out = torch.where(covered, acc / torch.where(covered, wsum, torch.ones_like(wsum)),
                      torch.zeros((), dtype=torch.float32, device=dev))
    return out[..., : plan.d, : plan.h, : plan.w].to(out_dtype).contiguous()


def blend_stitch_3d(tiles: torch.Tensor, n_vols: int, plan,
                    out_dtype: torch.dtype = torch.float16) -> torch.Tensor:
    """K5v (see the module docstring)."""
    _check_heads_3d(tiles, n_vols, plan)
    if out_dtype not in (torch.float16, torch.float32):
        raise ValueError(f"blend_stitch_3d writes float16/float32, got {out_dtype}")
    if tiles.device.type == "cpu":
        return blend_stitch_3d_plain(tiles, n_vols, plan, out_dtype)
    dev = tiles.device
    _cuda.require_cuda(tiles, "blend_stitch_3d")
    _cuda.require_cuda(plan.fz_t, "blend_stitch_3d plan", dev)
    c = tiles.shape[1]
    out = torch.empty((n_vols, c, plan.d, plan.h, plan.w), dtype=out_dtype, device=dev)
    A = _cuda
    fn = A.function("margin_stitch", "k5v_blend_stitch_3d",
                    [A.P] + [A.I32] * 11 + [A.P] * 12 + [A.I32, A.P, A.P])
    A.launch(fn, dev, tiles.data_ptr(), n_vols, c, plan.d, plan.h, plan.w, *plan.tile,
             plan.nz, plan.nx, plan.ny, *_plan_tables(plan), plan.fz_t.data_ptr(),
             plan.fx_t.data_ptr(), plan.fy_t.data_ptr(), int(out_dtype == torch.float32),
             out.data_ptr())
    blend_stitch_3d.launches += 1
    return out


blend_stitch_3d.launches = 0


def stitch_mean_device(patches, starts_per_axis, out_spatial, quantize_u8: bool = False
                       ) -> torch.Tensor:
    """One frame's (N, th, tw, C) patches in grid order (x-major, the order
    of ``predict.tiling.stitch_mean``) → the (H, W, C) float32 mean where
    they overlap, summed in grid order, 0 where none lies; truncated to uint8
    with ``quantize_u8``.  A numpy array is taken to the CPU."""
    patches = torch.as_tensor(patches).to(torch.float32)
    n, th, tw, c = patches.shape
    out_h, out_w = int(out_spatial[0]), int(out_spatial[1])
    gx, gy = np.meshgrid(np.asarray(starts_per_axis[0]), np.asarray(starts_per_axis[1]),
                         indexing="ij")
    out = torch.zeros((out_h, out_w, c), dtype=torch.float32, device=patches.device)
    cnt = torch.zeros_like(out)
    for patch, x0, y0 in zip(patches, gx.ravel().tolist(), gy.ravel().tolist()):
        out[x0:x0 + th, y0:y0 + tw] += patch
        cnt[x0:x0 + th, y0:y0 + tw] += 1.0
    result = out / torch.clamp(cnt, min=1.0)
    return result.to(torch.uint8) if quantize_u8 else result
