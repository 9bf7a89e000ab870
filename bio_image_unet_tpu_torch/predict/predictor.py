"""Tiled prediction on the card (counterpart of
``bio_image_unet_tpu/predict/predictor.py``: ``_Engine``, ``Predict``,
``PredictMultiOutput``, ``PredictSiam``, ``Predict3D`` and
``PredictMultiOutput3D``).

The fused device pipeline runs per 16-frame chunk: K1 per-frame clip bounds
(``ops/histogram.py``), K2 normalize → reflect pad → uint8 → tiles
(``predict/normalize.py``), the BN-folded forward on cuDNN
(``predict/fastpath.py``), K3 sigmoid·255 → uint8 → mean stitch
(``ops/stitch.py``).  Only raw frames go up and stitched uint8 masks come
down.  Uploads and downloads run on their own streams through a small ring of
pinned buffers, so the copies of one chunk overlap the compute of others.

The host-staged path (``device_pipeline=False``) normalizes and tiles on the
host in numpy, as the JAX host path does, and shares the forward and K3.

Multi-head prediction (``PredictMultiOutput``: ``MultiOutputUnet`` and UNet++
checkpoints) runs the same chunks through K1 → K2h (float tiles in the
working dtype) → the folded multi-head forward → K5 (safe-margin stitch of
each head's float16 tiles).  The JAX program stitches the whole movie at once
and fills the pixels no tile weighs with the mean of every real head tile;
here K5s adds each chunk's real tiles into a float64 total, and after the
last chunk the mean is written into the grid's static uncovered mask.

Streaming Siam prediction (``PredictSiam``) reads pages as it goes and
writes each finished chunk to the output TIFF: per chunk of
``frames_per_chunk`` pairs one upload of the (k+1)-frame block, the pair
bounds (K1, its pair-row form for ``'all'``), K2p (both planes' normalize →
zero pad → uint8 → tiles), the twin-input folded forward (the ``corr`` join
through K6) and K3; ``_Engine._run_chunks`` hands each downloaded chunk to
the writer in movie order.

3D prediction runs a volume as one unit, as the JAX programs do: the raw
volume goes up once; ``Predict3D`` (``UNet3D``) runs K1 over the whole
volume → K2v (normalize → reflect pad → uint8 → 3-axis tiles) → the folded
3D forward → K3v (sigmoid·255 → uint8 → mean stitch) and the uint8 volume
comes down; ``PredictMultiOutput3D`` (``MultiOutputUnet3D``) runs K1 per
volume (or stack-global bounds) → K2v in float mode → the multi-head forward
→ K5v (linear-blend stitch, float16) over all its volumes at once.  Their
host-staged paths normalize and tile in numpy and share the forward and the
stitch.

``quantized=True`` (``predict/quant.py``, ``predict/quant_nested.py``,
``predict/quant3d.py``) swaps the 2D, UNet++ or 3D trunk's float forward for
the w8a8 int8 one once the engine has
calibrated its activation scales on the movie or the volumes, before the
first chunk or volume of the fused path; the gate, its warnings and the
calibration follow ``predictor.py:373-414``, ``:472-626``.

``mesh=`` (``parallel.get_mesh``; ``predictor.py:430-447``) runs a call on
every rank of the mesh, each rank making the same call and getting the whole
result: the 2D fused frames path (and the fused multi-head one) rounds each
chunk's frame count up to a multiple of the ``data`` axis and runs K1 → K2 →
forward → K3 (K5) on its contiguous block of frames with no collective, then
all-gathers the uint8 masks (float16 heads; the fill's float64 K5s sums are
all-reduced before the mean); the host-staged paths, Siam and the 3D paths
split their forward batch over ``data`` and gather the logits or head tiles
before the stitch.  Every rank calibrates int8 on the same sampled frames of
the whole input, so int8 stays bitwise equal across layouts.  Only rank 0
writes files.
"""

from __future__ import annotations

import os
import time
import warnings
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .. import checkpoint
from ..data import tiff
from ..models import get_model
from ..ops.histogram import clip_bounds, pair_clip_bounds
from ..ops.stitch import (blend_stitch_3d, margin_stitch, sigmoid_stitch, sigmoid_stitch_3d,
                          tile_sum)
from ..progress import ProgressNotifier
from ..parallel.mesh import Placement, check_mesh, main_process
from ..utils.device import resolve_device
from ..utils.utils import save_as_tif
from .fastpath import folded_forward
from .normalize import (_normalize_stack, _percentile, normalize_tile, normalize_tile_3d,
                        normalize_tile_float, normalize_tile_pairs)
from .quant import int8_builders, int8_status
from .tiling import (TilePlan, TilePlan3D, _blend_factors, _margin_factors, grid_starts,
                     overlap_starts)

_TORCH_DTYPE = {np.dtype(np.uint8): torch.uint8, np.dtype(np.uint16): torch.uint16,
                np.dtype(np.float16): torch.float16, np.dtype(np.float32): torch.float32}


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _resolve_device_pipeline(device_pipeline, blocker) -> bool:
    """``None`` auto-enables the fused program when nothing blocks it,
    ``True`` insists (warning with the reason when it cannot be honored),
    ``False`` forces the host-staged path (``predictor.py:284``)."""
    if device_pipeline and blocker is not None:
        warnings.warn(
            f"device_pipeline=True cannot be honored: {blocker}; "
            "falling back to the host-staged path", stacklevel=3)
    return (device_pipeline is not False) and blocker is None


def _progress(show_progress: bool, progress_notifier):
    return progress_notifier if (show_progress and progress_notifier) else (
        ProgressNotifier.progress_notifier_tqdm() if show_progress else None)


def _single_tick(progress_notifier, show_progress):
    """One step for the paths that run in one unit (a volume): a caller's
    notifier still starts and completes (``predictor.py:255``)."""
    progress = progress_notifier if (show_progress and progress_notifier) else None
    return progress.iterator([0], total=1) if progress else [0]


def _fixed_bounds(imgs: np.ndarray, mode: str, clip_threshold) -> Optional[np.ndarray]:
    """Stack-global ``(lo, hi, lo, hi)`` of the fused paths' ``'first'`` and
    ``'all'`` modes, once on the host: after clipping, the stack's extremes
    are exactly (lo, hi) (``predictor.py:1544``, ``:2219-2231``); ``None``
    for ``'single'`` (bounds per frame or volume, on the device)."""
    if mode in ("first", "all"):
        ref = imgs[0] if mode == "first" else imgs
        lo = _percentile(ref, clip_threshold[0])
        hi = _percentile(ref, clip_threshold[1])
        return np.array([lo, hi, lo, hi], np.float32)
    if mode != "single":
        raise ValueError(f"normalization_mode {mode} not valid!")
    return None


def _fused_blocker(imgs: np.ndarray, device_pipeline, n_px: int = 0, max_px: int = 0,
                   thing: str = "pixels") -> Optional[str]:
    """What keeps the fused program from an input (``predictor.py:1942-1954``
    and the 2D classes): a dtype it does not normalize, NaNs, more tile
    pixels than its budget."""
    if not (imgs.dtype in (np.uint8, np.uint16) or np.issubdtype(imgs.dtype, np.floating)):
        return (f"input dtype {imgs.dtype} (the fused program normalizes "
                "uint8/uint16/float on device)")
    if (np.issubdtype(imgs.dtype, np.floating) and device_pipeline is not False
            and np.isnan(imgs).any()):
        return "float input contains NaNs (handled by the host nanpercentile path)"
    if max_px and n_px > max_px:
        return f"{n_px} patch {thing} exceed the single-program budget"
    return None


def _cut_host_tiles(frames: np.ndarray, plan: TilePlan, out: np.ndarray, pad_mode: str) -> int:
    """Pad (..., n, h, w) frames up to the tile (``np.pad`` mode ``'reflect'``
    as ``_split`` does, ``'constant'`` zeros as ``_split_pair`` does,
    ``predictor.py:1597``, ``:1880-1898``) and cut them in grid order into
    ``out[..., i]``, frame-major; returns the tiles cut.  A uint8 ``out``
    truncates, as the reference does."""
    h, w = frames.shape[-2:]
    pad = ((0, 0),) * (frames.ndim - 2) + ((0, max(plan.th - h, 0)), (0, max(plan.tw - w, 0)))
    frames = np.pad(frames, pad, pad_mode)
    i = 0
    for f in range(frames.shape[-3]):
        for x0 in plan.xs:
            for y0 in plan.ys:
                out[..., i, :, :] = frames[..., f, x0:x0 + plan.th, y0:y0 + plan.tw]
                i += 1
    return i


def _pad_frames(block: np.ndarray, n: int) -> np.ndarray:
    """Pad a tail block to ``n`` frames by repeating its last frame."""
    k = block.shape[0]
    if k == n:
        return block
    return np.concatenate([block, np.broadcast_to(block[-1:], (n - k,) + block.shape[1:])])


class _Engine:
    """Model loading, BN fold, batched forward and the chunk pipeline."""

    # frames per chunk: every chunk has the same shapes, the tail chunk is
    # padded with its last frame and cropped after the stitch
    FUSED_CHUNK_FRAMES = 16
    # chunks in flight: the depth of the pinned upload/download ring
    FUSED_PENDING_CHUNKS = 4

    def __init__(self, model_params, network=None, batch_size: int = 8,
                 half_precision: bool = False, device=None, quantized: bool = False,
                 mesh=None):
        self.device = resolve_device(device)
        self.mesh = None if mesh is None else check_mesh(mesh, int(batch_size), self.device)
        # this rank's place on the data axis: its block of frames, its share
        # of a forward batch
        self._n_data = self.mesh.shape["data"] if self.mesh is not None else 1
        self._d = self.mesh.index("data") if self.mesh is not None else 0
        state = checkpoint.load(model_params)
        hp = dict(state["hyperparams"])
        self.hyperparams = hp
        name = network or hp.get("model_name") or hp.get("network")
        if name is None:
            raise ValueError("network is not defined")
        if name == "Unet_v0":
            hp.setdefault("in_channels", 1)
            hp.setdefault("out_channels", 1)
        if name in ("Unet_v0", "BabyUnet"):
            # the legacy models have no bf16 mode: the whole path runs float32
            # (predictor.py:349-356)
            half_precision = False
        self.model = get_model(name, **hp)
        self.model.load_state_dict(state["state_dict"], strict=True)
        self.model.eval()
        self.dtype = torch.bfloat16 if half_precision else torch.float32
        self.batch_size = int(batch_size)
        self.heads = getattr(self.model, "heads", None)
        self.forward = folded_forward(self.model, self.dtype, self.device)
        # uint8 tiles × 1/255 with the scalar rounded to the working dtype
        # first, as JAX's weak typing does (predictor.py:454-455)
        self._scale = torch.tensor(1.0 / 255.0, dtype=self.dtype, device=self.device)
        self._int8_gate(quantized)

    def _int8_gate(self, quantized: bool) -> None:
        """Opt-in w8a8 int8 (``predict/quant.py``, ``predict/quant3d.py``; the
        gate of ``predictor.py:373-414``): ``_quant`` holds ``(cal_fn,
        make_forward)`` when int8 will run; the scales are calibrated before
        the first fused chunk or volume (``_calibrate_int8``,
        ``_calibrate_int8_3d``), which sets ``_quant_ready``."""
        self._quant = None
        self._quant_ready = False
        self.calibration_seconds = 0.0
        if not quantized:
            return
        status = int8_status(self.model)
        if status == "enabled":
            self._quant = int8_builders(self.model, self.device, self.forward)
        elif status == "experimental":
            warnings.warn(
                "quantized=True for this family has a full int8 implementation in the "
                "JAX package but its end-to-end pipeline measured below the ship bar "
                "there; set BIU_INT8_EXPERIMENTAL=1 to run int8 anyway — running the "
                "bf16 path instead", stacklevel=4)
        else:
            reason = ("the 'corr' join has no int8 formulation (the correlation's kernel "
                      "is a traced activation, not a weight)"
                      if getattr(self.model, "mode", None) == "corr"
                      else f"{type(self.model).__name__} has no int8 formulation")
            warnings.warn(
                f"quantized=True declined: {reason}. int8 covers Unet (incl. dilation), "
                "AttentionUnet, Siam_UNet max/control/concat joins, MultiOutputUnet, and "
                "— measurement-gated — UNet++ and the 3D trunks; running the bf16 path "
                "instead", stacklevel=4)

    # int8 calibration (``predictor.py:472-478``): tiles sampled from this
    # many frames evenly spaced across the stack, this many strided tiles,
    # and headroom on the calibrated max|activation|
    _QUANT_CAL_FRAMES = 2
    _QUANT_CAL_TILES = 32
    _QUANT_CAL_MARGIN = 1.1

    def _upload(self, frames) -> torch.Tensor:
        """Host frames (or volumes) on the engine's device, as the kernels
        take them (uint8, uint16 or float32); a device tensor as it is."""
        if isinstance(frames, torch.Tensor):
            return frames.to(self.device)
        frames = np.asarray(frames)
        if np.issubdtype(frames.dtype, np.floating):
            frames = frames.astype(np.float32, copy=False)
        return torch.from_numpy(np.ascontiguousarray(frames)).to(self.device)

    def _fixed_bounds_on_device(self, fixed_bounds) -> Optional[torch.Tensor]:
        """The stack-global ``(lo, hi, lo, hi)`` of ``'first'``/``'all'`` as
        the (4, 1) float32 table the kernels read; None stays None."""
        if fixed_bounds is None:
            return None
        return torch.as_tensor(np.asarray(fixed_bounds, np.float32).reshape(4, 1),
                               device=self.device)

    def _strided(self, n: int, count: int) -> torch.Tensor:
        """``count`` indices strided across ``n`` tiles, the ceil step
        reaching the last tile (``predictor.py:515-518``)."""
        return torch.arange(0, n, -(-n // count), device=self.device)[:count]

    def _calibrate_int8(self, imgs, xs, ys, resize_dim, clip_threshold, invert, prev=None,
                        fixed_bounds=None, pair_mode: str = "single") -> None:
        """Calibrate the int8 forward on tiles of the movie
        (``predictor.py:480-569``), cut on the card by the fused paths'
        kernels: the sampled frames go up, K1 takes their bounds per frame
        (or the stack-global ``fixed_bounds`` of ``'first'``/``'all'`` stand
        in), K2h cuts them into float32 tiles in [0, 1] at the movie's grid
        (reflect-padded and not truncated to uint8, as JAX calibrates), an
        ``index_select`` keeps the strided 32, and one instrumented bf16
        forward records each site's max|a|; then the int8 forward takes the
        engine's place.  Siam pairs (``prev``) take the pair program's
        bounds, both planes of a pair alike: K1 per frame (``'single'``),
        per prev plane (``'first'``) or K1's pair rows over one uploaded
        block (prev, cur, prev, cur, ...), whose odd rows (cur i, prev i+1)
        are dropped (``'all'``)."""
        cal_fn = self._quant[0]
        th, tw = resize_dim
        q_lo, q_hi = float(clip_threshold[0]), float(clip_threshold[1])
        frame_idx = np.unique(np.linspace(0, len(imgs) - 1,
                                          self._QUANT_CAL_FRAMES).round().astype(int))
        cur = self._upload(np.asarray(imgs)[frame_idx])
        n = len(frame_idx)
        plan = TilePlan(cur.shape[1], cur.shape[2], th, tw, xs, ys, self.device)
        pick = self._strided(n * plan.per_frame, self._QUANT_CAL_TILES)

        def tiles(frames, bounds):
            t = normalize_tile_float(frames, bounds.contiguous(), plan, n * plan.per_frame,
                                     torch.float32, invert)
            return t.index_select(0, pick)[:, None]

        if prev is None:
            bounds = (clip_bounds(cur, q_lo, q_hi) if fixed_bounds is None else
                      self._fixed_bounds_on_device(fixed_bounds))
            self._finish_int8_calibration(cal_fn(tiles(cur, bounds)))
            return
        prv = self._upload(np.asarray(prev)[frame_idx])
        if pair_mode == "single":
            both = clip_bounds(torch.cat([prv, cur]), q_lo, q_hi)
            b_prev, b_cur = both[:, :n], both[:, n:]
        elif pair_mode == "first":
            b_prev = b_cur = clip_bounds(prv, q_lo, q_hi)
        else:
            block = torch.stack([prv, cur], 1).flatten(0, 1)
            b_prev = b_cur = pair_clip_bounds(block, q_lo, q_hi)[:, ::2]
        self._finish_int8_calibration(cal_fn(tiles(cur, b_cur), tiles(prv, b_prev)))

    # calibration sub-volumes of the 3D families (``predictor.py:584-586``)
    _QUANT_CAL_TILES_3D = 8

    def _calibrate_int8_3d(self, vols, zs, xs, ys, tile, clip_threshold, invert: bool = False,
                           fixed_bounds=None) -> None:
        """Calibrate the 3D int8 forward (``predictor.py:588-626``) on the
        card: up to two volumes spanning the stack (taken from ``vols`` where
        it is the call's upload already, else uploaded alone), their bounds
        by K1 per volume or the caller's stack-global ``fixed_bounds``, K2v
        in float mode (float32 tiles in [0, 1], not truncated to uint8, as in
        JAX) over their whole grid, the 8 tiles strided across it kept by an
        ``index_select``; one instrumented bf16 forward; then the int8
        forward takes the engine's place."""
        cal_fn = self._quant[0]
        if vols.ndim == 3:
            vols = vols[None]
        vidx = np.unique(np.linspace(0, len(vols) - 1, 2).round().astype(int))
        if isinstance(vols, torch.Tensor):
            sel = vols.index_select(0, torch.as_tensor(vidx, device=vols.device))
        else:
            sel = self._upload(np.asarray(vols)[vidx])
        plan = TilePlan3D(*sel.shape[1:], tile, zs, xs, ys, self.device)
        bounds = (clip_bounds(sel, float(clip_threshold[0]), float(clip_threshold[1]))
                  if fixed_bounds is None else self._fixed_bounds_on_device(fixed_bounds))
        n = len(vidx) * plan.per_volume
        tiles = normalize_tile_3d(sel, bounds, plan, n, invert, torch.float32)
        pick = self._strided(n, self._QUANT_CAL_TILES_3D)
        self._finish_int8_calibration(cal_fn(tiles.index_select(0, pick)[:, None]))

    def _finish_int8_calibration(self, raw_maxes) -> None:
        """The margin, then the int8 forward in the float forward's place
        (``predictor.py:571-582``)."""
        make_forward = self._quant[1]
        self.forward = make_forward(np.asarray(raw_maxes) * self._QUANT_CAL_MARGIN)
        self._quant_ready = True

    def _maybe_calibrate(self, sample, *args, volumes: bool = False, **kw) -> None:
        """Calibrate before the first chunk of a quantized engine, on the
        movie's ``sample`` frames (with ``volumes``, the stack's volumes, on
        the host or already on the device); a runner given no sample raises.
        The calibration's wall time, the device's work included, is kept in
        ``calibration_seconds``."""
        if self._quant is None or self._quant_ready:
            return
        if sample is None:
            raise ValueError("a quantized engine calibrates on the movie's frames first: "
                             "pass sample frames")
        t0 = time.perf_counter()
        (self._calibrate_int8_3d if volumes else self._calibrate_int8)(sample, *args, **kw)
        self.calibration_seconds = time.perf_counter() - t0

    # tile pixels of one forward step (``predictor.py:716``); a Siam step
    # takes half (``:958-961``), as the twin encoder holds about twice the
    # activations
    STEP_PX = 1 << 24
    PAIR_STEP_PX = 1 << 23

    def batch_policy(self, per_chunk: int, th: int, tw: int, step_px: int = STEP_PX) -> int:
        """One forward step per ``step_px`` tile pixels; the user's
        batch_size is the floor."""
        return max(self.batch_size, min(per_chunk, step_px // (th * tw)))

    def _mesh_batch(self, bs: int) -> int:
        """A forward batch that splits evenly over the ``data`` axis
        (``predictor.py:962-963``)."""
        return _round_up(bs, self._n_data)

    def _gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of ``t`` along dim 0, in mesh order."""
        return t if self.mesh is None else self.mesh.all_gather(t)

    def _share(self, t, axis: int = 0):
        """This rank's contiguous share of ``t`` (a tensor, or a chunk's host
        frames) along ``axis``; all of it without a mesh."""
        if self.mesh is None:
            return t
        return Placement(self.mesh, (None,) * axis + ("data",)).local(t)

    def _mesh_chunk(self, n_frames: int):
        """The fused frames paths' chunk (``predictor.py:704-708``): the
        frame count rounded up to a multiple of the data axis, and each
        rank's share of it."""
        n_chunk = _round_up(min(self.FUSED_CHUNK_FRAMES, n_frames), self._n_data)
        return n_chunk, n_chunk // self._n_data

    def forward_tiles(self, tiles_u8: torch.Tensor, bs: int, pairs: bool = False) -> torch.Tensor:
        """(n, *tile) uint8 tiles, n a multiple of ``bs`` → (n, 1, *tile)
        logits in the working dtype.  With ``pairs``, (2, n, th, tw) Siam
        tiles — the prev set, then the cur set — through the twin-input
        forward.  With a mesh, each rank forwards its share of the tiles in
        batches of ``bs`` / data and the logits are gathered."""
        if self.mesh is None:
            return self._forward_tiles(tiles_u8, bs, pairs)
        out = self._forward_tiles(self._share(tiles_u8, int(pairs)), bs // self._n_data, pairs)
        return self._gather(out)

    @torch.inference_mode()
    def _forward_tiles(self, tiles_u8: torch.Tensor, bs: int, pairs: bool = False) -> torch.Tensor:
        """:meth:`forward_tiles` on this rank alone."""
        outs = []
        for s in range(0, tiles_u8.shape[int(pairs)], bs):
            if pairs:
                prev, cur = (t[s:s + bs, None].to(self.dtype) * self._scale for t in tiles_u8)
                outs.append(self.forward.logits(cur, prev))
            else:
                outs.append(self.forward.logits(tiles_u8[s:s + bs, None].to(self.dtype)
                                                * self._scale))
        return outs[0] if len(outs) == 1 else torch.cat(outs)

    def fused_runner(self, h: int, w: int, xs, ys, resize_dim, clip_threshold,
                     invert: bool = False, fixed_bounds=None, n_frames: int = None,
                     sample: Optional[np.ndarray] = None):
        """The fused chunk program for this workload and its fixed frame
        count: ``fn(chunk)`` maps (n_chunk, h, w) raw frames on the engine's
        device to (n_chunk, h, w) uint8 masks on the device, all of it K1 →
        K2 → forward → K3 with no host round trip.  Benches time it on a
        device-resident movie.  A quantized engine calibrates on the host
        frames ``sample`` first (``predictor.py:819``)."""
        self._maybe_calibrate(sample, xs, ys, resize_dim, clip_threshold, invert,
                              fixed_bounds=fixed_bounds)
        th, tw = resize_dim
        plan = TilePlan(h, w, th, tw, xs, ys, self.device)
        n_chunk = min(self.FUSED_CHUNK_FRAMES, n_frames or self.FUSED_CHUNK_FRAMES)
        n = n_chunk * plan.per_frame
        bs = self.batch_policy(n, th, tw)
        n_pad = _round_up(n, bs)
        bounds_dev = self._fixed_bounds_on_device(fixed_bounds)
        q_lo, q_hi = float(clip_threshold[0]), float(clip_threshold[1])

        @torch.inference_mode()
        def fn(chunk: torch.Tensor) -> torch.Tensor:
            bounds = bounds_dev if bounds_dev is not None else clip_bounds(chunk, q_lo, q_hi)
            tiles = normalize_tile(chunk, bounds, plan, n_pad, invert)
            logits = self._forward_tiles(tiles, bs)
            return sigmoid_stitch(logits.contiguous(), chunk.shape[0], plan)

        return fn, n_chunk

    def fused_predict_frames(self, imgs: np.ndarray, xs, ys, resize_dim,
                             clip_threshold, invert: bool, progress=None,
                             fixed_bounds: Optional[np.ndarray] = None) -> np.ndarray:
        """(N, h, w) uint8/uint16/float32 frames → (N, h, w) uint8 masks
        through the fused device pipeline (``predictor.py:841``); with a
        mesh, each rank runs its block of every chunk's frames and the masks
        are gathered."""
        n_frames, h, w = imgs.shape
        n_chunk, mine = self._mesh_chunk(n_frames)
        fn, _ = self.fused_runner(h, w, xs, ys, resize_dim, clip_threshold,
                                  invert, fixed_bounds, mine, sample=imgs)
        return self._run_chunks(
            n_frames, n_chunk, {"mask": ((h, w), np.uint8)},
            lambda s: self._share(_pad_frames(imgs[s:s + n_chunk], n_chunk)),
            lambda x, k: {"mask": self._gather(fn(x))}, progress)["mask"]

    def host_predict_frames(self, norm: np.ndarray, xs, ys, resize_dim,
                            progress=None, channels: int = 1) -> np.ndarray:
        """Host-staged path: (N, h, w) float32 frames already normalized to
        [0, 255] on the host are reflect-padded and cut into uint8 tiles in
        numpy (``predictor.py:1597 _split``); the forward and K3 run on the
        device in batches of ``batch_size``.  Returns (N, h, w) uint8 masks,
        or (N, C, h, w) for a model of ``channels`` C > 1 outputs (K3c)."""
        n_frames, h, w = norm.shape
        th, tw = resize_dim
        plan = TilePlan(h, w, th, tw, xs, ys, self.device)
        n_chunk = min(self.FUSED_CHUNK_FRAMES, n_frames)
        bs = self.batch_size
        n_pad = _round_up(n_chunk * plan.per_frame, bs)

        def produce(s):
            # uint8 patch buffer: assignment truncates, as the reference does
            patches = np.empty((n_pad, th, tw), np.uint8)
            n = _cut_host_tiles(_pad_frames(norm[s:s + n_chunk], n_chunk), plan, patches,
                                "reflect")
            patches[n:] = patches[n - 1]
            return patches

        @torch.inference_mode()
        def step(patches: torch.Tensor, k: int) -> Dict[str, torch.Tensor]:
            logits = self.forward_tiles(patches, bs)
            return {"mask": sigmoid_stitch(logits.contiguous(), n_chunk, plan)}

        shape = (h, w) if channels == 1 else (channels, h, w)
        return self._run_chunks(n_frames, n_chunk, {"mask": (shape, np.uint8)},
                                produce, step, progress)["mask"]

    # --- Siam pairs ------------------------------------------------------------

    def pairs_runner(self, h: int, w: int, xs, ys, resize_dim, clip_threshold,
                     invert: bool, mode: str, k: int, sample: Optional[tuple] = None):
        """The fused Siam chunk program (``predictor.py:934
        fused_predict_pairs``): ``fn(block)`` maps a (k+1, h, w) raw block on
        the engine's device — pair i is (prev = block[i], cur = block[i+1]) —
        to the (k, h, w) uint8 masks of its cur frames: the pair bounds (K1
        over the k+1 frames for ``'single'``, over the prev planes for
        ``'first'``, over each pair's two planes as one row for ``'all'``),
        K2p, the twin-input forward, K3.  Returns ``(fn, plan, bs)``; benches
        time ``fn`` on a device-resident block.  A quantized engine
        calibrates first on ``sample`` = (cur frames, their prev frames) on
        the host (``predictor.py:946``)."""
        curs, prevs = sample if sample is not None else (None, None)
        self._maybe_calibrate(curs, xs, ys, resize_dim, clip_threshold, invert, prev=prevs,
                              pair_mode=mode)
        th, tw = resize_dim
        plan = TilePlan(h, w, th, tw, xs, ys, self.device)
        n = k * plan.per_frame
        bs = self._mesh_batch(self.batch_policy(n, th, tw, self.PAIR_STEP_PX))
        n_pad = _round_up(n, bs)
        q_lo, q_hi = float(clip_threshold[0]), float(clip_threshold[1])

        @torch.inference_mode()
        def fn(block: torch.Tensor) -> torch.Tensor:
            if mode == "single":
                bounds = clip_bounds(block, q_lo, q_hi)  # per frame, (4, k+1)
            elif mode == "first":
                bounds = clip_bounds(block[:-1], q_lo, q_hi)  # the prev planes'
            else:
                bounds = pair_clip_bounds(block, q_lo, q_hi)
            tiles = normalize_tile_pairs(block, bounds, plan, n_pad, invert)
            return sigmoid_stitch(self.forward_tiles(tiles, bs, pairs=True).contiguous(), k,
                                  plan)

        return fn, plan, bs

    # --- multi-head prediction ------------------------------------------------

    # the fused multi-head path's limit on a movie's tile pixels
    # (``predictor.py:1033``): the same call takes the same path as in JAX,
    # since the two paths round differently
    FUSED_HEADS_MAX_PX = 1 << 27

    def heads_batch(self, n_tiles: int, th: int, tw: int) -> int:
        """Forward batch of the multi-head paths (``predictor.py:1073-1075``):
        4M tile pixels a step for UNet++, whose dense grid keeps ~4× the live
        activations, 16M for the plain trunk; the user's ``batch_size`` is not
        the floor here, as in JAX."""
        from ..models.nested_unet import MultiOutputNestedUNet

        cap = (1 << 22) if isinstance(self.model, MultiOutputNestedUNet) else (1 << 24)
        return max(1, min(n_tiles, cap // (th * tw)))

    def forward_heads(self, tiles: torch.Tensor, bs: int) -> Dict[str, torch.Tensor]:
        """(n, th, tw) float tiles, n a multiple of ``bs`` → ``{head: (n, C,
        th, tw) float16}``, contiguous.  The dtype contract of
        ``_forward_with`` (``predictor.py:454-459``): tiles are cast to the
        working dtype, each head's 1×1 conv output goes to float32 for its
        activation, and every head is rounded to float16 before any stitch.
        With a mesh, each rank forwards its share and the head tiles are
        gathered."""
        if self.mesh is None:
            return self._forward_heads(tiles, bs)
        return {name: self._gather(t) for name, t in
                self._forward_heads(self._share(tiles), bs // self._n_data).items()}

    @torch.inference_mode()
    def _forward_heads(self, tiles: torch.Tensor, bs: int) -> Dict[str, torch.Tensor]:
        """:meth:`forward_heads` on this rank alone."""
        outs = {name: [] for name in self.heads}
        for s in range(0, tiles.shape[0], bs):
            x = tiles[s:s + bs, None].to(self.dtype)
            for name, v in self.forward.heads_out(x).items():
                outs[name].append(v.half())
        return {name: (v[0] if len(v) == 1 else torch.cat(v)).contiguous()
                for name, v in outs.items()}

    def heads_runner(self, h: int, w: int, xs, ys, patch_size, clip_threshold, factors,
                     fixed_bounds=None, n_frames: int = None, bs: Optional[int] = None,
                     sample: Optional[np.ndarray] = None):
        """The fused multi-head chunk program: ``fn(chunk, k)`` maps
        (n_chunk, h, w) raw frames on the device, of which the first ``k`` are
        real, to ``({head: (n_chunk, C, h, w) float16}, {head: float64 sum of
        the real tiles})`` — K1 → K2h → forward → K5 (and K5s where the grid
        leaves pixels uncovered).  Returns ``(fn, n_chunk, plan)``; benches
        time ``fn`` on a device-resident movie.  A quantized engine
        calibrates on the host frames ``sample`` first (``predictor.py:1050``)."""
        self._maybe_calibrate(sample, xs, ys, patch_size, clip_threshold, False,
                              fixed_bounds=fixed_bounds)
        ph, pw = patch_size
        plan = TilePlan(h, w, ph, pw, xs, ys, self.device, factors)
        n_chunk = min(self.FUSED_CHUNK_FRAMES, n_frames or self.FUSED_CHUNK_FRAMES)
        n = n_chunk * plan.per_frame
        bs = bs or self.heads_batch(n, ph, pw)
        n_pad = _round_up(n, bs)
        bounds_dev = self._fixed_bounds_on_device(fixed_bounds)
        q_lo, q_hi = float(clip_threshold[0]), float(clip_threshold[1])
        need_fill = bool(plan.uncovered.any())

        @torch.inference_mode()
        def fn(chunk: torch.Tensor, k: int):
            bounds = bounds_dev if bounds_dev is not None else clip_bounds(chunk, q_lo, q_hi)
            tiles = normalize_tile_float(chunk, bounds, plan, n_pad, self.dtype)
            heads = self._forward_heads(tiles, bs)
            out = {name: margin_stitch(t, n_chunk, plan, torch.float16)
                   for name, t in heads.items()}
            # a rank whose block of the tail chunk holds no real frame adds 0
            sums = ({name: (tile_sum(t, k * plan.per_frame) if k else
                            torch.zeros((), dtype=torch.float64, device=t.device))
                     for name, t in heads.items()} if need_fill else {})
            return out, sums

        return fn, n_chunk, plan

    def _heads_shapes(self, h: int, w: int, dtype) -> Dict[str, tuple]:
        return {name: ((cfg["channels"], h, w), dtype) for name, cfg in self.heads.items()}

    def _sum_totals(self, totals: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Each head's float64 fill sum over every rank's frames."""
        if self.mesh is None or not totals:
            return totals
        names = list(totals)
        both = self.mesh.all_reduce(torch.stack([totals[n] for n in names]))
        return dict(zip(names, both))

    @staticmethod
    def _fill(results: Dict[str, np.ndarray], totals, plan, n_frames: int) -> None:
        """Write each head's fill, ``float32(total / count)`` rounded to the
        result's dtype, into the plan's uncovered pixels of every frame."""
        if not totals:
            return
        for name, r in results.items():
            count = n_frames * plan.per_frame * r.shape[1] * plan.th * plan.tw
            fill = np.float32(float(totals[name]) / count)
            r[:, :, plan.uncovered] = fill.astype(r.dtype)

    def fused_predict_heads(self, imgs: np.ndarray, xs, ys, patch_size, clip_threshold,
                            factors, fixed_bounds: Optional[np.ndarray] = None,
                            progress=None, _bs: Optional[int] = None) -> Dict[str, np.ndarray]:
        """Fused multi-head predict (``predictor.py:1035``): (N, h, w)
        uint8/uint16/float32 frames → ``{head: (N, C, h, w) float16}``, each
        head stitched in float32 and rounded to float16, the uncovered pixels
        filled with the mean of every real head tile of the movie.  ``_bs`` is
        the OOM back-off's batch.  With a mesh, each rank runs its block of
        every chunk's frames, the stitched heads are gathered and the fill's
        sums added over the ranks."""
        n_frames, h, w = imgs.shape
        n_chunk, mine = self._mesh_chunk(n_frames)
        fn, _, plan = self.heads_runner(h, w, xs, ys, patch_size, clip_threshold,
                                        factors, fixed_bounds, mine, _bs, imgs)
        totals = {}

        def step(x, k):
            out, sums = fn(x, min(max(k - self._d * mine, 0), mine))
            for name, v in sums.items():
                totals[name] = v if name not in totals else totals[name] + v
            return {name: self._gather(t) for name, t in out.items()}

        def run():
            res = self._run_chunks(n_frames, n_chunk, self._heads_shapes(h, w, np.float16),
                                   lambda s: self._share(_pad_frames(imgs[s:s + n_chunk],
                                                                     n_chunk)),
                                   step, progress)
            self._fill(res, self._sum_totals(totals), plan, n_frames)
            return res

        bs = _bs or self.heads_batch(mine * plan.per_frame, *patch_size)
        return self._dispatch_with_oom_backoff(
            run, bs, lambda smaller: self.fused_predict_heads(
                imgs, xs, ys, patch_size, clip_threshold, factors, fixed_bounds,
                progress, _bs=smaller))

    def host_predict_heads(self, norm: np.ndarray, xs, ys, patch_size, factors,
                           progress=None) -> Dict[str, np.ndarray]:
        """Host-staged multi-head path (``predictor.py:2112-2142``): (N, h, w)
        float32 frames normalized to [0, 1] on the host are reflect-padded
        and cut into float32 tiles in numpy; the forward runs on the device
        in batches of ``batch_size``, K5 stitches each head's float16 tiles
        in float32 and the result stays float32 (the fill too)."""
        n_frames, h, w = norm.shape
        ph, pw = patch_size
        plan = TilePlan(h, w, ph, pw, xs, ys, self.device, factors)
        n_chunk = min(self.FUSED_CHUNK_FRAMES, n_frames)
        bs = self.batch_size
        n_pad = _round_up(n_chunk * plan.per_frame, bs)
        need_fill = bool(plan.uncovered.any())
        totals = {}

        def produce(s):
            block = _pad_frames(norm[s:s + n_chunk], n_chunk)
            block = np.pad(block, ((0, 0), (0, max(ph - h, 0)), (0, max(pw - w, 0))), "reflect")
            patches = np.empty((n_pad, ph, pw), np.float32)
            n = 0
            for img in block:
                for x0 in plan.xs:
                    for y0 in plan.ys:
                        patches[n] = img[x0:x0 + ph, y0:y0 + pw]
                        n += 1
            patches[n:] = patches[n - 1]
            return patches

        @torch.inference_mode()
        def step(patches: torch.Tensor, k: int) -> Dict[str, torch.Tensor]:
            heads = self.forward_heads(patches, bs)
            if need_fill:
                for name, t in heads.items():
                    v = tile_sum(t, k * plan.per_frame)
                    totals[name] = v if name not in totals else totals[name] + v
            return {name: margin_stitch(t, n_chunk, plan, torch.float32)
                    for name, t in heads.items()}

        res = self._run_chunks(n_frames, n_chunk, self._heads_shapes(h, w, np.float32),
                               produce, step, progress)
        self._fill(res, totals, plan, n_frames)
        return res

    # --- 3D prediction ----------------------------------------------------------

    # tile voxels of one 3D forward step (predictor.py:1206, :1297): 3D U-Net
    # activations are deep
    VOLUME_STEP_VOXELS = 1 << 23

    def _run_once(self, host, fn: Callable):
        """Upload ``host`` once (unless it is on the device already), map it
        with ``fn`` on the device and bring the result (a tensor or a dict of
        them) back as numpy: the volume paths' single unit, with no
        chunking."""
        out = fn(self._upload(host))
        if isinstance(out, dict):
            return {k: v.cpu().numpy() for k, v in out.items()}
        return out.cpu().numpy()

    def volume_runner(self, d: int, h: int, w: int, zs, xs, ys, tile, clip_threshold,
                      invert: bool = False, sample: Optional[np.ndarray] = None):
        """The fused ``Predict3D`` program (``predictor.py:1182
        fused_predict_volume``): ``fn(vol)`` maps a (d, h, w) raw volume on
        the engine's device to the (d, h, w) uint8 volume — K1 over the whole
        volume (one row of d·h·w voxels), K2v, the batched forward, K3v.
        Returns ``(fn, plan, bs)``; benches time ``fn`` on a resident
        volume.  A quantized engine calibrates on the host volume ``sample``
        first (``predictor.py:1192``)."""
        self._maybe_calibrate(sample, zs, xs, ys, tile, clip_threshold, invert, volumes=True)
        plan = TilePlan3D(d, h, w, tile, zs, xs, ys, self.device)
        n = plan.per_volume
        bs = self._mesh_batch(max(self.batch_size,
                                  min(n, self.VOLUME_STEP_VOXELS // int(np.prod(tile)))))
        n_pad = _round_up(n, bs)
        q_lo, q_hi = float(clip_threshold[0]), float(clip_threshold[1])

        @torch.inference_mode()
        def fn(vol: torch.Tensor) -> torch.Tensor:
            vols = vol[None]
            tiles = normalize_tile_3d(vols, clip_bounds(vols, q_lo, q_hi), plan, n_pad, invert)
            return sigmoid_stitch_3d(self.forward_tiles(tiles, bs), plan)

        return fn, plan, bs

    def fused_predict_volume(self, vol: np.ndarray, zs, xs, ys, tile, clip_threshold,
                             invert: bool = False) -> np.ndarray:
        """(d, h, w) uint8/uint16/float32 volume → (d, h, w) uint8 through
        the fused program."""
        vol_dev = self._upload(vol)  # calibration and the pass share the upload
        fn, _, _ = self.volume_runner(*vol.shape, zs, xs, ys, tile, clip_threshold, invert,
                                      sample=vol_dev)
        return self._run_once(vol_dev, fn)

    def host_predict_volume(self, patches: np.ndarray, plan: TilePlan3D) -> np.ndarray:
        """Host-staged ``Predict3D`` (``predictor.py:1981-2013``): (n, tz, tx,
        ty) uint8 tiles cut on the host go up once, the forward runs in
        batches of ``batch_size`` and K3v stitches the (d, h, w) uint8
        volume."""
        bs = self.batch_size

        @torch.inference_mode()
        def fn(x: torch.Tensor) -> torch.Tensor:
            return sigmoid_stitch_3d(self.forward_tiles(x, bs), plan)

        return self._run_once(_pad_frames(patches, _round_up(len(patches), bs)), fn)

    def heads_3d_runner(self, n_vols: int, d: int, h: int, w: int, zs, xs, ys, tile,
                        clip_threshold, factors, fixed_bounds=None, bs: Optional[int] = None,
                        sample: Optional[np.ndarray] = None):
        """The fused ``PredictMultiOutput3D`` program (``predictor.py:1262
        fused_predict_heads_3d``): ``fn(vols)`` maps (n_vols, d, h, w) raw
        volumes on the device to ``{head: (n_vols, C, d, h, w) float16}`` —
        K1 per volume (or the stack-global ``fixed_bounds``), K2v in the
        working dtype, the multi-head forward, K5v.  Returns ``(fn, plan,
        bs)``.  A quantized engine calibrates on the host volumes ``sample``
        first (``predictor.py:1279``)."""
        self._maybe_calibrate(sample, zs, xs, ys, tile, clip_threshold, volumes=True,
                              fixed_bounds=fixed_bounds)
        plan = TilePlan3D(d, h, w, tile, zs, xs, ys, self.device, factors)
        n = n_vols * plan.per_volume
        bs = bs or self._mesh_batch(max(1, min(n, self.VOLUME_STEP_VOXELS
                                               // int(np.prod(tile)))))
        n_pad = _round_up(n, bs)
        bounds_dev = self._fixed_bounds_on_device(fixed_bounds)
        q_lo, q_hi = float(clip_threshold[0]), float(clip_threshold[1])

        @torch.inference_mode()
        def fn(vols: torch.Tensor) -> Dict[str, torch.Tensor]:
            bounds = bounds_dev if bounds_dev is not None else clip_bounds(vols, q_lo, q_hi)
            tiles = normalize_tile_3d(vols, bounds, plan, n_pad, False, self.dtype)
            return {name: blend_stitch_3d(t, n_vols, plan, torch.float16)
                    for name, t in self.forward_heads(tiles, bs).items()}

        return fn, plan, bs

    def fused_predict_heads_3d(self, vols: np.ndarray, zs, xs, ys, tile, clip_threshold,
                               factors, fixed_bounds=None,
                               _bs: Optional[int] = None) -> Dict[str, np.ndarray]:
        """(n_vols, d, h, w) raw volumes → ``{head: (n_vols, C, d, h, w)
        float16}`` through the fused program; ``_bs`` is the OOM back-off's
        batch."""
        vols_dev = self._upload(vols)  # calibration and the pass share the upload
        fn, _, bs = self.heads_3d_runner(*vols.shape, zs, xs, ys, tile, clip_threshold,
                                         factors, fixed_bounds, _bs, sample=vols_dev)
        return self._dispatch_with_oom_backoff(
            lambda: self._run_once(vols_dev, fn), bs,
            lambda smaller: self.fused_predict_heads_3d(vols, zs, xs, ys, tile, clip_threshold,
                                                        factors, fixed_bounds, smaller),
            floor=self._n_data)

    def host_predict_heads_3d(self, patches: np.ndarray, n_vols: int,
                              plan: TilePlan3D) -> Dict[str, np.ndarray]:
        """Host-staged ``PredictMultiOutput3D`` (``predictor.py:2241-2277``):
        (n, tz, tx, ty) float32 tiles of volumes normalized to [0, 1] on the
        host go up once, the forward runs in batches of ``batch_size`` and K5v
        stitches each head's float16 tiles in float32 (float32 out)."""
        bs = self.batch_size

        @torch.inference_mode()
        def fn(x: torch.Tensor) -> Dict[str, torch.Tensor]:
            return {name: blend_stitch_3d(t, n_vols, plan, torch.float32)
                    for name, t in self.forward_heads(x, bs).items()}

        return self._run_once(_pad_frames(patches, _round_up(len(patches), bs)), fn)

    def _dispatch_with_oom_backoff(self, run: Callable, bs: int, retry: Callable,
                                   floor: int = 1):
        """Run ``run()``; when the card runs out of memory, halve the forward
        batch down to ``floor`` (a batch split over the data axis stays a
        multiple of it), warn and ``retry(smaller)`` on the card
        (``predictor.py:1160``).  It never moves to the CPU."""
        try:
            return run()
        except torch.cuda.OutOfMemoryError:
            if bs <= floor:
                raise
        # retried outside the handler, so the failed attempt's tensors are freed
        smaller = _round_up(max(floor, bs // 2), floor)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
        warnings.warn(f"the fused program ran out of device memory at batch {bs}; "
                      f"retrying with batch {smaller}", stacklevel=3)
        return retry(smaller)

    def _run_chunks(self, n_frames: int, n_chunk: int, outputs: Dict[str, tuple],
                    produce: Callable, step: Callable, progress=None,
                    sink: Optional[Callable] = None) -> Optional[Dict[str, np.ndarray]]:
        """Drive ``step`` over the movie chunk by chunk: ``produce(start)``
        gives chunk ``start``'s host array (fixed shape), ``step(x, k)`` maps
        its device copy, whose first ``k`` frames are real, to ``{name:
        (n_chunk, *shape) tensor}`` on the device, one for each ``outputs``
        entry ``name: (shape, numpy dtype)``.  Returns ``{name: (n_frames,
        *shape) array}``; tail frames past ``n_frames`` are cropped.  With
        ``sink``, nothing is kept: each finished chunk goes, in movie order,
        to ``sink({name: (k, *shape) array}, start)`` (the arrays valid only
        during the call), and the memory stays bounded by the chunks in
        flight.  When
        ``produce`` raises, the chunks already computed are finished first.
        The seconds of each stage of the last run are in
        ``self.chunk_seconds``: host time to produce, upload, dispatch, wait
        for and sink the chunks, and on the card ``download``, from a
        chunk's compute done to its result in host memory."""
        clock = self.chunk_seconds = dict.fromkeys(
            ("produce", "upload", "dispatch", "wait", "sink", "download"), 0.0)
        result = None
        if sink is None:
            result = {name: np.empty((n_frames,) + tuple(shape), dt)
                      for name, (shape, dt) in outputs.items()}

            def sink(arrays, s):
                for name, r in result.items():
                    r[s:s + len(arrays[name])] = arrays[name]

        def timed(key, fn, *args):
            t0 = time.perf_counter()
            out = fn(*args)
            clock[key] += time.perf_counter() - t0
            return out

        starts = list(range(0, n_frames, n_chunk))
        it = progress.iterator(starts) if progress is not None else starts
        if self.device.type == "cpu":
            for s in it:
                k = min(n_chunk, n_frames - s)
                x = torch.from_numpy(np.ascontiguousarray(timed("produce", produce, s)))
                out = timed("dispatch", step, x, k)
                timed("sink", sink, {name: t[:k].numpy() for name, t in out.items()}, s)
            return result

        dev = self.device
        ring = self.FUSED_PENDING_CHUNKS
        compute = torch.cuda.current_stream(dev)
        upload, download = torch.cuda.Stream(dev), torch.cuda.Stream(dev)
        in_host, in_dev, out_host = [None] * ring, [None] * ring, [None] * ring
        pending = [None] * ring  # (computed and downloaded events, start, frames)

        def finish(slot):
            (computed, downloaded), s, k = pending[slot]
            timed("wait", downloaded.synchronize)
            clock["download"] += computed.elapsed_time(downloaded) / 1e3
            timed("sink", sink, {name: t[:k].numpy() for name, t in out_host[slot].items()}, s)
            pending[slot] = None

        def drain(first):
            """Finish the chunks in flight, oldest (slot ``first``) first."""
            for j in range(ring):
                if pending[(first + j) % ring] is not None:
                    finish((first + j) % ring)

        i = 0
        for i, s in enumerate(it):
            slot = i % ring
            if pending[slot] is not None:
                # the slot's previous chunk is downloaded, hence computed and
                # uploaded: its three buffers are free again
                finish(slot)
            try:
                host = timed("produce", produce, s)
            except BaseException:
                drain(slot + 1)
                raise
            t0 = time.perf_counter()
            k = min(n_chunk, n_frames - s)
            if in_host[slot] is None:
                in_host[slot] = torch.empty(host.shape, dtype=_TORCH_DTYPE[host.dtype],
                                            pin_memory=True)
                out_host[slot] = {
                    name: torch.empty((n_chunk,) + tuple(shape),
                                      dtype=_TORCH_DTYPE[np.dtype(dt)], pin_memory=True)
                    for name, (shape, dt) in outputs.items()}
            in_host[slot].numpy()[...] = host
            with torch.cuda.stream(upload):
                if in_dev[slot] is None:
                    # allocated on the upload stream, which writes it: a block
                    # from the compute stream's pool may still be read by the
                    # previous chunk's kernels
                    in_dev[slot] = torch.empty(host.shape, dtype=in_host[slot].dtype,
                                               device=dev)
                in_dev[slot].copy_(in_host[slot], non_blocking=True)
                uploaded = torch.cuda.Event()
                uploaded.record(upload)
            compute.wait_event(uploaded)
            clock["upload"] += time.perf_counter() - t0
            out = timed("dispatch", step, in_dev[slot], k)
            computed = torch.cuda.Event(enable_timing=True)
            computed.record(compute)
            with torch.cuda.stream(download):
                download.wait_event(computed)
                for name, t in out.items():
                    out_host[slot][name].copy_(t, non_blocking=True)
                    t.record_stream(download)
                downloaded = torch.cuda.Event(enable_timing=True)
                downloaded.record(download)
            pending[slot] = ((computed, downloaded), s, k)
        drain(i + 1)
        return result


def _warn_quantized_host_path(quantized: bool, engine: _Engine, use_fused: bool,
                              fused_blocker: Optional[str]) -> None:
    """int8 runs only inside the fused device pipeline: warn when a
    quantized request took the host-staged path, which runs bf16/float32
    (``predictor.py:1451``)."""
    if quantized and not use_fused and engine._quant is not None:
        reason = fused_blocker or "device_pipeline=False was forced"
        warnings.warn("quantized=True runs only inside the fused device pipeline; this "
                      f"request took the host-staged path ({reason}) and runs bf16/f32",
                      stacklevel=3)


class Predict:
    """Tiled 2D prediction with mean-overlap stitching (``predictor.py:1465``).

    ``imgs`` may be an array or a tif path; the network is rebuilt from the
    checkpoint's hyperparams.  Results are uint8-quantized probabilities,
    (N, H, W), or (N, C, H, W) for a ``Unet`` of ``out_channels`` C > 1 (which
    runs host-staged, as in JAX), squeezed, kept in ``self.result`` and saved
    as a float16 tif when ``result_name`` is given.  Runs on CUDA unless
    ``device='cpu'`` is passed; raises when no card is present and the CPU was
    not asked for.
    """

    def __init__(self, imgs, result_name, model_params, network=None,
                 resize_dim=(512, 512), invert=False, normalization_mode="single",
                 clip_threshold=(0.0, 99.8), add_tile=0, normalize_result=False,
                 show_progress=True, batch_size: int = 8, half_precision=False,
                 mesh=None, device=None, device_pipeline: Optional[bool] = None,
                 quantized: bool = False,
                 progress_notifier: ProgressNotifier = None):
        device = resolve_device(device)
        if isinstance(imgs, (str, os.PathLike)):
            imgs = tiff.imread(imgs)
        imgs = np.asarray(imgs)
        self.resize_dim = tuple(int(v) for v in resize_dim)
        self.add_tile = add_tile
        self.result_name = result_name
        if imgs.ndim == 2:
            imgs = imgs[None]
        self.imgs_shape = imgs.shape

        engine = _Engine(model_params, network, batch_size, half_precision, device, quantized,
                         mesh)
        self.engine = engine
        if engine.hyperparams.get("in_channels", 1) != 1:
            raise ValueError("tiled 2D Predict supports single-channel input")
        out_ch = int(engine.hyperparams.get("out_channels", 1))
        if engine.heads is not None:
            raise ValueError(f"{type(engine.model).__name__} is a multi-head model: "
                             "predict with PredictMultiOutput")

        # the fused program stitches one channel; more run host-staged, their
        # uint8 tiles through the forward and K3c (predictor.py:1508-1509)
        fused_blocker = ("multi-channel output (out_channels != 1)" if out_ch != 1
                         else _fused_blocker(imgs, device_pipeline))
        if fused_blocker is None and any(self.resize_dim[a] - imgs.shape[a + 1]
                                         >= imgs.shape[a + 1] for a in range(2)):
            fused_blocker = ("tile more than 2× the frame extent (reflect "
                             "pad cannot exceed the axis size)")
        use_fused = _resolve_device_pipeline(device_pipeline, fused_blocker)
        _warn_quantized_host_path(quantized, engine, use_fused, fused_blocker)

        h, w = self.imgs_shape[1], self.imgs_shape[2]
        xs = grid_starts(h, self.resize_dim[0], add_tile)
        ys = grid_starts(w, self.resize_dim[1], add_tile)
        progress = _progress(show_progress, progress_notifier)
        if show_progress:
            print("Predicting data ...")

        if use_fused:
            if np.issubdtype(imgs.dtype, np.floating) and imgs.dtype != np.float32:
                # float16/float64 movies normalize in float32 on the device
                imgs = imgs.astype(np.float32)
            result = engine.fused_predict_frames(
                imgs, xs, ys, self.resize_dim, clip_threshold, invert, progress=progress,
                fixed_bounds=_fixed_bounds(imgs, normalization_mode, clip_threshold))
        else:
            norm = _normalize_stack(imgs, normalization_mode, clip_threshold, invert)
            result = engine.host_predict_frames(norm, xs, ys, self.resize_dim,
                                                progress=progress, channels=out_ch)
        # (N, h, w), or (N, C, h, w) like the reference, squeezed as JAX does
        self.result = np.squeeze(result)
        if result_name is not None and main_process():
            save_as_tif(self.result, result_name, normalize=normalize_result)


class PredictMultiOutput:
    """Multi-head tiled 2D prediction with the safe-margin stitch
    (``predictor.py:2016``): /16-rounded patch size, a batched forward of a
    ``MultiOutputUnet`` or UNet++ checkpoint, per-head float32 results in
    ``self.result[head]`` — (N, C, H, W) when a head has C > 1 channels,
    squeezed — saved as ``<result_path>/<head>.tif`` when ``result_path`` is
    given.  Runs on CUDA unless ``device='cpu'`` is passed; raises when no
    card is present and the CPU was not asked for.

    The fused path rounds each stitched head to float16 (as JAX's does); the
    host-staged path (``device_pipeline=False``) keeps float32."""

    def __init__(self, imgs, model_params, result_path=None, network=None,
                 max_patch_size=(1024, 1024), batch_size=8,
                 normalization_mode="single", clip_threshold=(0.0, 99.98),
                 add_tile=0, compress_tif=False, show_progress=True,
                 half_precision=False, safe_margin: int = 20, mesh=None, device=None,
                 device_pipeline: Optional[bool] = None, quantized: bool = False,
                 progress_notifier: ProgressNotifier = None):
        device = resolve_device(device)
        if isinstance(imgs, (str, os.PathLike)):
            imgs = tiff.imread(imgs)
        imgs = np.asarray(imgs)  # raw dtype kept: the fused path uploads integers
        if imgs.ndim == 2:
            imgs = imgs[None]
        self.imgs_shape = imgs.shape
        n_frames, h, w = imgs.shape

        engine = _Engine(model_params, network, batch_size, half_precision, device, quantized,
                         mesh)
        self.engine = engine
        heads = engine.hyperparams["output_heads"]
        self.target_keys = list(heads)

        # /16-rounded patch size (predictor.py:2045-2048)
        ph = _round_up(min(h, max_patch_size[0]), 16)
        pw = _round_up(min(w, max_patch_size[1]), 16)
        self.patch_size = (ph, pw)
        # the same starts for extraction and stitch (JAX's documented
        # divergence from the reference, predictor.py:2050-2056)
        xs = grid_starts(max(ph, h), ph, add_tile)
        ys = grid_starts(max(pw, w), pw, add_tile)
        n_px = n_frames * len(xs) * len(ys) * ph * pw

        # the uncovered-pixel fill is a whole-stack statistic: one program
        fused_blocker = _fused_blocker(imgs, device_pipeline, n_px,
                                       _Engine.FUSED_HEADS_MAX_PX)
        if fused_blocker is None and (ph - h >= h or pw - w >= w):
            fused_blocker = ("patch more than 2× the frame extent (reflect "
                             "pad cannot exceed the axis size)")
        use_fused = _resolve_device_pipeline(device_pipeline, fused_blocker)
        _warn_quantized_host_path(quantized, engine, use_fused, fused_blocker)

        progress = _progress(show_progress, progress_notifier)
        if show_progress:
            print("Predicting data ...")
        factors = _margin_factors((len(xs), len(ys)), (ph, pw), safe_margin)
        if use_fused:
            if np.issubdtype(imgs.dtype, np.floating) and imgs.dtype != np.float32:
                imgs = imgs.astype(np.float32)  # normalized in float32 on the device
            preds = engine.fused_predict_heads(
                imgs, xs, ys, (ph, pw), clip_threshold, factors,
                _fixed_bounds(imgs, normalization_mode, clip_threshold), progress)
        else:
            # host normalization in [0, 1] before the reflect pad (:2112-2116)
            norm = _normalize_stack(imgs.astype(np.float32), normalization_mode,
                                    clip_threshold, scale=1.0)
            preds = engine.host_predict_heads(norm, xs, ys, (ph, pw), factors, progress)

        self.result = {}
        for key in self.target_keys:
            r = preds[key]
            if r.shape[1] == 1:
                r = r[:, 0]
            self.result[key] = np.squeeze(r).astype(np.float32)
            if result_path is not None and main_process():
                os.makedirs(result_path, exist_ok=True)
                tiff.imwrite(os.path.join(result_path, f"{key}.tif"), self.result[key],
                             compress=6 if compress_tif else None)


# the most bytes a classic TIFF's 32-bit offsets address, less headroom for
# the IFDs (predictor.py:1758-1764)
_CLASSIC_TIFF_BYTES = 0xFFFFFFFF - (1 << 20)



class PredictSiam:
    """Streaming Siam movie predictor (``predictor.py:1619-1898``): pages are
    read from ``tif_file`` as they are needed, each frame paired with the one
    before it (frame 0 with frame 1; a 1-frame movie with itself), tiled,
    predicted by a ``Siam_UNet`` checkpoint (any join), mean-stitched and
    appended to the uint8 TIFF ``result_name`` chunk by chunk — memory stays
    bounded by the chunks in flight, whatever the movie's length.  BigTIFF
    is chosen when the output passes classic TIFF's 4 GiB.

    The fused path (uint8/uint16 pages; NaN-free float32 pages only with
    ``device_pipeline=True``) uploads each chunk's ``frames_per_chunk`` pages
    plus the previous chunk's last page once and runs the pair bounds (K1),
    K2p, the twin-input forward and K3 on the card.  The host-staged path
    (``device_pipeline=False``, and other page types) normalizes each pair on
    the host and zero-pads and cuts its tiles in numpy.  A NaN page met by the
    fused float path flushes the finished chunks, closes the reader and
    raises.  Runs on CUDA unless ``device='cpu'`` is passed; raises when no
    card is present and the CPU was not asked for."""

    def __init__(self, tif_file, result_name, model_params, resize_dim=(512, 512),
                 invert=False, normalization_mode="single", clip_threshold=(0.0, 99.98),
                 add_tile=0, normalize_result=False, show_progress=True,
                 batch_size: int = 8, half_precision=False, mesh=None, device=None,
                 frames_per_chunk: int = 8, device_pipeline: Optional[bool] = None,
                 quantized: bool = False, progress_notifier: ProgressNotifier = None):
        del normalize_result  # in the reference's signature; the masks are uint8
        if normalization_mode not in ("single", "first", "all"):
            raise ValueError(f"normalization_mode {normalization_mode} not valid!")
        device = resolve_device(device)
        self.invert = invert
        self.normalization_mode = normalization_mode
        self.clip_threshold = clip_threshold
        self.result_name = result_name
        engine = _Engine(model_params, "Siam_UNet", batch_size, half_precision, device,
                         quantized, mesh)
        self.engine = engine
        with tiff.TiffReader(tif_file) as reader:
            self._stream(reader, engine, resize_dim, add_tile, int(frames_per_chunk),
                         device_pipeline, _progress(show_progress, progress_notifier),
                         show_progress, quantized)

    def _stream(self, reader, engine: _Engine, resize_dim, add_tile, fpc, device_pipeline,
                progress, show_progress, quantized: bool = False) -> None:
        n_frames = reader.n_pages
        h, w = reader.page_shape(0)[:2]
        self.imgs_shape = (n_frames, h, w)
        # whole-frame tiles for resize_dim=None (siam_unet/predict.py:82-85)
        self.resize_dim = tuple(int(v) for v in (resize_dim or (h, w)))
        th, tw = self.resize_dim
        plan = TilePlan(h, w, th, tw, grid_starts(h, th, add_tile), grid_starts(w, tw, add_tile),
                        engine.device)
        mode, clip, invert = self.normalization_mode, self.clip_threshold, self.invert

        # page 0 decides the path and is reused as the first chunk's frame
        page0 = np.asarray(reader.read_page(0))
        blocker = None
        if page0.dtype not in (np.uint8, np.uint16):
            if np.issubdtype(page0.dtype, np.floating) and device_pipeline is True:
                # float pages are fused only on request: a stream cannot screen
                # later pages for NaNs beforehand, so one raises when met
                if np.isnan(page0).any():
                    blocker = "page 0 contains NaNs (handled by the host nanpercentile path)"
            else:
                blocker = (f"page dtype {page0.dtype} (the auto device pipeline streams "
                           "uint8/uint16; NaN-free float movies opt in with "
                           "device_pipeline=True)")
        use_fused = _resolve_device_pipeline(device_pipeline, blocker)
        _warn_quantized_host_path(quantized, engine, use_fused, blocker)

        page_cache = {0: page0}
        last = [None]

        def read_page(i):
            return page_cache.pop(i) if i in page_cache else np.asarray(reader.read_page(i))

        calibration = None
        if use_fused and engine._quant is not None and not engine._quant_ready:
            # the int8 scales come from pairs evenly spaced across the whole
            # movie (``predictor.py:1714-1748``), decoded once here and kept
            # in the page cache for the stream
            def cal_page(i):
                if i not in page_cache:
                    page_cache[i] = np.asarray(reader.read_page(i))
                return page_cache[i]

            cur_idx = np.unique(np.linspace(0, n_frames - 1,
                                            engine._QUANT_CAL_FRAMES).round().astype(int))
            curs = np.stack([cal_page(int(i)) for i in cur_idx])
            prevs = np.stack([cal_page(int(i) - 1 if i > 0 else min(1, n_frames - 1))
                              for i in cur_idx])
            for planes in (curs, prevs):
                if np.issubdtype(planes.dtype, np.floating) and np.isnan(planes).any():
                    # before anything is written: NaN scales would poison every chunk
                    raise ValueError("NaN in a sampled calibration page: the opt-in fused "
                                     "float pipeline requires NaN-free data — rerun with "
                                     "device_pipeline=False")
            calibration = (curs, prevs)

        def prev_of_first():
            # frame 0 pairs with frame 1 (a 1-frame movie with itself); page 1
            # stays decoded for the frame that reads it next
            if n_frames == 1:
                return page0
            page_cache[1] = read_page(1)
            return page_cache[1]

        n_chunk = min(fpc, n_frames)

        def fused_block(start):
            stop = min(start + n_chunk, n_frames)
            frames = [read_page(i) for i in range(start, stop)]
            if start:
                prev0 = last[0]
            else:
                prev0 = frames[1] if len(frames) > 1 else prev_of_first()
            last[0] = frames[-1]
            block = np.stack([prev0] + frames)
            if np.issubdtype(block.dtype, np.floating):
                if np.isnan(block).any():
                    bad = {i for i, f in enumerate(frames, start=start) if np.isnan(f).any()}
                    if start == 0 and np.isnan(prev0).any():
                        bad.add(1 if n_frames > 1 else 0)
                    raise ValueError(
                        f"NaN in page(s) {', '.join(map(str, sorted(bad)))}: the opt-in fused "
                        "float pipeline requires NaN-free data — rerun with "
                        f"device_pipeline=False (the first {start} result pages are already "
                        f"in {self.result_name})")
                block = block.astype(np.float32, copy=False)
            return _pad_frames(block, n_chunk + 1)

        n_tiles = _round_up(n_chunk * plan.per_frame, engine.batch_size)

        def host_tiles(start):
            stop = min(start + n_chunk, n_frames)
            tiles = np.empty((2, n_tiles, th, tw), np.uint8)
            for j, i in enumerate(range(start, stop)):
                current = read_page(i)
                prev = last[0] if i else prev_of_first()
                last[0] = current
                pair = _normalize_stack(np.stack([prev, current]), mode, clip, invert)
                _cut_host_tiles(pair.astype(np.uint8)[:, None], plan,
                                tiles[:, j * plan.per_frame:], "constant")
            real = (stop - start) * plan.per_frame
            tiles[:, real:] = tiles[:, real - 1:real]
            return tiles

        if use_fused:
            fn, _, _ = engine.pairs_runner(h, w, plan.xs, plan.ys, self.resize_dim, clip,
                                           invert, mode, n_chunk, calibration)
            produce, step = fused_block, (lambda x, k: {"mask": fn(x)})
        else:
            # the tiles cut on the host: forward in batches of batch_size, K3
            @torch.inference_mode()
            def step(tiles: torch.Tensor, k: int) -> Dict[str, torch.Tensor]:
                logits = engine.forward_tiles(tiles, engine.batch_size, pairs=True)
                return {"mask": sigmoid_stitch(logits.contiguous(), n_chunk, plan)}

            produce = host_tiles
        if show_progress:
            print("Predicting data ...")
        out_bytes = n_frames * (h * w + 256)

        def write_frames(masks):
            # page by page: the writer takes a (k, h, w) stack with w <= 8
            # for one (h, w, c) page
            for mask in masks:
                writer.write(mask)

        def run(sink):
            engine._run_chunks(n_frames, n_chunk, {"mask": ((h, w), np.uint8)}, produce, step,
                               progress, sink=sink)

        if not main_process():  # the other ranks of a mesh compute and write nothing
            run(lambda arrays, s: None)
            return
        with tiff.TiffWriter(self.result_name, bigtiff=out_bytes > _CLASSIC_TIFF_BYTES) as writer:
            run(lambda arrays, s: write_frames(arrays["mask"]))


class Predict3D:
    """Tiled 3D prediction with mean-overlap stitching (``predictor.py:1900``):
    a 3-axis linspace grid over a (Z, X, Y) volume, whole-volume
    normalization, a ``UNet3D`` checkpoint.  The uint8 result is kept in
    ``self.result`` and saved as a tif when ``result_name`` is given.  Runs
    on CUDA unless ``device='cpu'`` is passed; raises when no card is present
    and the CPU was not asked for.

    ``normalization_mode`` is accepted and, as in the reference and the JAX
    package, has no effect: the whole volume's percentiles normalize it
    (``predictor.py:1905-1909``).  ``add_patch`` adds one grid row per axis,
    z included (``:1929-1935``)."""

    def __init__(self, vol, result_name, model_params, network="UNet3D",
                 resize_dim=(64, 128, 128), invert=False, normalization_mode="single",
                 clip_threshold=(0.0, 99.8), add_patch=0, normalize_result=False,
                 show_progress=True, batch_size: int = 4, half_precision=False, mesh=None,
                 device=None, device_pipeline: Optional[bool] = None, quantized: bool = False,
                 progress_notifier: ProgressNotifier = None):
        del normalization_mode  # accepted and ignored, as in the reference
        device = resolve_device(device)
        if isinstance(vol, (str, os.PathLike)):
            vol = tiff.imread(vol)
        vol = np.asarray(vol)  # raw dtype kept: the fused path uploads integers
        if vol.ndim != 3:
            raise ValueError(f"Predict3D takes a (Z, X, Y) volume, got shape {vol.shape}")
        self.vol_shape = vol.shape
        self.resize_dim = tuple(int(v) for v in resize_dim)
        engine = _Engine(model_params, network, batch_size, half_precision, device, quantized,
                         mesh)
        self.engine = engine
        if engine.heads is not None:
            raise ValueError(f"{type(engine.model).__name__} is a multi-head model: "
                             "predict with PredictMultiOutput3D")

        starts = [grid_starts(e, t, add_patch) for e, t in zip(self.vol_shape, self.resize_dim)]
        n_vox = int(np.prod([len(s) for s in starts])) * int(np.prod(self.resize_dim))
        blocker = _fused_blocker(vol, device_pipeline, n_vox, _Engine.FUSED_HEADS_MAX_PX,
                                 "voxels")
        if blocker is None and any(t - e >= e for t, e in zip(self.resize_dim, self.vol_shape)):
            blocker = "tile more than 2× the volume extent (reflect pad cannot exceed the axis size)"
        use_fused = _resolve_device_pipeline(device_pipeline, blocker)
        _warn_quantized_host_path(quantized, engine, use_fused, blocker)

        if show_progress:
            print("Predicting data ...")
        for _ in _single_tick(progress_notifier, show_progress):
            if use_fused:
                if np.issubdtype(vol.dtype, np.floating) and vol.dtype != np.float32:
                    vol = vol.astype(np.float32)  # normalized in float32 on the device
                self.result = engine.fused_predict_volume(vol, *starts, self.resize_dim,
                                                          clip_threshold, invert)
            else:
                # whole-volume normalization only (unet3d/predict.py:109-117)
                norm = _normalize_stack(vol.astype(np.float32)[None], "all", clip_threshold,
                                        invert)[0]
                pads = [max(0, t - e) for t, e in zip(self.resize_dim, self.vol_shape)]
                norm = np.pad(norm, [(0, p) for p in pads], "reflect")
                plan = TilePlan3D(*self.vol_shape, self.resize_dim, *starts, engine.device)
                self.result = engine.host_predict_volume(
                    _cut_tiles(norm[None], plan, np.uint8), plan)
        if result_name is not None and main_process():
            save_as_tif(self.result, result_name, normalize=normalize_result)


def _cut_tiles(vols: np.ndarray, plan: TilePlan3D, dtype) -> np.ndarray:
    """(V, Z', X', Y') host volumes → (V·nz·nx·ny, tz, tx, ty) tiles in
    volume-major z/x/y grid order; a uint8 buffer truncates on assignment,
    as the reference's patch array does."""
    tz, tx, ty = plan.tile
    out = np.empty((len(vols) * plan.per_volume,) + plan.tile, dtype)
    n = 0
    for vol in vols:
        for z0 in plan.zs:
            for x0 in plan.xs:
                for y0 in plan.ys:
                    out[n] = vol[z0:z0 + tz, x0:x0 + tx, y0:y0 + ty]
                    n += 1
    return out


class PredictMultiOutput3D:
    """Multi-head 3D prediction with the linear-blend stitch
    (``predictor.py:2159``): per-axis tiles of min(extent, max_patch_size),
    an ``overlap_factor`` stride grid, a batched forward of a
    ``MultiOutputUnet3D`` checkpoint, per-head float32 results in
    ``self.result[head]`` — (V, C, Z, X, Y) for C > 1 channels, squeezed —
    saved as ``<result_path>/<head>.tif`` when ``result_path`` is given.
    ``'single'`` normalizes volume by volume, ``'first'``/``'all'`` with
    stack-global bounds.  Runs on CUDA unless ``device='cpu'`` is passed;
    raises when no card is present and the CPU was not asked for.

    The fused path rounds each stitched head to float16 (as JAX's does); the
    host-staged path (``device_pipeline=False``) keeps float32.  Voxels no
    tile weighs are 0."""

    def __init__(self, imgs, model_params, result_path=None, network=None,
                 max_patch_size=(64, 256, 256), overlap_factor=0.1, batch_size=2,
                 normalization_mode="single", clip_threshold=(0.0, 99.98), add_tile=0,
                 compress_tif=False, show_progress=True, half_precision=False,
                 blend_margin: int = 16, mesh=None, device=None,
                 device_pipeline: Optional[bool] = None, quantized: bool = False,
                 progress_notifier: ProgressNotifier = None):
        del add_tile  # accepted in the reference's position; the grid is overlap_factor's
        device = resolve_device(device)
        if isinstance(imgs, (str, os.PathLike)):
            imgs = tiff.imread(imgs)
        imgs = np.asarray(imgs)  # raw dtype kept: the fused path uploads integers
        if imgs.ndim == 3:
            imgs = imgs[None]  # (n_volumes, Z, X, Y)
        self.imgs_shape = imgs.shape
        engine = _Engine(model_params, network, batch_size, half_precision, device, quantized,
                         mesh)
        self.engine = engine
        self.target_keys = list(engine.hyperparams["output_heads"])
        if normalization_mode not in ("single", "first", "all"):
            raise ValueError(f"normalization_mode {normalization_mode} not valid!")

        n_vols, d, h, w = imgs.shape
        tile = tuple(min(e, m) for e, m in zip((d, h, w), max_patch_size))
        self.patch_size = tile
        starts = [overlap_starts(e, t, overlap_factor) for e, t in zip((d, h, w), tile)]
        n_vox = n_vols * int(np.prod([len(s) for s in starts])) * int(np.prod(tile))
        blocker = _fused_blocker(imgs, device_pipeline, n_vox, _Engine.FUSED_HEADS_MAX_PX,
                                 "voxels")
        use_fused = _resolve_device_pipeline(device_pipeline, blocker)
        _warn_quantized_host_path(quantized, engine, use_fused, blocker)
        factors = _blend_factors([len(s) for s in starts], tile, blend_margin)

        if show_progress:
            print("Predicting data ...")
        for _ in _single_tick(progress_notifier, show_progress):
            if use_fused:
                if np.issubdtype(imgs.dtype, np.floating) and imgs.dtype != np.float32:
                    imgs = imgs.astype(np.float32)  # normalized in float32 on the device
                preds = engine.fused_predict_heads_3d(
                    imgs, *starts, tile, clip_threshold, factors,
                    _fixed_bounds(imgs, normalization_mode, clip_threshold))
            else:
                # per volume ('single') or stack-global bounds, in [0, 1]
                # (multi_output_unet3d/predict.py:104-125)
                norm = _normalize_stack(imgs.astype(np.float32), normalization_mode,
                                        clip_threshold, scale=1.0)
                plan = TilePlan3D(d, h, w, tile, *starts, engine.device, factors)
                preds = engine.host_predict_heads_3d(_cut_tiles(norm, plan, np.float32),
                                                     n_vols, plan)

        self.result = {}
        for key in self.target_keys:
            r = preds[key]
            if r.shape[1] == 1:
                r = r[:, 0]
            self.result[key] = np.squeeze(r).astype(np.float32)
            if result_path is not None and main_process():
                os.makedirs(result_path, exist_ok=True)
                tiff.imwrite(os.path.join(result_path, f"{key}.tif"), self.result[key],
                             compress=6 if compress_tif else None)
