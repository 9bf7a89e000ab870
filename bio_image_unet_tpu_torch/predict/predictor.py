"""Tiled 2D prediction on the card (counterpart of
``bio_image_unet_tpu/predict/predictor.py``: ``_Engine``, ``Predict`` and
``PredictMultiOutput``).

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
"""

from __future__ import annotations

import os
import warnings
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .. import checkpoint
from ..data import tiff
from ..models import get_model
from ..ops.histogram import clip_bounds
from ..ops.stitch import margin_stitch, sigmoid_stitch, tile_sum
from ..progress import ProgressNotifier
from ..utils.device import resolve_device
from ..utils.utils import save_as_tif
from .fastpath import folded_forward
from .normalize import _normalize_stack, _percentile, normalize_tile, normalize_tile_float
from .tiling import TilePlan, _margin_factors, grid_starts

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
                 half_precision: bool = False, device=None):
        self.device = resolve_device(device)
        state = checkpoint.load(model_params)
        hp = dict(state["hyperparams"])
        self.hyperparams = hp
        name = network or hp.get("model_name") or hp.get("network")
        if name is None:
            raise ValueError("network is not defined")
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

    def batch_policy(self, per_chunk: int, th: int, tw: int) -> int:
        """One forward step per ~16M tile pixels; the user's batch_size is
        the floor (``predictor.py:716``)."""
        return max(self.batch_size, min(per_chunk, (1 << 24) // (th * tw)))

    @torch.inference_mode()
    def forward_tiles(self, tiles_u8: torch.Tensor, bs: int) -> torch.Tensor:
        """(n, th, tw) uint8 tiles, n a multiple of ``bs`` → (n, 1, th, tw)
        logits in the working dtype."""
        outs = []
        for s in range(0, tiles_u8.shape[0], bs):
            x = tiles_u8[s:s + bs, None].to(self.dtype) * self._scale
            outs.append(self.forward.logits(x))
        return outs[0] if len(outs) == 1 else torch.cat(outs)

    def fused_runner(self, h: int, w: int, xs, ys, resize_dim, clip_threshold,
                     invert: bool = False, fixed_bounds=None, n_frames: int = None):
        """The fused chunk program for this workload and its fixed frame
        count: ``fn(chunk)`` maps (n_chunk, h, w) raw frames on the engine's
        device to (n_chunk, h, w) uint8 masks on the device, all of it K1 →
        K2 → forward → K3 with no host round trip.  Benches time it on a
        device-resident movie."""
        th, tw = resize_dim
        plan = TilePlan(h, w, th, tw, xs, ys, self.device)
        n_chunk = min(self.FUSED_CHUNK_FRAMES, n_frames or self.FUSED_CHUNK_FRAMES)
        n = n_chunk * plan.per_frame
        bs = self.batch_policy(n, th, tw)
        n_pad = _round_up(n, bs)
        bounds_dev = None
        if fixed_bounds is not None:
            bounds_dev = torch.as_tensor(np.asarray(fixed_bounds, np.float32).reshape(4, 1),
                                         device=self.device)
        q_lo, q_hi = float(clip_threshold[0]), float(clip_threshold[1])

        @torch.inference_mode()
        def fn(chunk: torch.Tensor) -> torch.Tensor:
            bounds = bounds_dev if bounds_dev is not None else clip_bounds(chunk, q_lo, q_hi)
            tiles = normalize_tile(chunk, bounds, plan, n_pad, invert)
            logits = self.forward_tiles(tiles, bs)
            return sigmoid_stitch(logits.contiguous(), chunk.shape[0], plan)

        return fn, n_chunk

    def fused_predict_frames(self, imgs: np.ndarray, xs, ys, resize_dim,
                             clip_threshold, invert: bool, progress=None,
                             fixed_bounds: Optional[np.ndarray] = None) -> np.ndarray:
        """(N, h, w) uint8/uint16/float32 frames → (N, h, w) uint8 masks
        through the fused device pipeline (``predictor.py:841``)."""
        n_frames, h, w = imgs.shape
        fn, n_chunk = self.fused_runner(h, w, xs, ys, resize_dim, clip_threshold,
                                        invert, fixed_bounds, n_frames)
        return self._run_chunks(
            n_frames, n_chunk, {"mask": ((h, w), np.uint8)},
            lambda s: _pad_frames(imgs[s:s + n_chunk], n_chunk),
            lambda x, k: {"mask": fn(x)}, progress)["mask"]

    def host_predict_frames(self, norm: np.ndarray, xs, ys, resize_dim,
                            progress=None) -> np.ndarray:
        """Host-staged path: (N, h, w) float32 frames already normalized to
        [0, 255] on the host are reflect-padded and cut into uint8 tiles in
        numpy (``predictor.py:1597 _split``); the forward and K3 run on the
        device in batches of ``batch_size``."""
        n_frames, h, w = norm.shape
        th, tw = resize_dim
        plan = TilePlan(h, w, th, tw, xs, ys, self.device)
        n_chunk = min(self.FUSED_CHUNK_FRAMES, n_frames)
        bs = self.batch_size
        n_pad = _round_up(n_chunk * plan.per_frame, bs)

        def produce(s):
            block = _pad_frames(norm[s:s + n_chunk], n_chunk)
            if th > h:
                block = np.pad(block, ((0, 0), (0, th - h), (0, 0)), "reflect")
            if tw > w:
                block = np.pad(block, ((0, 0), (0, 0), (0, tw - w)), "reflect")
            # uint8 patch buffer: assignment truncates, as the reference does
            patches = np.empty((n_pad, th, tw), np.uint8)
            n = 0
            for img in block:
                for x0 in plan.xs:
                    for y0 in plan.ys:
                        patches[n] = img[x0:x0 + th, y0:y0 + tw]
                        n += 1
            patches[n:] = patches[n - 1]
            return patches

        @torch.inference_mode()
        def step(patches: torch.Tensor, k: int) -> Dict[str, torch.Tensor]:
            logits = self.forward_tiles(patches, bs)
            return {"mask": sigmoid_stitch(logits.contiguous(), n_chunk, plan)}

        return self._run_chunks(n_frames, n_chunk, {"mask": ((h, w), np.uint8)},
                                produce, step, progress)["mask"]

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

    @torch.inference_mode()
    def forward_heads(self, tiles: torch.Tensor, bs: int) -> Dict[str, torch.Tensor]:
        """(n, th, tw) float tiles, n a multiple of ``bs`` → ``{head: (n, C,
        th, tw) float16}``, contiguous.  The dtype contract of
        ``_forward_with`` (``predictor.py:454-459``): tiles are cast to the
        working dtype, each head's 1×1 conv output goes to float32 for its
        activation, and every head is rounded to float16 before any stitch."""
        outs = {name: [] for name in self.heads}
        for s in range(0, tiles.shape[0], bs):
            x = tiles[s:s + bs, None].to(self.dtype)
            for name, v in self.forward.heads_out(x).items():
                outs[name].append(v.half())
        return {name: (v[0] if len(v) == 1 else torch.cat(v)).contiguous()
                for name, v in outs.items()}

    def heads_runner(self, h: int, w: int, xs, ys, patch_size, clip_threshold, factors,
                     fixed_bounds=None, n_frames: int = None, bs: Optional[int] = None):
        """The fused multi-head chunk program: ``fn(chunk, k)`` maps
        (n_chunk, h, w) raw frames on the device, of which the first ``k`` are
        real, to ``({head: (n_chunk, C, h, w) float16}, {head: float64 sum of
        the real tiles})`` — K1 → K2h → forward → K5 (and K5s where the grid
        leaves pixels uncovered).  Returns ``(fn, n_chunk, plan)``; benches
        time ``fn`` on a device-resident movie."""
        ph, pw = patch_size
        plan = TilePlan(h, w, ph, pw, xs, ys, self.device, factors)
        n_chunk = min(self.FUSED_CHUNK_FRAMES, n_frames or self.FUSED_CHUNK_FRAMES)
        n = n_chunk * plan.per_frame
        bs = bs or self.heads_batch(n, ph, pw)
        n_pad = _round_up(n, bs)
        bounds_dev = None
        if fixed_bounds is not None:
            bounds_dev = torch.as_tensor(np.asarray(fixed_bounds, np.float32).reshape(4, 1),
                                         device=self.device)
        q_lo, q_hi = float(clip_threshold[0]), float(clip_threshold[1])
        need_fill = bool(plan.uncovered.any())

        @torch.inference_mode()
        def fn(chunk: torch.Tensor, k: int):
            bounds = bounds_dev if bounds_dev is not None else clip_bounds(chunk, q_lo, q_hi)
            tiles = normalize_tile_float(chunk, bounds, plan, n_pad, self.dtype)
            heads = self.forward_heads(tiles, bs)
            out = {name: margin_stitch(t, n_chunk, plan, torch.float16)
                   for name, t in heads.items()}
            sums = ({name: tile_sum(t, k * plan.per_frame) for name, t in heads.items()}
                    if need_fill else {})
            return out, sums

        return fn, n_chunk, plan

    def _heads_shapes(self, h: int, w: int, dtype) -> Dict[str, tuple]:
        return {name: ((cfg["channels"], h, w), dtype) for name, cfg in self.heads.items()}

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
        the OOM back-off's batch."""
        n_frames, h, w = imgs.shape
        fn, n_chunk, plan = self.heads_runner(h, w, xs, ys, patch_size, clip_threshold,
                                              factors, fixed_bounds, n_frames, _bs)
        totals = {}

        def step(x, k):
            out, sums = fn(x, k)
            for name, v in sums.items():
                totals[name] = v if name not in totals else totals[name] + v
            return out

        def run():
            res = self._run_chunks(n_frames, n_chunk, self._heads_shapes(h, w, np.float16),
                                   lambda s: _pad_frames(imgs[s:s + n_chunk], n_chunk),
                                   step, progress)
            self._fill(res, totals, plan, n_frames)
            return res

        bs = _bs or self.heads_batch(n_chunk * plan.per_frame, *patch_size)
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

    def _dispatch_with_oom_backoff(self, run: Callable, bs: int, retry: Callable):
        """Run ``run()``; when the card runs out of memory, halve the forward
        batch, warn and ``retry(smaller)`` on the card (``predictor.py:1160``).
        It never moves to the CPU."""
        try:
            return run()
        except torch.cuda.OutOfMemoryError:
            if bs <= 1:
                raise
        # retried outside the handler, so the failed attempt's tensors are freed
        smaller = max(1, bs // 2)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
        warnings.warn(f"the fused program ran out of device memory at batch {bs}; "
                      f"retrying with batch {smaller}", stacklevel=3)
        return retry(smaller)

    def _run_chunks(self, n_frames: int, n_chunk: int, outputs: Dict[str, tuple],
                    produce: Callable, step: Callable, progress=None) -> Dict[str, np.ndarray]:
        """Drive ``step`` over the movie chunk by chunk: ``produce(start)``
        gives chunk ``start``'s host array (fixed shape), ``step(x, k)`` maps
        its device copy, whose first ``k`` frames are real, to ``{name:
        (n_chunk, *shape) tensor}`` on the device, one for each ``outputs``
        entry ``name: (shape, numpy dtype)``.  Returns ``{name: (n_frames,
        *shape) array}``; tail frames past ``n_frames`` are cropped."""
        result = {name: np.empty((n_frames,) + tuple(shape), dt)
                  for name, (shape, dt) in outputs.items()}
        starts = list(range(0, n_frames, n_chunk))
        it = progress.iterator(starts) if progress is not None else starts
        if self.device.type == "cpu":
            for s in it:
                k = min(n_chunk, n_frames - s)
                out = step(torch.from_numpy(np.ascontiguousarray(produce(s))), k)
                for name, r in result.items():
                    r[s:s + k] = out[name][:k].numpy()
            return result

        dev = self.device
        ring = self.FUSED_PENDING_CHUNKS
        compute = torch.cuda.current_stream(dev)
        upload, download = torch.cuda.Stream(dev), torch.cuda.Stream(dev)
        in_host, in_dev, out_host = [None] * ring, [None] * ring, [None] * ring
        pending = [None] * ring  # (download-done event, start, frames)

        def finish(slot):
            ev, s, k = pending[slot]
            ev.synchronize()
            for name, r in result.items():
                r[s:s + k] = out_host[slot][name][:k].numpy()
            pending[slot] = None

        for i, s in enumerate(it):
            slot = i % ring
            if pending[slot] is not None:
                # the slot's previous chunk is downloaded, hence computed and
                # uploaded: its three buffers are free again
                finish(slot)
            host = produce(s)
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
            out = step(in_dev[slot], k)
            computed = torch.cuda.Event()
            computed.record(compute)
            with torch.cuda.stream(download):
                download.wait_event(computed)
                for name, t in out.items():
                    out_host[slot][name].copy_(t, non_blocking=True)
                    t.record_stream(download)
                downloaded = torch.cuda.Event()
                downloaded.record(download)
            pending[slot] = (downloaded, s, k)
        for slot in range(ring):
            if pending[slot] is not None:
                finish(slot)
        return result


class Predict:
    """Tiled 2D prediction with mean-overlap stitching (``predictor.py:1465``).

    ``imgs`` may be an array or a tif path; the network is rebuilt from the
    checkpoint's hyperparams.  Results are uint8-quantized probabilities,
    kept in ``self.result`` and saved as a float16 tif when ``result_name``
    is given.  Runs on CUDA unless ``device='cpu'`` is passed; raises when no
    card is present and the CPU was not asked for.
    """

    def __init__(self, imgs, result_name, model_params, network=None,
                 resize_dim=(512, 512), invert=False, normalization_mode="single",
                 clip_threshold=(0.0, 99.8), add_tile=0, normalize_result=False,
                 show_progress=True, batch_size: int = 8, half_precision=False,
                 mesh=None, device=None, device_pipeline: Optional[bool] = None,
                 quantized: bool = False,
                 progress_notifier: ProgressNotifier = None):
        if mesh is not None:
            raise NotImplementedError("mesh= (multi-GPU predict) is not ported yet")
        if quantized:
            raise NotImplementedError("quantized=True (int8 inference) is not ported yet")
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

        engine = _Engine(model_params, network, batch_size, half_precision, device)
        self.engine = engine
        if engine.hyperparams.get("in_channels", 1) != 1:
            raise ValueError("tiled 2D Predict supports single-channel input")
        if engine.hyperparams.get("out_channels", 1) != 1:
            raise NotImplementedError("multi-channel output is not ported yet")
        if engine.heads is not None:
            raise ValueError(f"{type(engine.model).__name__} is a multi-head model: "
                             "predict with PredictMultiOutput")

        fused_blocker = None
        if not (imgs.dtype in (np.uint8, np.uint16)
                or np.issubdtype(imgs.dtype, np.floating)):
            fused_blocker = (f"input dtype {imgs.dtype} (the fused program "
                             "normalizes uint8/uint16/float on device)")
        elif (np.issubdtype(imgs.dtype, np.floating)
              and device_pipeline is not False
              and np.isnan(imgs).any()):
            fused_blocker = ("float input contains NaNs (handled by the "
                             "host nanpercentile path)")
        elif any(self.resize_dim[a] - imgs.shape[a + 1] >= imgs.shape[a + 1]
                 for a in range(2)):
            fused_blocker = ("tile more than 2× the frame extent (reflect "
                             "pad cannot exceed the axis size)")
        use_fused = _resolve_device_pipeline(device_pipeline, fused_blocker)

        h, w = self.imgs_shape[1], self.imgs_shape[2]
        xs = grid_starts(h, self.resize_dim[0], add_tile)
        ys = grid_starts(w, self.resize_dim[1], add_tile)
        progress = progress_notifier if (show_progress and progress_notifier) else (
            ProgressNotifier.progress_notifier_tqdm() if show_progress else None)
        if show_progress:
            print("Predicting data ...")

        if use_fused:
            if np.issubdtype(imgs.dtype, np.floating) and imgs.dtype != np.float32:
                # float16/float64 movies normalize in float32 on the device
                imgs = imgs.astype(np.float32)
            fixed_bounds = None
            if normalization_mode in ("first", "all"):
                # stack-global bounds once on the host; after clipping the
                # stack extremes are exactly (lo, hi) (predictor.py:1544)
                ref = imgs[0] if normalization_mode == "first" else imgs
                lo = _percentile(ref, clip_threshold[0])
                hi = _percentile(ref, clip_threshold[1])
                fixed_bounds = np.array([lo, hi, lo, hi], np.float32)
            elif normalization_mode != "single":
                raise ValueError(f"normalization_mode {normalization_mode} not valid!")
            result = engine.fused_predict_frames(
                imgs, xs, ys, self.resize_dim, clip_threshold, invert,
                progress=progress, fixed_bounds=fixed_bounds)
        else:
            norm = _normalize_stack(imgs, normalization_mode, clip_threshold, invert)
            result = engine.host_predict_frames(norm, xs, ys, self.resize_dim,
                                                progress=progress)
        self.result = np.squeeze(result)
        if result_name is not None:
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
        if mesh is not None:
            raise NotImplementedError("mesh= (multi-GPU predict) is not ported yet")
        if quantized:
            raise NotImplementedError("quantized=True (int8 inference) is not ported yet")
        device = resolve_device(device)
        if isinstance(imgs, (str, os.PathLike)):
            imgs = tiff.imread(imgs)
        imgs = np.asarray(imgs)  # raw dtype kept: the fused path uploads integers
        if imgs.ndim == 2:
            imgs = imgs[None]
        self.imgs_shape = imgs.shape
        n_frames, h, w = imgs.shape

        engine = _Engine(model_params, network, batch_size, half_precision, device)
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

        fused_blocker = None
        if not (imgs.dtype in (np.uint8, np.uint16)
                or np.issubdtype(imgs.dtype, np.floating)):
            fused_blocker = (f"input dtype {imgs.dtype} (the fused program "
                             "normalizes uint8/uint16/float on device)")
        elif (np.issubdtype(imgs.dtype, np.floating)
              and device_pipeline is not False
              and np.isnan(imgs).any()):
            fused_blocker = ("float input contains NaNs (handled by the "
                             "host nanpercentile path)")
        elif n_px > _Engine.FUSED_HEADS_MAX_PX:
            fused_blocker = (f"{n_px} patch pixels exceed the single-program "
                             "budget (the uncovered-pixel fill is a "
                             "whole-stack statistic)")
        elif ph - h >= h or pw - w >= w:
            fused_blocker = ("patch more than 2× the frame extent (reflect "
                             "pad cannot exceed the axis size)")
        use_fused = _resolve_device_pipeline(device_pipeline, fused_blocker)

        progress = progress_notifier if (show_progress and progress_notifier) else (
            ProgressNotifier.progress_notifier_tqdm() if show_progress else None)
        if show_progress:
            print("Predicting data ...")
        factors = _margin_factors((len(xs), len(ys)), (ph, pw), safe_margin)
        if use_fused:
            if np.issubdtype(imgs.dtype, np.floating) and imgs.dtype != np.float32:
                imgs = imgs.astype(np.float32)  # normalized in float32 on the device
            fixed_bounds = None
            if normalization_mode in ("first", "all"):
                # after clipping the stack extremes are exactly (lo, hi)
                # (predictor.py:2096-2100)
                ref = imgs[0] if normalization_mode == "first" else imgs
                lo = _percentile(ref, clip_threshold[0])
                hi = _percentile(ref, clip_threshold[1])
                fixed_bounds = np.array([lo, hi, lo, hi], np.float32)
            elif normalization_mode != "single":
                raise ValueError(f"normalization_mode {normalization_mode} not valid!")
            preds = engine.fused_predict_heads(imgs, xs, ys, (ph, pw), clip_threshold,
                                               factors, fixed_bounds, progress)
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
            if result_path is not None:
                os.makedirs(result_path, exist_ok=True)
                tiff.imwrite(os.path.join(result_path, f"{key}.tif"), self.result[key],
                             compress=6 if compress_tif else None)
