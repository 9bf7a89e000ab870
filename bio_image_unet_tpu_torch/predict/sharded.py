"""Whole-frame spatially sharded prediction (counterpart of
``bio_image_unet_tpu/predict/sharded.py``) — for frames or volumes too large
for one card's memory.

Instead of host tiling, the frame's H axis is split over the mesh's
``spatial`` axis and the whole U-Net forward runs on each rank's block with a
halo exchange at the block boundaries (:mod:`..parallel.halo`).  Every rank
makes the same call and returns the whole result.  Interior rows (farther
than ``halo`` from the global border) equal the unsharded forward's; border
rows see a zero frame (the halo contract).

Requirements: H divisible by (mesh spatial size × pooling stride), ``halo``
≥ the model's receptive-field half-width and a multiple of the pooling
stride (2^levels: 16 for the 4-level family, 8 for ``BabyUnet`` and the
3-level volumetric trunks).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import checkpoint
from ..models import get_model
from ..parallel import spatial_shard_apply
from ..utils.device import resolve_device
from .fastpath import folded_forward
from .normalize import _normalize_stack


def _resolve_forward(model_params, network, half_precision: bool, device):
    """Load a checkpoint and build the single-output forward both sharded
    predictors share (``sharded.py:29``): the BN-folded forward of
    ``predict/fastpath.py`` (every model of the port has BatchNorm to fold,
    so JAX's flax fallback for variables without ``batch_stats``, ``:51-53``,
    has no counterpart).  ``forward(x)`` maps (N, 1, ...) float32 input in
    [0, 1] to float32 probabilities.  Returns ``(model, forward)``."""
    state = checkpoint.load(model_params)
    hp = dict(state["hyperparams"])
    name = network or hp.get("model_name") or hp.get("network")
    if name is None:
        raise ValueError("network is not defined")
    if name in ("Unet_v0", "BabyUnet"):
        half_precision = False  # the legacy models run float32 only
    dtype = torch.bfloat16 if half_precision else torch.float32
    model = get_model(name, **hp)
    model.load_state_dict(state["state_dict"], strict=True)
    fold = folded_forward(model.eval(), dtype, device)

    @torch.inference_mode()
    def forward(t):
        return fold(t.to(dtype))[0]

    return model, forward


def _pooling_stride(model) -> int:
    """2^levels of the resolved model (16 for the 4-level 2D trunks, 8 for
    ``BabyUnet`` and the 3-level volumetric trunks)."""
    from ..models.legacy import BabyUnet
    from ..models.unet3d import MultiOutputUnet3D, UNet3D

    levels = getattr(model, "levels", None)
    if levels is None:
        levels = 3 if isinstance(model, (BabyUnet, UNet3D, MultiOutputUnet3D)) else 4
    return 2 ** levels


def _check_divisible(extent: int, n_spatial: int, stride: int, halo: int,
                     what: str) -> None:
    if extent % (n_spatial * stride) != 0:
        raise ValueError(
            f"{what} {extent} must be divisible by mesh_spatial×{stride} "
            f"({n_spatial * stride})"
        )
    if halo % stride != 0:
        raise ValueError(f"halo {halo} must be a multiple of {stride}")


def _quantize(probs: torch.Tensor) -> np.ndarray:
    """``(probs·255).astype(uint8)``: truncation (``sharded.py:110``)."""
    return (probs.float() * 255.0).to(torch.uint8).cpu().numpy()


def predict_frames_spatial_sharded(
    imgs,
    model_params,
    mesh,
    halo: int = 128,
    network=None,
    normalization_mode: str = "single",
    clip_threshold=(0.0, 99.8),
    invert: bool = False,
    half_precision: bool = False,
    device=None,
):
    """Predict (N, H, W) frames (or one (H, W) frame) with the model's
    forward split over the mesh's ``spatial`` axis (on a 2-D mesh the frames
    also split over ``data`` when that divides).  Returns uint8
    probability·255 masks of the input's shape.  Runs on CUDA unless
    ``device='cpu'`` is passed (with a gloo mesh)."""
    imgs = np.asarray(imgs)
    squeeze = imgs.ndim == 2
    if squeeze:
        imgs = imgs[None]
    device = resolve_device(device)
    mesh.check_device(device)

    model, forward = _resolve_forward(model_params, network, half_precision, device)
    n_spatial = mesh.shape["spatial"]
    stride = _pooling_stride(model)
    _check_divisible(imgs.shape[1], n_spatial, stride, halo, "frame height")

    norm = _normalize_stack(imgs, normalization_mode,
                            clip_threshold, invert).astype(np.uint8)
    x = torch.from_numpy(norm[:, None].astype(np.float32) / 255.0).to(device)

    result = _quantize(spatial_shard_apply(forward, x, mesh, halo=halo))[:, 0]
    return result[0] if squeeze else result


def predict_volume_spatial_sharded(
    vol,
    model_params,
    mesh,
    halo: int = 64,
    network=None,
    clip_threshold=(0.0, 99.8),
    invert: bool = False,
    half_precision: bool = False,
    device=None,
):
    """Predict one (Z, H, W) volume with the 3D U-Net's forward split over
    the mesh's ``spatial`` axis along H.  Whole-volume normalization (the 3D
    family's only mode).  Returns uint8 probability·255 masks (Z, H, W).

    Requirements: H divisible by (mesh spatial × 8) (the 3-level trunk's
    pooling stride) and ``halo`` a multiple of 8 and ≥ the receptive-field
    half-width.  Runs on CUDA unless ``device='cpu'`` is passed."""
    vol = np.asarray(vol)
    device = resolve_device(device)
    mesh.check_device(device)
    model, forward = _resolve_forward(model_params, network, half_precision, device)
    n_spatial = mesh.shape["spatial"]
    stride = _pooling_stride(model)
    _check_divisible(vol.shape[1], n_spatial, stride, halo, "volume height")

    # uint8 quantization matches Predict3D's patch buffer, so interior voxels
    # equal the tiled path's
    norm = _normalize_stack(vol[None], "all", clip_threshold,
                            invert)[0].astype(np.uint8)
    x = torch.from_numpy(norm[None, None].astype(np.float32) / 255.0).to(device)

    # (1, 1, Z, H, W): H is axis 3
    return _quantize(spatial_shard_apply(forward, x, mesh, halo=halo, spatial_axis=3))[0, 0]
