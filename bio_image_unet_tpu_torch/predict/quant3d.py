"""w8a8 int8 prediction of the 3-level volumetric trunks, opt-in with
``quantized=True`` (counterpart of ``bio_image_unet_tpu/predict/quant3d.py``):
``UNet3D`` with its transposed-conv or trilinear decoder and
``MultiOutputUnet3D`` with either of its decoders.

The JAX package's scale-folded formulation (``quant3d.py:145-256``):

- **Sites** (:func:`_sites_3d`): one per-tensor activation scale for every
  conv output, ``e1..e6``, ``m1``, ``m2``, ``up<i>`` where the decoder has
  an up conv (none for trilinear: the upsampled tensor keeps its input's
  scale) and ``d1..d6``; calibrated by the bf16 folded forward with its
  recorder (:func:`build_calibrator_3d`).
- **Weights** are quantized once the scales are known (:func:`_quantize`):
  each conv's per-input-channel activation scales are multiplied into its
  float32 kernel before per-output-channel quantization (``k'[o, c] =
  k[o, c]·s_in(c)``; ``decode<2i-1>`` takes ``[s_up]·c_up ++ [s_skip]·
  c_skip``), the up-convs per tensor with their scalar input scale folded
  in.  So every dequant is ``y·sw + bias`` (K7v, K8v with no ``s_in``), and
  a decoder level's concat buffer holds the up tensor and the skip as raw
  int8 at their own scales: K8v writes its first channels, K9 copies the
  skip into the rest with ``s_a = s_b = 1`` (exact).
- **Graph** (:class:`Int8UNet3D`, NDHWC int8): ``encode1`` in bf16 and K9 to
  int8; K7v convs; K10v max pools, or the nearest ×0.5 stride slice of
  ``MultiOutputUnet3D``'s nearest decoder (exact on int8); the up path by
  K8v, by the nearest ×2 repeat and a K7v conv, or by K11v: trilinear on
  the int8 values in float32 rounded back at the same scale (half to even,
  clipped: a convex combination stays in range); ``d6`` dequantized to bf16
  by K9;
  the 1×1×1 head(s) as in 2D.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..ops.int8 import maxpool_i8_3d, qconv3x3x3, qconvt2x2x2, requant, upsample2x_i8_3d
from .fastpath import FoldedUNet3D, fold_unet2d
from .quant import Int8Forward, Int8Weights, act_scales, recording_calibrator

# decoder level i concatenates the up tensor with this encoder site's output
_SKIP_SITE = {1: "e6", 2: "e4", 3: "e2"}


def _sites_3d(interp: bool, multi: bool) -> list:
    """Activation-scale sites in calibration-vector order (``quant3d.py:87``)."""
    sites = [f"e{i}" for i in range(1, 7)] + ["m1", "m2"]
    for i in (1, 2, 3):
        if (not interp) or multi:
            sites.append(f"up{i}")
        sites += [f"d{2 * i - 1}", f"d{2 * i}"]
    return sites


def build_calibrator_3d(forward: FoldedUNet3D) -> Callable:
    """``cal_fn(x) -> (len(_sites_3d),) float32`` per-site ``max|a|`` over a
    batch of (N, 1, D, H, W) tiles in [0, 1] (``quant3d.py:99``): ``forward``
    is the bf16 folded forward, run once with its recorder."""
    return recording_calibrator(forward, _sites_3d(forward.interp, forward.heads is not None))


def _conv_specs(folded: Dict[str, dict], interp: bool, multi: bool) -> tuple:
    """``(convs, tconvs)``: each conv's input-scale layout ``[(site,
    channels), ...]`` and each transposed conv's input site
    (``quant3d.py:172-207``)."""
    convs = {name: [(site, None)] for name, site in (
        ("encode2", "e1"), ("encode3", "e2"), ("encode4", "e3"), ("encode5", "e4"),
        ("encode6", "e5"), ("middle_conv1", "e6"), ("middle_conv2", "m1"))}
    tconvs = {}
    h_site = "m2"
    for i in (1, 2, 3):
        if not interp:
            tconvs[f"up{i}"] = h_site
            u_site = f"up{i}"
        elif multi:
            convs[f"up{i}_conv"] = [(h_site, None)]
            u_site = f"up{i}"
        else:
            u_site = h_site  # trilinear keeps its input's scale
        skip = _SKIP_SITE[i]
        c_skip = folded[f"encode{skip[1]}"]["weight"].shape[0]
        c_in = folded[f"decode{2 * i - 1}"]["weight"].shape[1]
        convs[f"decode{2 * i - 1}"] = [(u_site, c_in - c_skip), (skip, c_skip)]
        convs[f"decode{2 * i}"] = [(f"d{2 * i - 1}", None)]
        h_site = f"d{2 * i}"
    return convs, tconvs


def _quantize(folded: Dict[str, dict], scales: Dict[str, float], interp: bool,
              heads, device) -> Int8Weights:
    """The int8 store of a folded 3D trunk at these site scales
    (``quant3d.py:209 _build_pack``): the activation scales folded into the
    float32 kernels, then ``Int8Weights``' quantization."""
    convs, tconvs = _conv_specs(folded, interp, heads is not None)
    store = Int8Weights(device)
    for name in ["encode1"] + (["final"] if heads is None
                               else [f"output_layers.{n}" for n in heads]):
        store.float_layer(name, folded[name])
    for name, spec in convs.items():
        c_in = folded[name]["weight"].shape[1]
        store.quant_conv(name, folded[name], s_in=np.concatenate(
            [np.full(c_in if n is None else n, scales[site], np.float32) for site, n in spec]))
    for name, site in tconvs.items():
        store.quant_conv(name, folded[name], per_channel=False, s_in=scales[site])
    return store


def _up_nearest(h: torch.Tensor) -> torch.Tensor:
    """Nearest ×2 of every spatial axis of an NDHWC tensor (exact on int8)."""
    n, d, hh, w, c = h.shape
    return h[:, :, None, :, None, :, None].expand(n, d, 2, hh, 2, w, 2, c).reshape(
        n, 2 * d, 2 * hh, 2 * w, c)


class Int8UNet3D(Int8Forward):
    """The 3D int8 forward (``quant3d.py:262 apply_fn``), with the interface
    of :class:`.quant.Int8Forward` on (N, 1, D, H, W) tiles."""

    def __init__(self, weights: Int8Weights, act_maxes, interp: bool, heads=None):
        super().__init__(weights, _sites_3d(interp, heads is not None), act_maxes, heads)
        self.interp = bool(interp)

    def _qconv(self, x: torch.Tensor, name: str, site: str, out=None, offset: int = 0):
        return qconv3x3x3(x, *self.w.conv[name], self.s[site], out, offset)

    def trunk(self, x: torch.Tensor, prev: None = None) -> torch.Tensor:
        """``decode6``'s output dequantized to bf16, (N, C, D, H, W) (a view
        of an NDHWC tensor)."""
        s, c, interp, multi = self.s, self._qconv, self.interp, self.heads is not None
        if multi and interp:  # nearest ×0.5: every second voxel, exact on int8
            def down(q):
                return q[:, ::2, ::2, ::2].contiguous()
        else:
            down = maxpool_i8_3d
        e1 = self._encode1(x.to(torch.bfloat16)).permute(0, 2, 3, 4, 1).contiguous()
        q2 = c(requant(e1, 1.0, s["e1"]), "encode2", "e2")
        q4 = c(c(down(q2), "encode3", "e3"), "encode4", "e4")
        q6 = c(c(down(q4), "encode5", "e5"), "encode6", "e6")
        h = c(c(down(q6), "middle_conv1", "m1"), "middle_conv2", "m2")
        for i, skip in zip((1, 2, 3), (q6, q4, q2)):
            # one (..., c_up + c_skip) buffer a level: the up path writes its
            # first c_up channels, the raw int8 skip the rest (its scale
            # lives in the decode conv's kernel)
            if not interp:
                up = self.w.conv[f"up{i}"]
                c_up = up[0].shape[-2]
            elif multi:
                c_up = self.w.conv[f"up{i}_conv"][0].shape[0]
            else:
                c_up = h.shape[-1]
            buf = skip.new_empty(skip.shape[:-1] + (c_up + skip.shape[-1],))
            if not interp:
                qconvt2x2x2(h, *up, s[f"up{i}"], out=buf)
            elif multi:
                c(_up_nearest(h), f"up{i}_conv", f"up{i}", out=buf)
            else:
                # linearity: up(q)·s = up(q·s); K11v interpolates the int8
                # values in float32 and rounds them back at h's scale
                upsample2x_i8_3d(h, out=buf)
            requant(skip, 1.0, 1.0, out=buf, offset=c_up)
            h = c(c(buf, f"decode{2 * i - 1}", f"d{2 * i - 1}"), f"decode{2 * i}", f"d{2 * i}")
        return requant(h, s["d6"]).permute(0, 4, 1, 2, 3)


def build_int8_apply_3d(model, device, folded: Optional[Dict[str, dict]] = None) -> Callable:
    """``make_forward(act_maxes) -> Int8UNet3D`` (``quant3d.py:145``): each
    call quantizes the weights (``model``'s folded float32 parameters, or
    ``folded`` in the layout of ``fastpath.fold_unet2d``) with the scales of
    that calibration folded in."""
    folded = fold_unet2d(model.state_dict()) if folded is None else folded
    interp = bool(model.use_interpolation)
    heads = getattr(model, "heads", None)
    sites = _sites_3d(interp, heads is not None)

    def make_forward(act_maxes) -> Int8UNet3D:
        scales = dict(zip(sites, act_scales(act_maxes)))
        store = _quantize(folded, scales, interp, heads, device)
        return Int8UNet3D(store, act_maxes, interp, heads)

    return make_forward
