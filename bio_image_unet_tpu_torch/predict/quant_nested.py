"""w8a8 int8 prediction of UNet++ (``MultiOutputNestedUNet`` and its
``_3Levels`` form), opt-in with ``quantized=True`` under
``BIU_INT8_EXPERIMENTAL`` (counterpart of
``bio_image_unet_tpu/predict/quant_nested.py``).

The JAX package's scale-folded formulation of the dense grid
(``quant_nested.py:122-267``):

- **Sites** (:func:`_sites_nested`): two per VGG block, ``g<i>_<j>a`` and
  ``g<i>_<j>b`` after its stage-1 and stage-2 convs, in grid order
  (:func:`_grid_order`); calibrated by the bf16 ``FoldedNestedUNet`` with
  its recorder (:func:`build_calibrator_nested`).
- **Weights** are quantized once the scales are known (:func:`_quantize`):
  each conv's per-input-channel activation scales (every partner's, and the
  upsampled deeper cell's) are multiplied into its float32 kernel before the
  per-output-channel quantization, so every int8 conv is K7 with ``s_in =
  1`` and every partner enters its consumer's concat buffer as raw int8.
- **Graph** (:class:`Int8NestedUNet`, NHWC int8): ``g0_0``'s stage 1 in bf16
  on cuDNN, then K9 to int8; every other conv K7 (column 0 at the level's
  dilation, the grid cells at 1); K10 pools column 0; one int8 buffer a
  grid row holds its cells side by side (:meth:`Int8NestedUNet.trunk`), so
  cell ``x_{k,j}`` reads its partners ``x_{k,0..j-1}`` in place and K11, the
  ×2 ``align_corners=True`` bilinear of the deeper cell's int8 values at
  their own scale (linear, so ``up(q)·s = up(q·s)``), writes straight after
  them: the concat costs no copy; the last cell dequantized to bf16 by K9
  and the 1×1 heads as in 2D (deep supervision: level L's only).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..ops.int8 import maxpool_i8, qconv3x3, requant, upsample2x_i8
from .fastpath import FoldedNestedUNet, fold_unet2d
from .quant import Int8Forward, Int8Weights, act_scales, recording_calibrator


def _grid_order(L: int) -> list:
    """Grid blocks (i, j) in forward order (``quant_nested.py:62``)."""
    order = [(0, 0)]
    for i in range(1, L + 1):
        order.append((i, 0))
        for k in range(i - 1, -1, -1):
            order.append((k, i - k))
    return order


def _sites_nested(L: int) -> list:
    """Activation-scale sites in calibration-vector order: two per VGG block
    (``quant_nested.py:72``)."""
    sites = []
    for i, j in _grid_order(L):
        sites += [f"g{i}_{j}a", f"g{i}_{j}b"]
    return sites


def build_calibrator_nested(forward: FoldedNestedUNet) -> Callable:
    """``cal_fn(x) -> (len(_sites_nested(L)),) float32`` per-site ``max|a|``
    over a batch of (N, 1, h, w) tiles in [0, 1] (``quant_nested.py:81``):
    ``forward`` is the bf16 folded grid, run once with its recorder."""
    return recording_calibrator(forward, _sites_nested(forward.levels))


def _conv_specs(folded: Dict[str, dict], L: int) -> Dict[str, tuple]:
    """Each int8 conv's folded parameters and input-scale layout ``[(site,
    channels), ...]`` (``quant_nested.py:156-172``); ``g0_0``'s stage 1 stays
    float."""
    width = {(i, j): folded[f"conv{i}_{j}"]["stage2"]["weight"].shape[0]
             for i, j in _grid_order(L)}
    specs = {}
    for k, j in _grid_order(L):
        blk = folded[f"conv{k}_{j}"]
        if j == 0 and k > 0:
            specs[f"g{k}_0s1"] = (blk["stage1"], [(f"g{k - 1}_0b", width[(k - 1, 0)])])
        elif j > 0:
            specs[f"g{k}_{j}s1"] = (blk["stage1"],
                                    [(f"g{k}_{jj}b", width[(k, jj)]) for jj in range(j)]
                                    + [(f"g{k + 1}_{j - 1}b", width[(k + 1, j - 1)])])
        specs[f"g{k}_{j}s2"] = (blk["stage2"], [(f"g{k}_{j}a", blk["stage2"]["weight"].shape[1])])
    return specs


def _quantize(folded: Dict[str, dict], scales: Dict[str, float], L: int, heads,
              deep: bool, device) -> Int8Weights:
    """The int8 store of the folded grid at these site scales
    (``quant_nested.py:178 _build_pack``): the first conv and the heads
    float, every other conv with its input scales folded in."""
    store = Int8Weights(device)
    store.float_layer("g0_0s1", folded["conv0_0"]["stage1"])
    for name, (p, spec) in _conv_specs(folded, L).items():
        store.quant_conv(name, p, s_in=np.concatenate(
            [np.full(n, scales[site], np.float32) for site, n in spec]))
    suffix = f"_{L}" if deep else ""
    for name in heads:
        store.float_layer(f"output_layers.{name}{suffix}", folded[f"output_layers.{name}{suffix}"])
    return store


class Int8NestedUNet(Int8Forward):
    """The UNet++ int8 forward (``quant_nested.py:213 apply_fn``), with the
    interface of :class:`.quant.Int8Forward` on (N, 1, h, w) tiles:
    ``heads_out(x)`` (and ``__call__``) return ``{head: activated float32}``."""

    first = "g0_0s1"

    def __init__(self, weights: Int8Weights, act_maxes, levels: int, dilations, heads,
                 deep_supervision: bool):
        super().__init__(weights, _sites_nested(levels), act_maxes, heads, dilations[0])
        self.levels = int(levels)
        self.dilations = tuple(int(d) for d in dilations)
        self.head_suffix = f"_{self.levels}" if deep_supervision else ""

    def _cell(self, x: torch.Tensor, i: int, j: int, row: torch.Tensor, d: int = 1) -> None:
        """VGG block ``x_{i,j}``: stage 1 from ``x``, stage 2 into slot j of
        its row buffer."""
        w, s = self.w.conv, self.s
        a = qconv3x3(x, *w[f"g{i}_{j}s1"], 1.0, s[f"g{i}_{j}a"], d)
        stage2 = w[f"g{i}_{j}s2"]
        qconv3x3(a, *stage2, 1.0, s[f"g{i}_{j}b"], d, out=row, offset=j * stage2[0].shape[0])

    def trunk(self, x: torch.Tensor, prev: None = None) -> torch.Tensor:
        """The last cell ``x_{0,L}`` dequantized to bf16, (N, C, h, w) (a
        view of an NHWC tensor).

        One int8 buffer a grid row k holds its cells side by side, ``x_{k,j}``
        in slot j (channels [j·c_k, (j+1)·c_k)), as raw int8 at their own
        scales.  Cell ``x_{k,j}``'s input is then channels [0, (j+2)·c_k):
        its partners in slots 0..j-1 and, written there by K11 just before,
        the upsampled ``x_{k+1,j-1}`` (2·c_k channels, read from slot j-1 of
        row k+1) in slots j and j+1; its stage 2 then writes slot j.  No
        concat is copied."""
        L, dil, s = self.levels, self.dilations, self.s
        e = self._encode1(x.to(torch.bfloat16)).permute(0, 2, 3, 1).contiguous()
        q = requant(e, 1.0, s["g0_0a"])
        width = [self.w.conv[f"g{k}_0s2"][0].shape[0] for k in range(L + 1)]
        rows = []
        for k in range(L + 1):
            hw = (q.shape[1] >> k, q.shape[2] >> k)
            slots = L - k + 2 if k < L else 1
            rows.append(q.new_empty((q.shape[0],) + hw + (slots * width[k],)))

        def slot(k: int, j: int) -> torch.Tensor:
            return rows[k][..., j * width[k]:(j + 1) * width[k]]

        qconv3x3(q, *self.w.conv["g0_0s2"], 1.0, s["g0_0b"], dil[0], out=rows[0])
        for i in range(1, L + 1):
            self._cell(maxpool_i8(slot(i - 1, 0)), i, 0, rows[i], dil[i])
            for k in range(i - 1, -1, -1):
                j = i - k
                upsample2x_i8(slot(k + 1, j - 1), out=rows[k], offset=j * width[k])
                self._cell(rows[k][..., :(j + 2) * width[k]], k, j, rows[k])
        return requant(slot(0, L), s[f"g0_{L}b"]).permute(0, 3, 1, 2)


def build_int8_apply_nested(model, device,
                            folded: Optional[Dict[str, dict]] = None) -> Callable:
    """``make_forward(act_maxes) -> Int8NestedUNet``
    (``quant_nested.py:122``): each call quantizes the weights (``model``'s
    folded float32 parameters, or ``folded`` in the layout of
    ``fastpath.fold_unet2d``) with the scales of that calibration folded in."""
    folded = fold_unet2d(model.state_dict()) if folded is None else folded
    L, heads, deep = model.levels, model.heads, model.deep_supervision
    sites = _sites_nested(L)

    def make_forward(act_maxes) -> Int8NestedUNet:
        scales = dict(zip(sites, act_scales(act_maxes)))
        store = _quantize(folded, scales, L, heads, deep, device)
        return Int8NestedUNet(store, act_maxes, L, model.dilations, heads, deep)

    return make_forward
