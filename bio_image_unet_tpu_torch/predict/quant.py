"""w8a8 int8 prediction of the plain 2D trunk, opt-in with
``quantized=True`` (counterpart of ``bio_image_unet_tpu/predict/quant.py``);
the 3D trunks' int8 graph is in :mod:`.quant3d`.

The scheme is the JAX package's post-training quantization, unchanged:

- **Weights**: BN-folded conv kernels (``fastpath.fold_unet2d``) quantized
  per output channel, symmetric, ``sw = max(|k|, 1e-12) / 127`` over the
  kernel's other axes; the transposed convs per tensor; codes
  ``clip(round(k / sw), ±127)`` (half to even) in float32 with numpy, as JAX
  computes them; biases stay float32 (:class:`Int8Weights`).
- **Activations**: one per-tensor scale a site (:func:`_sites`), from the
  per-site ``max|a|`` of an instrumented bf16 forward over sample tiles of
  the movie (:func:`build_calibrator`; the folded forward with a recorder).
- **Graph** (:class:`Int8Unet2D`): ``encode1`` and the 1×1 head(s) run in
  bf16; everything between runs int8 on NHWC tensors: conv → int32 →
  float32 dequant ``y·(s_in·s_w) + bias`` → LeakyReLU 0.1 → requant to the
  next site's scale (K7); max pools act on int8 values (K10); each up-conv
  (K8) writes the first half of a decoder level's concat buffer and the skip,
  rescaled to ``max(s_up, s_skip)`` (K9), the second, so no concat copy is
  made; K9 also quantizes ``encode1``'s output and dequantizes before the
  head.  With attention gates (``AttentionUnet``, ``quant.py:472-485``) K8
  writes the up path after the skip's channels; K9 dequantizes the up path
  and the skip to bf16, the gate runs in bf16 on cuDNN 1×1 convs
  (``fastpath.attend``) and K9 requantizes the attended skip (float32: the
  product of two bf16 values, unrounded as XLA leaves it) to the level's
  concat scale into the buffer's first channels.  The kernels are in
  :mod:`..ops.int8` (``csrc/int8_trunk.cu``).

The 2D graph covers ``Unet`` at any integer dilation, ``AttentionUnet``,
``MultiOutputUnet`` (heads float) and ``Siam_UNet`` with the ``max``,
``control`` and ``concat`` joins (``corr`` has no int8 formulation);
:func:`int8_builders` hands UNet++ to :mod:`.quant_nested` and the 3D
families (``UNet3D`` with either decoder, ``MultiOutputUnet3D``) to
:mod:`.quant3d`.  :func:`int8_status` answers as the JAX function does for
every model class the port builds.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..models.unet2d import apply_activation
from ..ops.blocks import GATES
from ..ops.int8 import maxpool_i8, qconv3x3, qconvt2x2, requant
from .fastpath import FoldedUnet2D, attend, fold_unet2d, folded_forward

# The JAX package's ship set (``quant.py:79 _MEASURED_INT8``): the families
# that quantize on ``quantized=True``; the others are experimental there and
# run int8 only under BIU_INT8_EXPERIMENTAL.  Mirrored so that the status is
# the same in both packages; the measurements behind it are not the port's.
_MEASURED_INT8 = frozenset({"unet2d", "attention2d", "unet3d"})

# siamese joins with an int8 formulation ('corr' correlates two activations:
# there is no weight to quantize)
_INT8_MODES = (None, "max", "control", "concat")

# encoder conv outputs that feed the decoder concats, in up1..up4 order
_SKIPS = ("e8", "e6", "e4", "e2")


def _sites(mode):
    """Activation-scale sites in calibration-vector order; the ``concat``
    join adds one for its conv's output, ``max``/``control`` reuse e8's."""
    base = (["e1", "e2", "e3", "e4", "e5", "e6", "e7", "e8", "m1", "m2"]
            + [f"up{i}" for i in range(1, 5)] + [f"d{i}" for i in range(1, 9)])
    if mode == "concat":
        base.append("join")
    return base


def _int8_family(model) -> Optional[str]:
    """The family key of ``model`` (``quant.py:119``): ``'unet2d'`` for the
    2D trunk with an int8 join, ``'attention2d'`` for it with attention gates,
    ``'nested'`` for UNet++, ``'unet3d'`` / ``'unet3d_interp'`` /
    ``'multi_output_3d'`` by 3D decoder style, or None."""
    from ..models.nested_unet import MultiOutputNestedUNet
    from ..models.unet2d import Unet
    from ..models.unet3d import MultiOutputUnet3D, UNet3D

    if isinstance(model, Unet):
        if getattr(model, "mode", None) not in _INT8_MODES:
            return None
        return "attention2d" if getattr(model, "attention", False) else "unet2d"
    if isinstance(model, MultiOutputNestedUNet):
        return "nested"
    if isinstance(model, MultiOutputUnet3D):
        return "multi_output_3d"
    if isinstance(model, UNet3D):
        return "unet3d_interp" if model.use_interpolation else "unet3d"
    return None


def int8_status(model) -> Optional[str]:
    """``'enabled'``, ``'experimental'`` (an int8 graph the JAX package runs
    only under BIU_INT8_EXPERIMENTAL) or None (no int8 formulation), as
    ``quant.py:162 int8_status`` answers."""
    family = _int8_family(model)
    if family is None:
        return None
    # "0"/"false"/"no"/"off" disable: only another non-empty value opts in
    opt_in = os.environ.get("BIU_INT8_EXPERIMENTAL", "").strip().lower()
    if family in _MEASURED_INT8 or opt_in not in ("", "0", "false", "no", "off"):
        return "enabled"
    return "experimental"


def supports_int8(model) -> bool:
    """True when ``quantized=True`` asks for int8 on this model."""
    return int8_status(model) == "enabled"


# --- weights --------------------------------------------------------------------

class Int8Weights:
    """Named int8 weight store (``quant.py:228 _WeightPack`` without its
    packing into one buffer, a TPU dispatch-cost measure).  ``conv[name]``
    is ``(codes, sw, bias)`` on the device: codes (O, *taps, I_pad) for a conv
    (3×3 or 3×3×3) and (*taps, O, I_pad) for a transposed conv (2×2 or
    2×2×2), I_pad a multiple of 32; ``sw`` (O,) float32 (a transposed conv's
    one scale, repeated); ``float`` holds the layers kept in bf16:
    ``{'weight', 'bias'}`` cast to bf16, as ``fastpath._conv`` casts them."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.conv: Dict[str, tuple] = {}
        self.float: Dict[str, dict] = {}

    def float_layer(self, name: str, p: dict) -> None:
        fmt = torch.contiguous_format
        if self.device.type == "cuda":
            fmt = torch.channels_last if p["weight"].dim() == 4 else torch.channels_last_3d
        self.float[name] = {
            "weight": p["weight"].to(self.device, torch.bfloat16).contiguous(memory_format=fmt),
            "bias": p["bias"].to(self.device, torch.bfloat16)}

    def quant_conv(self, name: str, p: dict, per_channel: bool = True, s_in=None) -> None:
        """A conv (O, I, *taps: per output channel) or, with ``per_channel``
        False, a transposed conv ((I, O, *taps), per tensor).  ``s_in``, the
        input's activation scale (one a channel, or one for all), is
        multiplied into the float32 kernel first (``quant3d.py:209-238``)."""
        w = np.asarray(p["weight"].detach().cpu().numpy(), np.float32)
        if s_in is not None:
            shape = [1] * w.ndim
            shape[1 if per_channel else 0] = -1
            w = w * np.asarray(s_in, np.float32).reshape(shape)
        if per_channel:
            k = np.ascontiguousarray(np.moveaxis(w, 1, -1))  # (O, *taps, I)
            sw = np.maximum(np.abs(k).max(axis=tuple(range(1, k.ndim))), 1e-12) / 127.0
            codes = np.clip(np.round(k / sw.reshape((-1,) + (1,) * (k.ndim - 1))), -127, 127)
        else:
            k = np.ascontiguousarray(np.transpose(w, tuple(range(2, w.ndim)) + (1, 0)))
            sw = np.float32(max(float(np.abs(k).max()), 1e-12) / 127.0)  # (*taps, O, I)
            codes = np.clip(np.round(k / sw), -127, 127)
            sw = np.full(k.shape[-2], sw, np.float32)
        cin = codes.shape[-1]
        pad = -(-cin // 32) * 32 - cin
        codes = np.pad(codes.astype(np.int8), [(0, 0)] * (codes.ndim - 1) + [(0, pad)])
        self.conv[name] = (torch.from_numpy(codes).to(self.device),
                           torch.from_numpy(np.asarray(sw, np.float32)).to(self.device),
                           p["bias"].detach().to(self.device, torch.float32).contiguous())

    @classmethod
    def from_folded(cls, folded: Dict[str, dict], mode, heads, device) -> "Int8Weights":
        """The store of a folded 2D trunk (``quant.py:378-399``); attention
        gates' folded 1×1 convs stay float, as ``attention<i>.<W_gate|W_x|
        psi>``."""
        store = cls(device)
        head_layers = (["final"] if heads is None else [f"output_layers.{n}" for n in heads])
        for name in ["encode1"] + head_layers:
            store.float_layer(name, folded[name])
        for i in range(1, 5):
            if f"attention{i}" in folded:
                for g in GATES:
                    store.float_layer(f"attention{i}.{g}", folded[f"attention{i}"][g])
        convs = ([f"encode{i}" for i in range(2, 9)]
                 + (["conv_concat"] if mode == "concat" else [])
                 + ["middle_conv1", "middle_conv2"] + [f"decode{i}" for i in range(1, 9)])
        for name in convs:
            store.quant_conv(name, folded[name])
        for i in range(1, 5):
            store.quant_conv(f"up{i}", folded[f"up{i}"], per_channel=False)
        return store


# --- calibration ----------------------------------------------------------------

def build_calibrator(forward: FoldedUnet2D) -> Callable:
    """``cal_fn(x[, prev]) -> (len(_sites(mode)),) float32`` per-site
    ``max|a|`` over a batch of (N, 1, h, w) tiles in [0, 1]
    (``quant.py:288``): ``forward`` is the bf16 folded trunk, run once with
    its recorder.  Siam encoder sites take the max over both streams, the
    ``control`` join's included (the JAX calibrator encodes prev there)."""
    return recording_calibrator(forward, _sites(forward.mode))


def recording_calibrator(forward: FoldedUnet2D, sites) -> Callable:
    """``cal_fn(x[, prev])``: one pass of the bf16 folded ``forward``'s trunk
    with its recorder on, the per-site ``max|a|`` in ``sites`` order."""
    if forward.dtype != torch.bfloat16:
        raise ValueError("the calibration forward runs in bf16")

    @torch.inference_mode()
    def cal_fn(x: torch.Tensor, prev: Optional[torch.Tensor] = None) -> np.ndarray:
        maxes = {}

        def record(site, a):
            m = a.abs().amax().float()
            maxes[site] = torch.maximum(maxes[site], m) if site in maxes else m

        forward.recorder = record
        try:
            forward.trunk(x.to(torch.bfloat16),
                          None if prev is None else prev.to(torch.bfloat16))
        finally:
            forward.recorder = None
        return torch.stack([maxes[s] for s in sites]).cpu().numpy()

    return cal_fn


# --- the int8 forward -------------------------------------------------------------

def act_scales(act_maxes) -> np.ndarray:
    """Per-site float32 scales from the calibrated maxes (``quant.py:401-403``)."""
    return np.maximum(np.asarray(act_maxes, np.float32), 1e-8) / 127.0


class Int8Forward:
    """What the 2D and 3D int8 forwards share: the folded forward's
    interface — ``logits(x[, prev])`` (float32), ``heads_out(x)`` (``{head:
    activated float32}``) and ``__call__`` — on (N, 1, *tile) tiles in [0, 1]
    in any float dtype (cast to bf16 first, as JAX does), around a
    ``trunk(x[, prev])`` that returns the last decoder features dequantized
    to bf16; ``s`` maps each site to its scale."""

    # the float first conv's name in the weight store, and the suffix of the
    # head layers' (``_<L>`` for a deep-supervision UNet++)
    first = "encode1"
    head_suffix = ""

    def __init__(self, weights: Int8Weights, sites, act_maxes, heads=None, dilation: int = 1):
        self.w = weights
        self.heads = heads
        self.dilation = int(dilation)
        self.s = dict(zip(sites, (float(v) for v in act_scales(act_maxes))))
        self._slope = torch.tensor(0.1, dtype=torch.bfloat16, device=weights.device)

    def _encode1(self, x: torch.Tensor) -> torch.Tensor:
        """The first conv in bf16 in JAX's rounding order: the conv, then the
        bias, then LeakyReLU with the slope rounded to bf16."""
        p, d = self.w.float[self.first], self.dilation
        conv = F.conv2d if x.dim() == 4 else F.conv3d
        y = conv(x, p["weight"], padding=d, dilation=d) + p["bias"].view(
            (1, -1) + (1,) * (x.dim() - 2))
        return torch.where(y >= 0, y, y * self._slope)

    def _head(self, h: torch.Tensor, name: str) -> torch.Tensor:
        """A 1×1 head conv, float32 out: the bf16 conv, then the bf16 bias
        added in float32.  XLA drops the bf16 rounding of the sum when its
        consumer is float32 (excess precision), so JAX's logits are not
        bf16 values."""
        p = self.w.float[name]
        conv = F.conv2d if h.dim() == 4 else F.conv3d
        return conv(h, p["weight"]).float() + p["bias"].float().view(
            (1, -1) + (1,) * (h.dim() - 2))

    def trunk(self, x: torch.Tensor, prev: Optional[torch.Tensor] = None) -> torch.Tensor:
        raise NotImplementedError

    def logits(self, x: torch.Tensor, prev: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The final 1×1 conv's output, float32."""
        return self._head(self.trunk(x, prev), "final")

    def heads_out(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        h = self.trunk(x)
        return {name: apply_activation(self._head(h, f"output_layers.{name}{self.head_suffix}"),
                                       cfg.get("activation"))
                for name, cfg in self.heads.items()}

    def __call__(self, x: torch.Tensor, prev: Optional[torch.Tensor] = None):
        if self.heads is not None:
            return self.heads_out(x)
        logits = self.logits(x, prev)
        return torch.sigmoid(logits), logits


class Int8Unet2D(Int8Forward):
    """The 2D int8 forward (``quant.py:405 apply_fn``), with the interface
    of :class:`Int8Forward` on (N, 1, h, w) tiles."""

    def __init__(self, weights: Int8Weights, act_maxes, mode=None, heads=None,
                 dilation: int = 1):
        super().__init__(weights, _sites(mode), act_maxes, heads, dilation)
        self.mode = mode
        self.attention = "attention1.W_gate" in weights.float

    def _qconv(self, x, name: str, s_in: float, site: str, dilation: int = 1):
        return qconv3x3(x, *self.w.conv[name], s_in, self.s[site], dilation)

    def _encode(self, x: torch.Tensor):
        d, s, c = self.dilation, self.s, self._qconv
        q1 = requant(self._encode1(x).permute(0, 2, 3, 1).contiguous(), 1.0, s["e1"])
        q2 = c(q1, "encode2", s["e1"], "e2", d)
        q4 = c(c(maxpool_i8(q2), "encode3", s["e2"], "e3", d), "encode4", s["e3"], "e4", d)
        q6 = c(c(maxpool_i8(q4), "encode5", s["e4"], "e5", d), "encode6", s["e5"], "e6", d)
        q8 = c(c(maxpool_i8(q6), "encode7", s["e6"], "e7", d), "encode8", s["e7"], "e8", d)
        return q2, q4, q6, q8, maxpool_i8(q8)

    def trunk(self, x: torch.Tensor, prev: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``decode8``'s output dequantized to bf16, (N, C, h, w) (a view of
        an NHWC tensor)."""
        s, c = self.s, self._qconv
        x = x.to(torch.bfloat16)
        if self.mode is not None and prev is None:
            raise ValueError("Siam mode requires prev_x")
        if self.mode in (None, "control"):
            q2, q4, q6, q8, m4 = self._encode(x)
            join, s_join = m4, s["e8"]
        else:
            # the twin encoder as one batch of cur and prev tiles; both
            # streams share e8's scale, so the int8 max is exact
            n = x.shape[0]
            q2, q4, q6, q8, m4 = self._encode(torch.cat([x, prev.to(torch.bfloat16)]))
            q2, q4, q6, q8 = q2[:n], q4[:n], q6[:n], q8[:n]
            if self.mode == "max":
                join, s_join = torch.maximum(m4[:n], m4[n:]), s["e8"]
            else:  # concat
                join = c(torch.cat([m4[:n], m4[n:]], dim=-1), "conv_concat", s["e8"], "join")
                s_join = s["join"]
        d = self.dilation
        h = c(c(join, "middle_conv1", s_join, "m1", d), "middle_conv2", s["m1"], "m2", d)
        s_h = s["m2"]
        for i, (skip, site) in enumerate(zip((q8, q6, q4, q2), _SKIPS), start=1):
            s_cat = max(s[f"up{i}"], s[site])
            up = self.w.conv[f"up{i}"]
            c_up, c_skip = up[0].shape[2], skip.shape[-1]
            buf = torch.empty(skip.shape[:-1] + (c_up + c_skip,), dtype=torch.int8,
                              device=skip.device)
            if self.attention:
                # (attended skip, up): the gate in bf16 between two K9
                # dequants and a K9 requant; |skip·psi| ≤ |skip|, so the
                # attended skip takes s_cat as the raw skip would
                qconvt2x2(h, *up, s_h, s_cat, out=buf, offset=c_skip)
                u_f = requant(buf[..., c_skip:], s_cat).permute(0, 3, 1, 2)
                skip_f = requant(skip, s[site]).permute(0, 3, 1, 2)
                gate = {g: self.w.float[f"attention{i}.{g}"] for g in GATES}
                a = attend(gate, u_f, skip_f, exact_product=True).permute(0, 2, 3, 1)
                requant(a.contiguous(), 1.0, s_cat, out=buf)
            else:
                qconvt2x2(h, *up, s_h, s_cat, out=buf, offset=0)
                requant(skip, s[site], s_cat, out=buf, offset=c_up)
            h = c(buf, f"decode{2 * i - 1}", s_cat, f"d{2 * i - 1}")
            h = c(h, f"decode{2 * i}", s[f"d{2 * i - 1}"], f"d{2 * i}")
            s_h = s[f"d{2 * i}"]
        return requant(h, s_h).permute(0, 3, 1, 2)


def build_int8_apply(model, device, folded: Optional[Dict[str, dict]] = None) -> Callable:
    """``make_forward(act_maxes) -> Int8Unet2D`` (``quant.py:362``): the
    weights (``model``'s folded float32 parameters, or ``folded`` in the
    layout of ``fastpath.fold_unet2d``) are quantized once, here; each call
    pairs them with a calibration."""
    folded = fold_unet2d(model.state_dict()) if folded is None else folded
    mode = getattr(model, "mode", None)
    heads = getattr(model, "heads", None)
    weights = Int8Weights.from_folded(folded, mode, heads, device)
    dilation = int(getattr(model, "dilation", 1))

    def make_forward(act_maxes) -> Int8Unet2D:
        return Int8Unet2D(weights, act_maxes, mode, heads, dilation)

    return make_forward


def int8_builders(model, device, forward=None) -> tuple:
    """``(cal_fn, make_forward)`` of a model with an int8 family
    (``quant.py:187``): ``'unet2d'``, ``'attention2d'``, ``'nested'`` or one
    of the 3D families ``'unet3d'``, ``'unet3d_interp'``,
    ``'multi_output_3d'``; ``forward`` is a bf16 folded forward of the model
    to calibrate with (one is built when it is None)."""
    family = _int8_family(model)
    if family is None:
        raise ValueError(f"no int8 formulation for {type(model).__name__}")
    if forward is None or forward.dtype != torch.bfloat16:
        forward = folded_forward(model, torch.bfloat16, device)
    if family in ("unet2d", "attention2d"):
        return build_calibrator(forward), build_int8_apply(model, device)
    if family == "nested":
        from .quant_nested import build_calibrator_nested, build_int8_apply_nested

        return build_calibrator_nested(forward), build_int8_apply_nested(model, device)
    from .quant3d import build_calibrator_3d, build_int8_apply_3d

    return build_calibrator_3d(forward), build_int8_apply_3d(model, device)
