"""BN-folded inference forwards of the U-Net family (counterpart of the
plain, attention and multi-head branches of
``bio_image_unet_tpu/predict/fastpath.py`` ``build_fast_apply``, of ``:236
_build_fast_3d`` and of ``:291 _build_fast_nested``).

Eval-mode BatchNorm is an affine map, so it folds exactly into the preceding
convolution (``fastpath.py:35 _fold``), in float32::

    k' = k · γ/√(σ²+ε)        (per output channel)
    b' = (b − μ) · γ/√(σ²+ε) + β

A folded block is then one ``F.conv2d`` (``F.conv3d`` for volumes) with bias
plus LeakyReLU(0.1).  The convolutions go to cuDNN through torch.  In
bfloat16 the weights and activations are kept ``channels_last`` (NHWC in
memory; ``channels_last_3d``, NDHWC, for volumes), the layout the card's
tensor-core convolutions run in.  Logits and head convolutions run in
the working dtype and return in float32, where a head's activation runs
(``fastpath.py:224-231``, ``:323-327``).

- ``FoldedUnet2D``     — ``Unet``, ``AttentionUnet`` (each gate's three 1×1
                         convs folded with their BatchNorms, :func:`attend`),
                         ``Siam_UNet`` (the twin encoder runs as one
                         batch of cur and prev tiles, then the join:
                         max, the folded ``conv_concat``, K6 or cur's
                         alone; ``fastpath.py:185-215``) and
                         ``MultiOutputUnet``
- ``FoldedNestedUNet`` — both UNet++ depths; a deep-supervision checkpoint
                         emits only each head's deepest level
- ``FoldedUNet3D``     — ``UNet3D`` and ``MultiOutputUnet3D``, both decoder
                         styles
- ``FoldedLegacyUnet2D`` — ``Unet_v0`` and ``BabyUnet`` (``fastpath.py:332
                         _build_fast_legacy``): ReLU blocks, skips from the
                         first block of each level, always float32
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from ..models.unet2d import apply_activation
from ..ops.blocks import GATES
from ..ops.functional import (depthwise_xcorr, downsample_nearest, max_pool, upsample_linear,
                              upsample_nearest)

_BN_EPS = 1e-5


def _block_of(key: str) -> str:
    parts = key.split(".")
    return ".".join(parts[:2]) if parts[0] == "output_layers" else parts[0]


def _fold(sd, conv: str, bn: str) -> Dict[str, torch.Tensor]:
    inv = sd[f"{bn}.weight"] * torch.rsqrt(sd[f"{bn}.running_var"] + _BN_EPS)
    w = sd[f"{conv}.weight"]
    return {"weight": w * inv.reshape((-1,) + (1,) * (w.dim() - 1)),
            "bias": (sd[f"{conv}.bias"] - sd[f"{bn}.running_mean"]) * inv + sd[f"{bn}.bias"]}


def fold_unet2d(state_dict: Dict[str, torch.Tensor]) -> Dict[str, dict]:
    """Fold a U-Net family state dict, 2D or 3D (``fastpath.py:88
    fold_unet2d``): ``ConvBlock`` ``<b>.0``/``<b>.1`` → ``{b: {'weight',
    'bias'}}``; UNet++ ``VGGBlock`` ``<b>.conv{1,2}``/``<b>.bn{1,2}`` → ``{b:
    {'stage1': …, 'stage2': …}}``; transposed convs, ``final`` (``final.0``
    in 2D, a bare ``final`` in ``UNet3D``) and ``output_layers.<head>`` are
    kept as they are; an ``AttentionBlock`` ``attention<k>`` → ``{'W_gate',
    'W_x', 'psi': {'weight', 'bias'}}`` (``fastpath.py:105-115``).  All
    folding happens in float32."""
    sd = {k: v.detach().to("cpu", torch.float32) for k, v in state_dict.items()
          if not k.endswith("num_batches_tracked")}
    folded = {}
    for b in sorted({_block_of(k) for k in sd}):
        if f"{b}.1.running_var" in sd:  # conv + BatchNorm
            folded[b] = _fold(sd, f"{b}.0", f"{b}.1")
        elif f"{b}.W_gate.1.running_var" in sd:  # attention gate: three 1×1 + BatchNorm
            folded[b] = {g: _fold(sd, f"{b}.{g}.0", f"{b}.{g}.1") for g in GATES}
        elif f"{b}.bn1.running_var" in sd:  # VGG block: two conv + BatchNorm stages
            folded[b] = {"stage1": _fold(sd, f"{b}.conv1", f"{b}.bn1"),
                         "stage2": _fold(sd, f"{b}.conv2", f"{b}.bn2")}
        elif b == "final":
            fin = "final.0" if "final.0.weight" in sd else "final"
            folded[b] = {"weight": sd[f"{fin}.weight"], "bias": sd[f"{fin}.bias"]}
        else:  # up<i> (ConvTranspose2d) and the 1×1 heads: nothing to fold
            folded[b] = {"weight": sd[f"{b}.weight"], "bias": sd[f"{b}.bias"]}
    return folded


def attend(p: Dict[str, dict], gate: torch.Tensor, skip: torch.Tensor,
           exact_product: bool = False) -> torch.Tensor:
    """The additive attention gate on its folded 1×1 convs (``fastpath.py:60
    attend``): ``skip·σ(psi(relu(W_gate(gate) + W_x(skip))))``, every step
    rounded to the tensors' dtype as XLA's CPU backend rounds JAX's graph:
    each conv, then its bias added, and σ expanded as ``1 / (1 + exp(-z))``
    (``lax.logistic``).  With ``exact_product`` the last product is returned
    in float32, unrounded, as XLA hands it to the int8 graph's float32
    requant (``quant.py:481``): a product of two bf16 values is exact."""
    def conv1x1(x, q):
        return F.conv2d(x, q["weight"]) + q["bias"].view(1, -1, 1, 1)

    r = torch.relu(conv1x1(gate, p["W_gate"]) + conv1x1(skip, p["W_x"]))
    psi = torch.reciprocal(torch.exp(-conv1x1(r, p["psi"])) + 1)
    return skip.float() * psi.float() if exact_product else skip * psi


class _Folded:
    """Folded parameters on the device in the working dtype, and the conv
    helpers the forwards share."""

    def __init__(self, model, dtype: Optional[torch.dtype] = None, device=None):
        self.dtype = dtype or torch.float32
        self.device = torch.device(device or "cpu")
        self.heads = getattr(model, "heads", None)
        self.channels_last = self.dtype == torch.bfloat16

        def place(p):
            if "weight" not in p:
                return {k: place(v) for k, v in p.items()}
            w = p["weight"].to(self.device, self.dtype)
            return {"weight": w.contiguous(memory_format=self._format(w)),
                    "bias": p["bias"].to(self.device, self.dtype)}

        self.params = {b: place(p) for b, p in fold_unet2d(model.state_dict()).items()}

    def _format(self, t: torch.Tensor) -> torch.memory_format:
        if not self.channels_last:
            return torch.contiguous_format
        return torch.channels_last if t.dim() == 4 else torch.channels_last_3d

    def _input(self, x: torch.Tensor) -> torch.Tensor:
        return x.contiguous(memory_format=self._format(x))

    @staticmethod
    def _conv(x, p, dilation=1):
        conv = F.conv2d if x.dim() == 4 else F.conv3d
        return F.leaky_relu(conv(x, p["weight"], p["bias"], padding=dilation,
                                 dilation=dilation), 0.1)

    @staticmethod
    def _conv1x1(h, p):
        return (F.conv2d if h.dim() == 4 else F.conv3d)(h, p["weight"], p["bias"])

    def _head(self, h: torch.Tensor, layer: str, activation) -> torch.Tensor:
        return apply_activation(self._conv1x1(h, self.params[layer]).float(), activation)


class FoldedUnet2D(_Folded):
    """The folded forward of a ``Unet``, ``Siam_UNet`` or ``MultiOutputUnet``:
    ``__call__(x[, prev])`` takes (N, 1, H, W) input (and, for ``Siam_UNet``,
    the previous frames' tiles) already scaled to [0, 1] in the working dtype
    and returns what the model returns in eval mode: ``(sigmoid(logits),
    logits)`` with float32 logits, or ``{head: activated float32}``.
    ``logits(x[, prev])`` returns the final conv's output in the working
    dtype (the device pipeline's K3 reads it directly); ``heads(x)`` the head
    dict."""

    def __init__(self, model, dtype: Optional[torch.dtype] = None, device=None):
        super().__init__(model, dtype, device)
        self.dilation = int(getattr(model, "dilation", 1))
        self.mode = getattr(model, "mode", None)
        self.attention = bool(getattr(model, "attention", False))
        # ``recorder(site, activation)``, when set, sees every conv output
        # under its int8 calibration site (``predict/quant.py``)
        self.recorder: Optional[Callable] = None

    def _block(self, x: torch.Tensor, block: str, site: str, dilation: int = 1) -> torch.Tensor:
        a = self._conv(x, self.params[block], dilation)
        if self.recorder is not None:
            self.recorder(site, a)
        return a

    def _encode(self, x: torch.Tensor):
        d, b = self.dilation, self._block
        e2 = b(b(x, "encode1", "e1", d), "encode2", "e2", d)
        e4 = b(b(F.max_pool2d(e2, 2), "encode3", "e3", d), "encode4", "e4", d)
        e6 = b(b(F.max_pool2d(e4, 2), "encode5", "e5", d), "encode6", "e6", d)
        e8 = b(b(F.max_pool2d(e6, 2), "encode7", "e7", d), "encode8", "e8", d)
        return e2, e4, e6, e8, F.max_pool2d(e8, 2)

    def _join(self, m4: torch.Tensor, mm4: torch.Tensor) -> torch.Tensor:
        if self.mode == "max":
            return torch.maximum(m4, mm4)
        if self.mode == "concat":
            return self._block(torch.cat([m4, mm4], dim=1), "conv_concat", "join")
        if self.mode == "control":
            return m4
        return depthwise_xcorr(m4, mm4)  # corr

    def trunk(self, x: torch.Tensor, prev: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The decoder's last features (``decode8``) in the working dtype."""
        x = self._input(x)
        d, b, P = self.dilation, self._block, self.params
        if self.mode is not None and prev is None:
            raise ValueError("Siam mode requires prev_x")
        # the control join keeps cur's bottleneck, so prev is not encoded,
        # except under a recorder: the calibration's encoder sites take the
        # max over both streams (quant.py:334-343)
        if self.mode is None or (self.mode == "control" and self.recorder is None):
            e2, e4, e6, e8, m4 = self._encode(x)
        else:
            # the twin encoder shares its weights: cur and prev as one batch,
            # cur's skips and the join of the two bottlenecks go on
            n = x.shape[0]
            e2, e4, e6, e8, m4 = self._encode(torch.cat([x, self._input(prev)]))
            e2, e4, e6, e8 = e2[:n], e4[:n], e6[:n], e8[:n]
            m4 = self._join(m4[:n], m4[n:])
        h = b(b(m4, "middle_conv1", "m1", d), "middle_conv2", "m2", d)
        for i, skip in zip(range(1, 5), (e8, e6, e4, e2)):
            up = P[f"up{i}"]
            u = F.conv_transpose2d(h, up["weight"], up["bias"], stride=2)
            if self.recorder is not None:
                self.recorder(f"up{i}", u)
            if self.attention:  # (attended skip, up) (fastpath.py:215-218)
                h = torch.cat([attend(P[f"attention{i}"], u, skip), u], dim=1)
            else:
                h = torch.cat([u, skip], dim=1)
            h = b(b(h, f"decode{2 * i - 1}", f"d{2 * i - 1}"), f"decode{2 * i}", f"d{2 * i}")
        return h

    def logits(self, x: torch.Tensor, prev: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Final-conv output in the working dtype."""
        return self._conv1x1(self.trunk(x, prev), self.params["final"])

    def heads_out(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """``{head: activated float32}`` of a multi-head trunk."""
        h = self.trunk(x)
        return {name: self._head(h, f"output_layers.{name}", cfg.get("activation"))
                for name, cfg in self.heads.items()}

    def __call__(self, x: torch.Tensor, prev: Optional[torch.Tensor] = None):
        if self.heads is not None:
            return self.heads_out(x)
        logits = self.logits(x, prev).float()
        return torch.sigmoid(logits), logits


class FoldedNestedUNet(_Folded):
    """The folded eval forward of UNet++ (``fastpath.py:291
    _build_fast_nested``): the dense ``x_{i,j}`` grid of two-stage folded
    VGG blocks with bilinear ``align_corners=True`` upsampling;
    ``heads_out(x)`` (and ``__call__``) return ``{head: activated float32}``
    from the deepest level (``output_layers.<head>_<L>`` for a
    deep-supervision checkpoint).  ``recorder(site, activation)``, when set,
    sees each VGG stage's output under its int8 calibration site
    (``g<i>_<j>a``, ``g<i>_<j>b``: ``predict/quant_nested.py``)."""

    def __init__(self, model, dtype: Optional[torch.dtype] = None, device=None):
        super().__init__(model, dtype, device)
        self.levels = model.levels
        self.dilations = model.dilations
        self.deep_supervision = model.deep_supervision
        self.recorder: Optional[Callable] = None

    def _vgg(self, x, i: int, j: int, d=1):
        p = self.params[f"conv{i}_{j}"]
        a = self._conv(x, p["stage1"], d)
        if self.recorder is not None:
            self.recorder(f"g{i}_{j}a", a)
        a = self._conv(a, p["stage2"], d)
        if self.recorder is not None:
            self.recorder(f"g{i}_{j}b", a)
        return a

    def trunk(self, x: torch.Tensor, prev: None = None) -> torch.Tensor:
        """The dense grid's last cell ``x_{0,L}`` in the working dtype."""
        L, dil = self.levels, self.dilations
        col = {0: {0: self._vgg(self._input(x), 0, 0, dil[0])}}
        for i in range(1, L + 1):
            col[i] = {0: self._vgg(max_pool(col[i - 1][0]), i, 0, dil[i])}
            for k in range(i - 1, -1, -1):
                j = i - k
                inputs = [col[k][jj] for jj in range(j)] + [
                    upsample_linear(col[k + 1][j - 1], 2, align_corners=True)]
                col[k][j] = self._vgg(torch.cat(inputs, dim=1), k, j)
        return col[0][L]

    def heads_out(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        h = self.trunk(x)
        suffix = f"_{self.levels}" if self.deep_supervision else ""
        return {name: self._head(h, f"output_layers.{name}{suffix}", cfg.get("activation"))
                for name, cfg in self.heads.items()}

    __call__ = heads_out


class FoldedUNet3D(FoldedUnet2D):
    """The folded eval forward of ``UNet3D`` and ``MultiOutputUnet3D``
    (``fastpath.py:236 _build_fast_3d``): three levels on (N, 1, D, H, W)
    input; max pools, or nearest ×0.5 for ``MultiOutputUnet3D`` with
    ``use_interpolation``; the decoder's ×2 is a transposed conv, or
    trilinear (``align_corners=False``) for ``UNet3D`` and nearest + a folded
    conv block for ``MultiOutputUnet3D`` with ``use_interpolation``.
    ``logits``, ``heads_out`` and ``__call__`` are those of
    :class:`FoldedUnet2D`."""

    def __init__(self, model, dtype: Optional[torch.dtype] = None, device=None):
        super().__init__(model, dtype, device)
        self.interp = bool(model.use_interpolation)

    def trunk(self, x: torch.Tensor, prev: None = None) -> torch.Tensor:
        """``decode6``'s output in the working dtype (no siamese form).  Under
        a recorder the conv outputs are seen at the int8 calibration sites of
        ``quant3d._sites_3d``; the trilinear decoder has no up site."""
        b, P, interp, multi = self._block, self.params, self.interp, self.heads is not None
        down = downsample_nearest if (multi and interp) else max_pool
        e2 = b(b(self._input(x), "encode1", "e1"), "encode2", "e2")
        e4 = b(b(down(e2), "encode3", "e3"), "encode4", "e4")
        e6 = b(b(down(e4), "encode5", "e5"), "encode6", "e6")
        h = b(b(down(e6), "middle_conv1", "m1"), "middle_conv2", "m2")
        for i, skip in zip(range(1, 4), (e6, e4, e2)):
            if not interp:
                up = P[f"up{i}"]
                u = F.conv_transpose3d(h, up["weight"], up["bias"], stride=2)
                if self.recorder is not None:
                    self.recorder(f"up{i}", u)
            elif multi:
                u = b(upsample_nearest(h), f"up{i}_conv", f"up{i}")
            else:
                u = upsample_linear(h)
            h = torch.cat([u, skip], dim=1)
            h = b(b(h, f"decode{2 * i - 1}", f"d{2 * i - 1}"), f"decode{2 * i}", f"d{2 * i}")
        return h


class FoldedLegacyUnet2D(FoldedUnet2D):
    """The folded eval forward of ``Unet_v0`` (4 levels) and ``BabyUnet`` (3)
    (``fastpath.py:332 _build_fast_legacy``): each ReLU block one conv with
    its BatchNorm folded in, then ReLU; the skips are each level's first
    block; the bottleneck's dropout is the identity in eval; the extra
    1-channel block, then ``final``.  float32 whatever ``dtype`` asks, as
    JAX's legacy forward is (the convolutions on cuDNN, TF32 as torch's
    defaults allow it).  ``logits`` and ``__call__`` are those of
    :class:`FoldedUnet2D`."""

    def __init__(self, model, dtype: Optional[torch.dtype] = None, device=None):
        super().__init__(model, torch.float32, device)
        self.levels = model.levels

    def trunk(self, x: torch.Tensor, prev: None = None) -> torch.Tensor:
        """The extra 1-channel block's output."""
        def c(h, block):
            p = self.params[block]
            return torch.relu(F.conv2d(h, p["weight"], p["bias"], padding=1))

        L, h, skips = self.levels, x.float(), []
        for k in range(1, L + 1):
            a = c(h, f"encode{2 * k - 1}")
            skips.append(a)
            h = F.max_pool2d(c(a, f"encode{2 * k}"), 2)
        h = c(c(h, "middle_conv1"), "middle_conv2")
        for i in range(1, L + 1):
            up = self.params[f"up{i}"]
            h = torch.cat([F.conv_transpose2d(h, up["weight"], up["bias"], stride=2),
                           skips[L - i]], dim=1)
            h = c(c(h, f"decode{2 * i - 1}"), f"decode{2 * i}")
        return c(h, f"decode{2 * L + 1}")


def folded_forward(model, dtype: Optional[torch.dtype] = None, device=None) -> _Folded:
    """The folded forward of a ported model."""
    from ..models.legacy import BabyUnet, Unet_v0
    from ..models.nested_unet import MultiOutputNestedUNet
    from ..models.unet3d import MultiOutputUnet3D, UNet3D

    if isinstance(model, (Unet_v0, BabyUnet)):
        cls = FoldedLegacyUnet2D
    elif isinstance(model, MultiOutputNestedUNet):
        cls = FoldedNestedUNet
    elif isinstance(model, (UNet3D, MultiOutputUnet3D)):
        cls = FoldedUNet3D
    else:
        cls = FoldedUnet2D
    return cls(model, dtype, device)
