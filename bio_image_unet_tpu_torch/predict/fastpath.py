"""BN-folded inference forward for the plain 2D U-Net (counterpart of the
plain branch of ``bio_image_unet_tpu/predict/fastpath.py``).

Eval-mode BatchNorm is an affine map, so it folds exactly into the preceding
convolution (``fastpath.py:35 _fold``), in float32::

    k' = k · γ/√(σ²+ε)        (per output channel)
    b' = (b − μ) · γ/√(σ²+ε) + β

A folded block is then one ``F.conv2d`` with bias plus LeakyReLU(0.1).  The
convolutions go to cuDNN through torch.  In bfloat16 the weights and
activations are kept ``channels_last`` (NHWC in memory), the layout the
card's tensor-core convolutions run in; the logits return in float32.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

_BN_EPS = 1e-5


def fold_unet2d(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Dict[str, torch.Tensor]]:
    """Fold a ``Unet`` state dict into ``{block: {'weight', 'bias'}}``
    (``fastpath.py:88 fold_unet2d``).  All folding happens in float32."""
    sd = {k: v.detach().to("cpu", torch.float32) for k, v in state_dict.items()
          if not k.endswith("num_batches_tracked")}
    blocks = sorted({k.split(".")[0] for k in sd})
    folded = {}
    for b in blocks:
        if f"{b}.1.running_var" in sd:  # conv + BatchNorm
            inv = sd[f"{b}.1.weight"] * torch.rsqrt(sd[f"{b}.1.running_var"] + _BN_EPS)
            folded[b] = {
                "weight": sd[f"{b}.0.weight"] * inv[:, None, None, None],
                "bias": (sd[f"{b}.0.bias"] - sd[f"{b}.1.running_mean"]) * inv
                        + sd[f"{b}.1.bias"],
            }
        elif b == "final":
            folded[b] = {"weight": sd["final.0.weight"], "bias": sd["final.0.bias"]}
        else:  # up<i>: ConvTranspose2d, nothing to fold
            folded[b] = {"weight": sd[f"{b}.weight"], "bias": sd[f"{b}.bias"]}
    return folded


class FoldedUnet2D:
    """The folded forward of a ``Unet``: ``__call__(x)`` takes (N, 1, H, W)
    input already scaled to [0, 1] in the working dtype and returns
    ``(sigmoid(logits), logits)`` with float32 logits, like ``Unet.forward``
    in eval mode.  ``logits(x)`` returns the final conv's output in the
    working dtype (the device pipeline's K3 reads it directly)."""

    def __init__(self, model, dtype: Optional[torch.dtype] = None,
                 device=None):
        self.dtype = dtype or torch.float32
        self.device = torch.device(device or "cpu")
        self.dilation = int(getattr(model, "dilation", 1))
        self.channels_last = self.dtype == torch.bfloat16
        fmt = torch.channels_last if self.channels_last else torch.contiguous_format
        self.params = {
            b: {"weight": p["weight"].to(self.device, self.dtype).contiguous(memory_format=fmt),
                "bias": p["bias"].to(self.device, self.dtype)}
            for b, p in fold_unet2d(model.state_dict()).items()
        }

    def _conv(self, x, name, dilation=1):
        p = self.params[name]
        return F.leaky_relu(F.conv2d(x, p["weight"], p["bias"], padding=dilation,
                                     dilation=dilation), 0.1)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """Final-conv output in the working dtype."""
        if self.channels_last:
            x = x.contiguous(memory_format=torch.channels_last)
        d = self.dilation
        e2 = self._conv(self._conv(x, "encode1", d), "encode2", d)
        e4 = self._conv(self._conv(F.max_pool2d(e2, 2), "encode3", d), "encode4", d)
        e6 = self._conv(self._conv(F.max_pool2d(e4, 2), "encode5", d), "encode6", d)
        e8 = self._conv(self._conv(F.max_pool2d(e6, 2), "encode7", d), "encode8", d)
        h = self._conv(self._conv(F.max_pool2d(e8, 2), "middle_conv1", d), "middle_conv2", d)
        for i, skip in zip(range(1, 5), (e8, e6, e4, e2)):
            up = self.params[f"up{i}"]
            u = F.conv_transpose2d(h, up["weight"], up["bias"], stride=2)
            h = torch.cat([u, skip], dim=1)
            h = self._conv(self._conv(h, f"decode{2 * i - 1}"), f"decode{2 * i}")
        fin = self.params["final"]
        return F.conv2d(h, fin["weight"], fin["bias"])

    def __call__(self, x: torch.Tensor):
        logits = self.logits(x).float()
        return torch.sigmoid(logits), logits
