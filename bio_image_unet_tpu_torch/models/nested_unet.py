"""UNet++ (nested U-Net) with multi-head outputs and deep supervision
(counterpart of ``bio_image_unet_tpu/models/nested_unet.py:34-134``;
reference multi_output_nested_unet.py:58-240).

The dense skip grid ``x_{i,j}`` of ``VGGBlock``s is upsampled with bilinear
``align_corners=True``.  Module names follow the reference schema
(``conv<i>_<j>.conv1.weight``, ``output_layers.<head>[_<level>].weight``), so
a reference ``.pt`` loads with ``strict=True``.

Deep supervision: in train mode (with ``train_mode``) the output dict holds
``{head}_1..{head}_L`` plus ``head`` from the deepest level; in eval mode only
``head`` (``nested_unet.py:104-121``).

``dtype=torch.bfloat16`` is the Trainer's ``half_precision``: parameters stay
float32, every ``VGGBlock`` conv, pool, upsample and concat of the grid runs
in bf16 (BatchNorm in float32), and the 1×1 head convs run in float32 on a
float32 copy of the bf16 level-0 map, as flax promotes the JAX heads, which
have no ``dtype`` (``nested_unet.py:26-31``), before the float32 activations
(``:111-127``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from ..ops.blocks import VGGBlock
from ..ops.functional import max_pool, upsample_linear
from .unet2d import apply_activation

_DEFAULT_HEADS = {"default": {"channels": 1, "activation": "sigmoid"}}


def level_dilations(dilation, levels: int) -> Tuple[int, ...]:
    """Per-level dilation of the backbone column (``nested_unet.py:51-57``):
    False/None → 1 everywhere, an int → that everywhere, a sequence as is."""
    if dilation is False or dilation is None:
        return (1,) * (levels + 1)
    if isinstance(dilation, int):
        return (int(dilation),) * (levels + 1)
    return tuple(int(d) for d in dilation)


class MultiOutputNestedUNet(nn.Module):
    """4-level UNet++ (``nested_unet.py:34``)."""

    levels = 4

    def __init__(self, in_channels: int = 1, output_heads: Optional[Dict[str, dict]] = None,
                 n_filter: int = 32, deep_supervision: bool = False,
                 dilation: Union[bool, int, Sequence[int], None] = False,
                 train_mode: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        L = self.levels
        nb = [n_filter * 2 ** i for i in range(L + 1)]
        self.in_channels = in_channels
        self.n_filter = n_filter
        self.heads = output_heads or _DEFAULT_HEADS
        self.deep_supervision = deep_supervision
        self.train_mode = train_mode
        self.dilations = level_dilations(dilation, L)
        # backbone column x_{i,0}, then the dense grid x_{i,j}: in = nb[i]·j + nb[i+1]
        self.add_module("conv0_0", VGGBlock(in_channels, nb[0], nb[0], self.dilations[0]))
        for i in range(1, L + 1):
            self.add_module(f"conv{i}_0", VGGBlock(nb[i - 1], nb[i], nb[i], self.dilations[i]))
        for j in range(1, L + 1):
            for i in range(L + 1 - j):
                self.add_module(f"conv{i}_{j}", VGGBlock(nb[i] * j + nb[i + 1], nb[i], nb[i]))
        layers = {}
        for head, cfg in self.heads.items():
            for n in ([f"{head}_{lvl}" for lvl in range(1, L + 1)] if deep_supervision
                      else [head]):
                layers[n] = nn.Conv2d(nb[0], cfg["channels"], 1)
        self.output_layers = nn.ModuleDict(layers)
        self.dtype = dtype
        for m in self.modules():
            if isinstance(m, VGGBlock):
                m.compute_dtype = dtype

    def grid(self, x: torch.Tensor) -> Dict[int, Dict[int, torch.Tensor]]:
        """The dense ``x_{i,j}`` grid, column by column (``nested_unet.py:91-102``)."""
        L = self.levels
        col = {0: {0: self.conv0_0(x)}}
        for i in range(1, L + 1):
            col[i] = {0: getattr(self, f"conv{i}_0")(max_pool(col[i - 1][0]))}
            for k in range(i - 1, -1, -1):
                j = i - k
                inputs = [col[k][jj] for jj in range(j)] + [
                    upsample_linear(col[k + 1][j - 1], 2, align_corners=True)]
                col[k][j] = getattr(self, f"conv{k}_{j}")(torch.cat(inputs, dim=1))
        return col

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        if x.shape[1] != self.in_channels:
            raise ValueError(f"expected {self.in_channels} input channels (NCHW), "
                             f"got {x.shape[1]}")
        L = self.levels
        col = self.grid(x)
        outputs = {}
        for name, cfg in self.heads.items():
            act = cfg.get("activation")
            if not self.deep_supervision:
                outputs[name] = apply_activation(
                    self.output_layers[name](col[0][L].float()), act)
                continue
            levels = {lvl: apply_activation(
                self.output_layers[f"{name}_{lvl}"](col[0][lvl].float()), act)
                for lvl in range(1, L + 1)}
            if self.training and self.train_mode:
                for lvl, value in levels.items():
                    outputs[f"{name}_{lvl}"] = value
            outputs[name] = levels[L]
        return outputs


class MultiOutputNestedUNet_3Levels(MultiOutputNestedUNet):
    """3-level UNet++ (``nested_unet.py:131``)."""

    levels = 3
