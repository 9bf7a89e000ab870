"""Carry JAX variables across to the port (counterpart of
``bio_image_unet_tpu/interop/torch_export.py:46 variables_to_torch_state_dict``).

Input is the JAX package's ``{'params', 'batch_stats'}`` tree with numpy (or
array-like) leaves; output is the port's state dict of torch tensors:

- conv kernel (*k, I, O) → (O, I, *k) under ``<block>.0.*`` (2D: (kh, kw);
  3D: (kd, kh, kw)), the ConvBlocks ``up<i>_conv`` of ``MultiOutputUnet3D``,
  ``conv_concat`` of a ``concat`` ``Siam_UNet`` and the legacy models' extra
  1-channel block (``decode9`` of ``Unet_v0``, ``decode7`` of ``BabyUnet``)
  included
- transposed-conv kernel (*k, O, I) → (I, O, *k) under ``up<i>.*``
- BatchNorm scale/bias/mean/var → ``<block>.1.{weight,bias,running_mean,
  running_var}`` plus a zero ``num_batches_tracked``
- the 1×1 ``final`` conv → ``final.0.*`` in 2D; ``UNet3D``'s is a bare
  ``Conv3d``, ``final.*``
- the 1×1 head convs ``output_layers_<head>`` → ``output_layers.<head>.*``
- UNet++ grid blocks ``grid_conv<i>_<j>/conv{1,2}|bn{1,2}`` →
  ``conv<i>_<j>.conv{1,2}.*`` / ``conv<i>_<j>.bn{1,2}.*``
- attention gates ``attention<k>/{W_gate,W_x,psi}_{conv,bn}`` (with their
  batch statistics) → ``attention<k>.{W_gate,W_x,psi}.{0,1}.*``

Any other block raises.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..ops.blocks import GATES


def _t(arr) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(arr, dtype=np.float32)))


def _kernel(arr) -> torch.Tensor:
    """(*k, A, B) → (B, A, *k) at any spatial rank: a conv's (*k, I, O) to
    (O, I, *k), a transposed conv's (*k, O, I) to (I, O, *k)."""
    a = np.asarray(arr, dtype=np.float32)
    nsp = a.ndim - 2
    return _t(np.transpose(a, (nsp + 1, nsp) + tuple(range(nsp))))


def _conv_bn(sd, prefix_conv: str, prefix_bn: str, conv: dict, bn: dict, stats: dict) -> None:
    sd[f"{prefix_conv}.weight"] = _kernel(conv["kernel"])
    sd[f"{prefix_conv}.bias"] = _t(conv["bias"])
    sd[f"{prefix_bn}.weight"] = _t(bn["scale"])
    sd[f"{prefix_bn}.bias"] = _t(bn["bias"])
    sd[f"{prefix_bn}.running_mean"] = _t(stats["mean"])
    sd[f"{prefix_bn}.running_var"] = _t(stats["var"])
    sd[f"{prefix_bn}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def state_dict_from_jax(variables: dict) -> Dict[str, torch.Tensor]:
    """JAX ``{'params', 'batch_stats'}`` of a 2D ``Unet``, ``AttentionUnet``,
    ``Unet_v0``, ``BabyUnet``, ``Siam_UNet``, ``MultiOutputUnet``, UNet++, ``UNet3D`` or
    ``MultiOutputUnet3D`` → the port's state dict
    (loadable with ``load_state_dict(strict=True)``)."""
    params = variables.get("params", {})
    stats = variables.get("batch_stats", {})
    sd: Dict[str, torch.Tensor] = {}
    for block, p in params.items():
        if "conv" in p and "bn" in p:
            _conv_bn(sd, f"{block}.0", f"{block}.1", p["conv"], p["bn"], stats[block]["bn"])
        elif block.startswith("grid_") and set(p) == {"conv1", "bn1", "conv2", "bn2"}:
            base = block[len("grid_"):]
            for k in ("1", "2"):
                _conv_bn(sd, f"{base}.conv{k}", f"{base}.bn{k}", p[f"conv{k}"], p[f"bn{k}"],
                         stats[block][f"bn{k}"])
        elif block.startswith("attention") and set(p) == {
                f"{sub}_{kind}" for sub in GATES for kind in ("conv", "bn")}:
            for sub in GATES:
                _conv_bn(sd, f"{block}.{sub}.0", f"{block}.{sub}.1", p[f"{sub}_conv"],
                         p[f"{sub}_bn"], stats[block][f"{sub}_bn"])
        elif block.startswith("up") and set(p) == {"kernel", "bias"}:
            sd[f"{block}.weight"] = _kernel(p["kernel"])
            sd[f"{block}.bias"] = _t(p["bias"])
        elif block == "final":
            prefix = "final" if np.ndim(p["kernel"]) == 5 else "final.0"
            sd[f"{prefix}.weight"] = _kernel(p["kernel"])
            sd[f"{prefix}.bias"] = _t(p["bias"])
        elif block.startswith("output_layers_") and set(p) == {"kernel", "bias"}:
            head = block[len("output_layers_"):]
            sd[f"output_layers.{head}.weight"] = _kernel(p["kernel"])
            sd[f"output_layers.{head}.bias"] = _t(p["bias"])
        else:
            raise ValueError(f"unmapped JAX param block: {block!r} "
                             f"(leaves {sorted(p)})")
    return sd
