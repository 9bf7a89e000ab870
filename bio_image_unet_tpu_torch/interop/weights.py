"""Carry JAX variables across to the port (counterpart of
``bio_image_unet_tpu/interop/torch_export.py:46 variables_to_torch_state_dict``).

Input is the JAX package's ``{'params', 'batch_stats'}`` tree with numpy (or
array-like) leaves; output is the port's state dict of torch tensors:

- conv kernel (kh, kw, I, O) → (O, I, kh, kw) under ``<block>.0.*``
- transposed-conv kernel (kh, kw, O, I) → (I, O, kh, kw) under ``up<i>.*``
- BatchNorm scale/bias/mean/var → ``<block>.1.{weight,bias,running_mean,
  running_var}`` plus a zero ``num_batches_tracked``
- the 1×1 ``final`` conv → ``final.0.*``
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _t(arr, perm=None) -> torch.Tensor:
    a = np.asarray(arr, dtype=np.float32)
    if perm is not None:
        a = np.transpose(a, perm)
    return torch.from_numpy(np.ascontiguousarray(a))


def state_dict_from_jax(variables: dict) -> Dict[str, torch.Tensor]:
    """JAX ``{'params', 'batch_stats'}`` of a 2D ``Unet`` → the port's
    state dict (loadable with ``load_state_dict(strict=True)``)."""
    params = variables.get("params", {})
    stats = variables.get("batch_stats", {})
    sd: Dict[str, torch.Tensor] = {}
    for block, p in params.items():
        if "conv" in p and "bn" in p:
            sd[f"{block}.0.weight"] = _t(p["conv"]["kernel"], (3, 2, 0, 1))
            sd[f"{block}.0.bias"] = _t(p["conv"]["bias"])
            sd[f"{block}.1.weight"] = _t(p["bn"]["scale"])
            sd[f"{block}.1.bias"] = _t(p["bn"]["bias"])
            bn = stats[block]["bn"]
            sd[f"{block}.1.running_mean"] = _t(bn["mean"])
            sd[f"{block}.1.running_var"] = _t(bn["var"])
            sd[f"{block}.1.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
        elif block.startswith("up") and set(p) == {"kernel", "bias"}:
            sd[f"{block}.weight"] = _t(p["kernel"], (3, 2, 0, 1))
            sd[f"{block}.bias"] = _t(p["bias"])
        elif block == "final":
            sd["final.0.weight"] = _t(p["kernel"], (3, 2, 0, 1))
            sd["final.0.bias"] = _t(p["bias"])
        else:
            raise ValueError(f"unmapped JAX param block: {block!r} "
                             f"(leaves {sorted(p)})")
    return sd
