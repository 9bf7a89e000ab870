"""The port's state dicts as the JAX package's variable trees (counterpart of
``bio_image_unet_tpu/interop/torch_ckpt.py``: ``:64 torch_key_to_flax``,
``:134 torch_state_dict_to_variables``, ``:150 load_torch_checkpoint``, and
of ``bio_image_unet_tpu/interop/torch_export.py:140 export_torch_checkpoint``).

:func:`torch_state_dict_to_variables` is the inverse of
``weights.state_dict_from_jax``: ``{'params', 'batch_stats'}`` nested dicts
of float32 numpy arrays, with the key rules of the JAX package (kept here as
a copy):

====================================  =========================================
state-dict key                        JAX path
====================================  =========================================
``<block>.0.weight``  (Conv)          ``params/<block>/conv/kernel``  (O,I,*k)→(*k,I,O)
``<block>.0.bias``                    ``params/<block>/conv/bias``
``<block>.1.weight|bias`` (BN)        ``params/<block>/bn/scale|bias``
``<block>.1.running_mean|var``        ``batch_stats/<block>/bn/mean|var``
``up<k>.weight``      (ConvT)         ``params/up<k>/kernel``  (I,O,*k)→(*k,O,I)
``final.0.*`` / ``final.*``           ``params/final/*``
``attention<k>.W_gate.0|1.*``         ``params/attention<k>/W_gate_conv|W_gate_bn/*``
``conv<i>_<j>.conv1|bn1.*`` (UNet++)  ``params/grid_conv<i>_<j>/conv1|bn1/*``
``output_layers.<name>.*``            ``params/output_layers_<name>/*``
====================================  =========================================

The Sequential rule covers Siam's ``conv_concat``, the legacy ``decode9`` /
``decode7`` and ``MultiOutputUnet3D``'s ``up<k>_conv`` ConvBlocks;
``num_batches_tracked`` has no counterpart and is dropped.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .weights import state_dict_from_jax, to_flax_layout

__all__ = ["torch_key_to_flax", "torch_state_dict_to_variables", "load_torch_checkpoint",
           "export_torch_checkpoint", "flax_path"]

_ATTENTION_SUB = re.compile(r"^(attention\d+)\.(W_gate|W_x|psi)\.(\d)\.(.+)$")
_VGG_SUB = re.compile(r"^(conv\d+_\d+)\.(conv|bn)(\d)\.(.+)$")
_HEAD_SUB = re.compile(r"^output_layers\.([^.]+)\.(weight|bias)$")
_SEQ_SUB = re.compile(r"^(.+)\.(\d)\.(.+)$")
_UP_SUB = re.compile(r"^(up\d+)\.(weight|bias)$")
_PLAIN_CONV_SUB = re.compile(r"^(final)\.(weight|bias)$")


def _layer(path: Tuple[str, ...], is_conv: bool, leaf: str) -> Tuple[str, ...]:
    names = ({"weight": ("params", "kernel"), "bias": ("params", "bias")} if is_conv else
             {"weight": ("params", "scale"), "bias": ("params", "bias"),
              "running_mean": ("batch_stats", "mean"), "running_var": ("batch_stats", "var")})
    if leaf not in names:
        raise ValueError(f"unrecognized leaf {leaf!r} at {'/'.join(path)}")
    root, name = names[leaf]
    return (root, *path, name)


def flax_path(key: str) -> Optional[Tuple[str, ...]]:
    """The JAX path (``('params' | 'batch_stats', block, ..., leaf)``) of a
    state-dict key; None for ``num_batches_tracked``.  Raises ValueError on
    a key no rule covers."""
    if key.endswith("num_batches_tracked"):
        return None
    m = _ATTENTION_SUB.match(key)
    if m:
        block, sub, idx, leaf = m.groups()
        return _layer((block, f"{sub}_{'conv' if idx == '0' else 'bn'}"), idx == "0", leaf)
    m = _VGG_SUB.match(key)
    if m:
        block, kind, num, leaf = m.groups()
        return _layer((f"grid_{block}", f"{kind}{num}"), kind == "conv", leaf)
    m = _HEAD_SUB.match(key)
    if m:
        name, leaf = m.groups()
        return ("params", f"output_layers_{name}", "kernel" if leaf == "weight" else "bias")
    m = _UP_SUB.match(key) or _PLAIN_CONV_SUB.match(key)
    if m:
        block, leaf = m.groups()
        return ("params", block, "kernel" if leaf == "weight" else "bias")
    m = _SEQ_SUB.match(key)
    if m:
        block, idx, leaf = m.groups()
        if block == "final":  # final.0.*: the Sequential around the 1×1 conv
            return ("params", "final", "kernel" if leaf == "weight" else "bias")
        return _layer((block, "conv" if idx == "0" else "bn"), idx == "0", leaf)
    raise ValueError(f"unrecognized torch checkpoint key: {key}")


def torch_key_to_flax(key: str, value) -> Optional[Tuple[Tuple[str, ...], np.ndarray]]:
    """One state-dict entry → (JAX path, array in JAX's layout); None for
    entries with no JAX counterpart (``num_batches_tracked``)."""
    path = flax_path(key)
    if path is None:
        return None
    return path, to_flax_layout(_numpy(value))


def _numpy(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        value = value.detach().to("cpu", torch.float32).contiguous().numpy()
    return np.asarray(value, dtype=np.float32)


def torch_state_dict_to_variables(state_dict: Dict[str, object]) -> dict:
    """A state dict (tensors or arrays) → JAX's ``{'params', 'batch_stats'}``
    nested dicts of float32 numpy arrays."""
    out: dict = {}
    for key, value in state_dict.items():
        mapped = torch_key_to_flax(key, value)
        if mapped is None:
            continue
        path, arr = mapped
        node = out
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = np.ascontiguousarray(arr)
    return out


def load_torch_checkpoint(path) -> dict:
    """A reference ``.pt`` → ``{'variables', 'hyperparams', 'epoch',
    'best_loss'}``, the variables in JAX's tree; read with
    ``torch.load(weights_only=True)``."""
    from ..checkpoint import load

    state = load(path)
    return {"variables": torch_state_dict_to_variables(state["state_dict"]),
            "hyperparams": state["hyperparams"], "epoch": state["epoch"],
            "best_loss": state["best_loss"]}


def export_torch_checkpoint(path, variables: dict, hyperparams: Optional[dict] = None,
                            epoch=None, best_loss=None,
                            final_sequential: Optional[bool] = None) -> None:
    """Write a reference-loadable ``.pt`` from a JAX ``{'params',
    'batch_stats'}`` tree of numpy arrays (through ``state_dict_from_jax``).
    ``final_sequential`` as in JAX: True writes the ``final`` conv as
    ``final.0.*``, False as ``final.*``; None recognises a ``UNet3D``'s bare
    ``final`` conv by its 5-D kernel."""
    from ..checkpoint import save

    save(path, state_dict_from_jax(variables, final_sequential), hyperparams, epoch=epoch,
         best_loss=best_loss)
