"""Checkpoint loading for the port (counterpart of
``bio_image_unet_tpu/checkpoint.py:127 load`` and ``:89 peek``).

Dispatches on the file magic.  Reference ``.pt`` files load through
``torch.load(weights_only=True)``, which executes no pickled code.  The JAX
package's own ``BIUTPU01`` files (a json header plus a msgpack blob) need a
msgpack decoder the port does not have yet, so they raise.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

__all__ = ["load", "peek"]

_MAGIC = b"BIUTPU01"


def _read_pt(path) -> dict:
    with open(path, "rb") as fh:
        magic = fh.read(8)
    if magic == _MAGIC:
        raise NotImplementedError(
            f"{path!r} is a BIUTPU01 checkpoint of the JAX package; it is not "
            "yet supported by the port (export it to .pt with "
            "bio_image_unet_tpu.interop.torch_export.export_torch_checkpoint)")
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    except Exception as err:
        raise ValueError(f"cannot read {path!r} as a torch checkpoint with "
                         f"torch.load(weights_only=True): {err}") from err
    if not isinstance(ckpt, dict) or "state_dict" not in ckpt:
        raise ValueError(f"{path!r} is not a reference checkpoint dict "
                         "(missing 'state_dict')")
    return ckpt


def _hyperparams(ckpt: dict) -> Dict[str, Any]:
    return {k: v for k, v in ckpt.items()
            if k not in ("state_dict", "optimizer_state_dict")}


def load(path) -> Dict[str, Any]:
    """Load a checkpoint → ``{'state_dict', 'hyperparams', 'epoch',
    'best_loss'}``; tensors stay on the CPU."""
    ckpt = _read_pt(path)
    return {
        "state_dict": dict(ckpt["state_dict"]),
        "hyperparams": _hyperparams(ckpt),
        "epoch": ckpt.get("epoch"),
        "best_loss": ckpt.get("best_loss"),
    }


def peek(path) -> Dict[str, Any]:
    """The hyperparams/epoch/best_loss of a checkpoint."""
    ckpt = _read_pt(path)
    return {"hyperparams": _hyperparams(ckpt), "epoch": ckpt.get("epoch"),
            "best_loss": ckpt.get("best_loss")}
