"""Checkpoints of the port (counterpart of ``bio_image_unet_tpu/checkpoint.py``:
``:51 save``, ``:127 load``, ``:89 peek``).

The port reads and writes the reference's ``.pt`` schema: one ``torch.save``'d
dict ``{'state_dict', 'epoch', 'best_loss', **hyperparams}``, plus the
Trainer's ``optimizer_state_dict`` and ``scheduler_state``.  The
hyperparams (``model_name``, ``n_filter``, ``use_interpolation`` of the 3D
models, ``output_heads``, the join ``mode`` of ``Siam_UNet`` — without it a
Siam ``.pt`` takes the class default ``concat``, as in JAX — …) are the
top-level keys; ``models.get_model``
takes the ones a model's constructor names.  :func:`save`
writes only plain Python values (dict, list, tuple, str, int, float, bool,
None) and CPU tensors, so the file reads back both with
``torch.load(weights_only=True)`` and with the JAX package's torch-free
restricted unpickler (``interop/pt_reader.py``), which allows nothing else.

:func:`load` dispatches on the file magic.  ``.pt`` files load through
``torch.load(weights_only=True)``, which executes no pickled code.  The JAX
package's own ``BIUTPU01`` files (a json header plus a msgpack blob) need a
msgpack decoder the port does not have yet, so they raise.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

__all__ = ["save", "load", "peek"]

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


def _plain(obj):
    """``obj`` with every container a plain dict/list/tuple, every tensor a
    contiguous CPU tensor and every numpy scalar a Python number."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().contiguous()
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_plain(v) for v in obj)
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if obj is None or isinstance(obj, (str, int, float, bool)):
        return obj
    raise TypeError(f"cannot write {type(obj).__name__} into a checkpoint readable "
                    "without pickled code")


def save(path, state_dict: Dict[str, torch.Tensor], hyperparams: Optional[Dict[str, Any]] = None,
         epoch: Optional[int] = None, best_loss: Optional[float] = None,
         optimizer_state: Optional[dict] = None) -> None:
    """Write a reference-schema ``.pt``: ``state_dict``, ``epoch``,
    ``best_loss``, the ``hyperparams`` as top-level keys and, when given,
    ``optimizer_state_dict``.  Written to a temporary file and renamed, so a
    crash never leaves a torn checkpoint."""
    ckpt = {"state_dict": _plain(dict(state_dict)), "epoch": epoch,
            "best_loss": None if best_loss is None else float(best_loss)}
    for k, v in (hyperparams or {}).items():
        if k in ckpt:
            raise ValueError(f"hyperparam {k!r} collides with a checkpoint key")
        ckpt[k] = _plain(v)
    if optimizer_state is not None:
        ckpt["optimizer_state_dict"] = _plain(optimizer_state)
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save(ckpt, tmp)
    os.replace(tmp, path)


def _hyperparams(ckpt: dict) -> Dict[str, Any]:
    return {k: v for k, v in ckpt.items()
            if k not in ("state_dict", "optimizer_state_dict")}


def load(path) -> Dict[str, Any]:
    """Load a checkpoint → ``{'state_dict', 'hyperparams', 'epoch',
    'best_loss', 'optimizer_state_dict'}`` (the last None when the file has
    none); tensors stay on the CPU."""
    ckpt = _read_pt(path)
    return {
        "state_dict": dict(ckpt["state_dict"]),
        "hyperparams": _hyperparams(ckpt),
        "epoch": ckpt.get("epoch"),
        "best_loss": ckpt.get("best_loss"),
        "optimizer_state_dict": ckpt.get("optimizer_state_dict"),
    }


def peek(path) -> Dict[str, Any]:
    """The hyperparams/epoch/best_loss of a checkpoint."""
    ckpt = _read_pt(path)
    return {"hyperparams": _hyperparams(ckpt), "epoch": ckpt.get("epoch"),
            "best_loss": ckpt.get("best_loss")}
