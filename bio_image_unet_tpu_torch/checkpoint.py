"""Checkpoints of the port (counterpart of ``bio_image_unet_tpu/checkpoint.py``:
``:51 save``, ``:127 load``, ``:89 peek``).

Two formats, told apart by the file's first 8 bytes:

- the reference's ``.pt`` schema (:func:`save`): one ``torch.save``'d dict
  ``{'state_dict', 'epoch', 'best_loss', **hyperparams}``, plus the
  Trainer's ``optimizer_state_dict`` and ``scheduler_state``.  The
  hyperparams (``model_name``, ``n_filter``, ``use_interpolation`` of the 3D
  models, ``output_heads``, the join ``mode`` of ``Siam_UNet`` — without it a
  Siam ``.pt`` takes the class default ``concat``, as in JAX — …) are the
  top-level keys; ``models.get_model`` takes the ones a model's constructor
  names.  :func:`save` writes only plain Python values (dict, list, tuple,
  str, int, float, bool, None) and CPU tensors, so the file reads back both
  with ``torch.load(weights_only=True)`` (which executes no pickled code)
  and with the JAX package's torch-free restricted unpickler
  (``interop/pt_reader.py``), which allows nothing else;
- the JAX package's own ``BIUTPU01`` files (:func:`save_native`): the magic,
  a ``<I`` header length, a JSON header ``{'format': 1, 'hyperparams',
  'epoch', 'best_loss', 'has_opt_state'}`` and a msgpack blob
  ``{'variables': {'params', 'batch_stats'}[, 'opt_state']}`` in flax's
  encoding (``interop/msgpack_codec.py``), the optimizer state in optax's
  layout (``interop/opt_state.py``).  The JAX Trainer resumes from the
  port's files and the port from the JAX Trainer's.  The port's files also
  carry BatchNorm's ``num_batches_tracked`` (a payload key the JAX package
  does not read); in a file the JAX package wrote they are 0.

:func:`load` returns the same dict for both: the port's state dict (the JAX
trees through ``interop.weights.state_dict_from_jax``), the hyperparams
(the plateau scheduler's ``scheduler_state`` among them), ``epoch``,
``best_loss`` and ``optimizer_state_dict``, a ``torch.optim.Adam`` state
dict numbering the state dict's parameters in its order
(``opt_state.param_names``).  A corrupt file raises ``ValueError`` naming
its path.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Optional

import numpy as np
import torch

from .interop import msgpack_codec
from .interop.opt_state import adam_to_optax, optax_to_adam, param_names
from .interop.torch_ckpt import torch_state_dict_to_variables
from .interop.weights import state_dict_from_jax

__all__ = ["save", "save_native", "load", "peek"]

_MAGIC = b"BIUTPU01"


def _is_native(path) -> bool:
    with open(path, "rb") as fh:
        return fh.read(8) == _MAGIC


def _read_pt(path, meta: bool = False) -> dict:
    """The ``.pt``'s dict, read with ``torch.load(weights_only=True)``; with
    ``meta`` memory-mapped onto the meta device, so no tensor record is read
    (a legacy, pre-zip file cannot be mapped and raises)."""
    extra = {"map_location": "meta", "mmap": True} if meta else {"map_location": "cpu"}
    try:
        ckpt = torch.load(path, weights_only=True, **extra)
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


def _jsonable(obj):
    """Hyperparam values in JSON-encodable form (the JAX package's rules,
    ``checkpoint.py:34``)."""
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return repr(obj)


def save_native(path, state_dict: Dict[str, torch.Tensor],
                hyperparams: Optional[Dict[str, Any]] = None, epoch: Optional[int] = None,
                best_loss: Optional[float] = None, optimizer_state: Optional[dict] = None,
                grad_clip: bool = False) -> None:
    """Write a ``BIUTPU01`` checkpoint that the JAX package's
    ``checkpoint.load`` reads (with ``opt_state_template`` its Trainer
    resumes from it).  ``optimizer_state`` is a ``torch.optim.Adam`` state
    dict over the parameters of ``state_dict`` in their order (a model's own
    ``state_dict()``, or what :func:`load` returns); ``grad_clip`` lays the
    optax chain out with ``clip_by_global_norm`` in front, as a JAX Trainer
    with ``grad_clip`` has it.  Written to a temporary file and renamed."""
    payload = {"variables": torch_state_dict_to_variables(state_dict)}
    counts = {k: np.asarray(int(v), np.int64) for k, v in state_dict.items()
              if k.endswith("num_batches_tracked")}
    if counts:
        # BatchNorm's batch counters have no place in the JAX tree; the JAX
        # package's load ignores this payload key
        payload["num_batches_tracked"] = counts
    if optimizer_state is not None:
        names = param_names(state_dict)
        shapes = {n: tuple(state_dict[n].shape) for n in names}
        payload["opt_state"] = adam_to_optax(optimizer_state, names, shapes, grad_clip)
    blob = msgpack_codec.serialize(payload)
    header = json.dumps({
        "format": 1,
        "hyperparams": _jsonable(hyperparams or {}),
        "epoch": epoch,
        "best_loss": None if best_loss is None else float(best_loss),
        "has_opt_state": optimizer_state is not None,
    }).encode()
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as fh:
        fh.write(_MAGIC)
        fh.write(struct.pack("<I", len(header)))
        fh.write(header)
        fh.write(blob)
    os.replace(tmp, path)


def _native_header(fh, path) -> dict:
    fh.read(8)
    raw = fh.read(4)
    if len(raw) < 4:
        raise ValueError(f"corrupt checkpoint {path!r}: truncated header")
    (n,) = struct.unpack("<I", raw)
    text = fh.read(n)
    if len(text) < n:
        raise ValueError(f"corrupt checkpoint {path!r}: truncated header")
    try:
        header = json.loads(text)
    except (ValueError, UnicodeDecodeError) as err:
        raise ValueError(f"corrupt checkpoint {path!r}: {err}") from None
    if not isinstance(header, dict):
        raise ValueError(f"corrupt checkpoint {path!r}: the header is not a JSON object")
    return header


def _float_leaves(tree):
    """A decoded tree with every tensor leaf (bfloat16) as float32 numpy."""
    if isinstance(tree, dict):
        return {k: _float_leaves(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.float().numpy()
    return tree


def _load_native(path) -> Dict[str, Any]:
    with open(path, "rb") as fh:
        header = _native_header(fh, path)
        # read once into writable memory, which the decoded arrays then share
        blob = memoryview(np.empty(os.fstat(fh.fileno()).st_size - fh.tell(), np.uint8))
        blob = blob[:fh.readinto(blob)]
    try:
        payload = msgpack_codec.restore(blob)
    except ValueError as err:
        raise ValueError(f"corrupt checkpoint {path!r}: {err}") from None
    if not isinstance(payload, dict) or not isinstance(payload.get("variables"), dict):
        raise ValueError(f"corrupt checkpoint {path!r}: missing 'variables' payload")
    try:
        state_dict = state_dict_from_jax(_float_leaves(payload["variables"]))
        for key, count in payload.get("num_batches_tracked", {}).items():
            if key in state_dict:
                state_dict[key] = torch.tensor(int(count), dtype=torch.int64)
        opt = payload.get("opt_state")
        optimizer = (None if opt is None else
                     optax_to_adam(_float_leaves(opt), param_names(state_dict)))
    except (KeyError, TypeError, AttributeError, ValueError) as err:
        raise ValueError(f"corrupt checkpoint {path!r}: {type(err).__name__}: {err}") from None
    hyper = header.get("hyperparams", {})
    return {"state_dict": state_dict,
            "hyperparams": dict(hyper) if isinstance(hyper, dict) else {},
            "epoch": header.get("epoch"), "best_loss": header.get("best_loss"),
            "optimizer_state_dict": optimizer}


def _hyperparams(ckpt: dict) -> Dict[str, Any]:
    return {k: v for k, v in ckpt.items()
            if k not in ("state_dict", "optimizer_state_dict")}


def load(path) -> Dict[str, Any]:
    """Load a ``.pt`` or ``BIUTPU01`` checkpoint → ``{'state_dict',
    'hyperparams', 'epoch', 'best_loss', 'optimizer_state_dict'}`` (the last
    None when the file has none); tensors stay on the CPU."""
    if _is_native(path):
        return _load_native(path)
    ckpt = _read_pt(path)
    return {
        "state_dict": dict(ckpt["state_dict"]),
        "hyperparams": _hyperparams(ckpt),
        "epoch": ckpt.get("epoch"),
        "best_loss": ckpt.get("best_loss"),
        "optimizer_state_dict": ckpt.get("optimizer_state_dict"),
    }


def peek(path) -> Dict[str, Any]:
    """The hyperparams/epoch/best_loss of a checkpoint; of a ``BIUTPU01``
    file its whole JSON header, as the JAX package's ``peek`` returns it.
    Neither format's weight bytes are read: a ``.pt`` is memory-mapped onto
    the meta device.  A legacy (pre-zip) ``.pt`` raises ``ValueError``;
    :func:`load` reads it."""
    if _is_native(path):
        with open(path, "rb") as fh:
            return _native_header(fh, path)
    ckpt = _read_pt(path, meta=True)
    return {"hyperparams": _hyperparams(ckpt), "epoch": ckpt.get("epoch"),
            "best_loss": ckpt.get("best_loss")}
