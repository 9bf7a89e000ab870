"""The JAX Trainer's optimizer state as ``torch.optim.Adam``'s, both ways.

The JAX Trainer optimizes with ``optax.inject_hyperparams(chain(
[clip_by_global_norm(grad_clip)], adam(learning_rate)))``
(``bio_image_unet_tpu/train/trainer.py:275-280``), and its checkpoints hold
that state as flax's ``to_state_dict`` writes it::

    {'count': int32, 'hyperparams': {'learning_rate': float32},
     'hyperparams_states': {},
     'inner_state': {'0': {},                                  # the clip
                     '1': {'0': {'count', 'mu', 'nu'}, '1': {}}}}   # adam

and without ``grad_clip`` ``inner_state`` is ``{'0': {'0': {'count', 'mu',
'nu'}, '1': {}}}``.  ``mu`` / ``nu`` are trees shaped like the parameters.
On the port's side: ``mu`` ↔ ``exp_avg``, ``nu`` ↔ ``exp_avg_sq``, Adam's
``count`` ↔ ``step``, ``learning_rate`` ↔ ``param_groups[0]['lr']``, each
tensor in the layout of its parameter (:func:`weights.to_torch_layout`)
and matched by name (``named_parameters()`` order: a torch state dict
numbers the parameters).  BatchNorm statistics carry no optimizer state.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .torch_ckpt import flax_path
from .weights import to_flax_layout, to_torch_layout

__all__ = ["adam_to_optax", "optax_to_adam", "param_names"]

_BUFFERS = ("running_mean", "running_var", "num_batches_tracked")


def param_names(state_dict) -> List[str]:
    """The parameter keys of a model's state dict in ``named_parameters()``
    order (a module's parameters come before its buffers, modules in the
    same order in both)."""
    return [k for k in state_dict if not k.endswith(_BUFFERS)]


def _adam_node(tree) -> Optional[dict]:
    """The ``{'count', 'mu', 'nu'}`` node of an optax state tree."""
    if isinstance(tree, dict):
        if {"count", "mu", "nu"} <= set(tree):
            return tree
        for v in tree.values():
            found = _adam_node(v)
            if found is not None:
                return found
    return None


def _at(tree: dict, path) -> np.ndarray:
    for name in path:
        tree = tree[name]
    return tree


def _scalar(value) -> float:
    if isinstance(value, torch.Tensor):
        return float(value.item())
    return float(np.asarray(value).reshape(()))


def optax_to_adam(tree: dict, names: List[str]) -> dict:
    """An optax state tree (numpy leaves) → a ``torch.optim.Adam`` state
    dict over the parameters ``names``, numbered in their order (its
    parameter group has the keys and defaults of this torch version's
    Adam, as the Trainer builds it)."""
    adam = _adam_node(tree)
    if adam is None:
        raise ValueError("the optimizer state holds no Adam moments {'count', 'mu', 'nu'}")
    try:
        lr = _scalar(tree["hyperparams"]["learning_rate"])
    except (KeyError, TypeError) as err:
        raise ValueError(f"the optimizer state has no learning_rate: {err}") from None
    step = torch.tensor(_scalar(adam["count"]), dtype=torch.float32)
    state: Dict[int, dict] = {}
    for i, name in enumerate(names):
        path = flax_path(name)[1:]
        try:
            mu, nu = _at(adam["mu"], path), _at(adam["nu"], path)
        except (KeyError, TypeError):
            raise ValueError(f"the optimizer state has no moments for {name!r} "
                             f"({'/'.join(path)})") from None
        state[i] = {"step": step.clone(),
                    "exp_avg": torch.from_numpy(np.array(to_torch_layout(
                        np.asarray(mu, np.float32)))),
                    "exp_avg_sq": torch.from_numpy(np.array(to_torch_layout(
                        np.asarray(nu, np.float32))))}
    group = torch.optim.Adam([torch.zeros(1)], lr=lr).state_dict()["param_groups"][0]
    return {"state": state, "param_groups": [{**group, "params": list(range(len(names)))}]}


def _tree(values: Dict[tuple, np.ndarray]) -> dict:
    out: dict = {}
    for path, arr in values.items():
        node = out
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = arr
    return out


def adam_to_optax(adam_state: dict, names: List[str], shapes: Dict[str, tuple],
                  grad_clip: bool) -> dict:
    """A ``torch.optim.Adam`` state dict over the parameters ``names`` (of
    ``shapes``, the torch layout) → the JAX Trainer's optax state tree, the
    chain laid out with the clip when ``grad_clip``.  A parameter Adam has
    not stepped yet gets zero moments."""
    groups = adam_state["param_groups"]
    if len(groups) != 1:
        raise ValueError(f"the Adam state has {len(groups)} parameter groups, the JAX "
                         "Trainer one")
    order = groups[0]["params"]
    if len(order) != len(names):
        raise ValueError(f"the Adam state covers {len(order)} parameters, the state dict "
                         f"{len(names)}")
    by_index = adam_state["state"]
    steps = {int(_scalar(s["step"])) for s in by_index.values() if "step" in s}
    if len(steps) > 1:
        raise ValueError(f"the parameters have taken different numbers of steps: {steps}")
    count = np.asarray(steps.pop() if steps else 0, np.int32)
    mu, nu = {}, {}
    for idx, name in zip(order, names):
        path = flax_path(name)[1:]
        s = by_index.get(idx)
        if s is None:
            zero = np.zeros(to_flax_layout(np.empty(shapes[name], np.float32)).shape,
                            np.float32)
            mu[path], nu[path] = zero, zero.copy()
            continue
        for out, key in ((mu, "exp_avg"), (nu, "exp_avg_sq")):
            t = s[key].detach().to("cpu", torch.float32).contiguous().numpy()
            out[path] = np.ascontiguousarray(to_flax_layout(t))
    moments = {"count": count, "mu": _tree(mu), "nu": _tree(nu)}
    adam = {"0": moments, "1": {}}
    return {"count": count.copy(),
            "hyperparams": {"learning_rate": np.asarray(groups[0]["lr"], np.float32)},
            "hyperparams_states": {},
            "inner_state": {"0": {}, "1": adam} if grad_clip else {"0": adam}}
