"""Process mesh and placement helpers on ``torch.distributed`` (counterpart of
``bio_image_unet_tpu/parallel/mesh.py``).

JAX's mesh is single-controller: one process sees every chip and XLA inserts
the collectives.  PyTorch's idiom is SPMD with one process per device
(``torchrun``): every rank makes the same call with the same arguments, does
its share on its own device and gets the whole result back.  So here the
mesh's "devices" are the ranks of the process group: rank ``r`` of a
``(n_data, n_spatial)`` mesh sits at ``(r // n_spatial, r % n_spatial)``, as
JAX's ``reshape(n_data, n_spatial)`` puts its devices (``mesh.py:58``).  The
mesh carries one process group per data row (the spatial neighbours, for the
halo exchange) and one per spatial column (the data replicas, for gathers and
gradient averages).

With no process group, :func:`get_mesh` is the 1×1 mesh over this process's
device, as JAX's is on one chip, and its collectives are the identity.

Backends: NCCL on the card (``initialize_distributed()``'s default, the rank
bound to ``cuda:LOCAL_RANK``); gloo on the CPU only when the caller asks for
it (``backend="gloo"``, and ``device="cpu"`` to the entry points).  Nothing
picks gloo or the CPU by itself, and no collective stages CUDA tensors through
the host: a mesh refuses a device that its backend does not run on.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

AXES = ("data", "spatial")


def initialize_distributed(**kwargs) -> None:
    """Join this process to the job's process group: a thin wrapper over
    ``torch.distributed.init_process_group`` (JAX's wraps
    ``jax.distributed.initialize``).  The backend defaults to ``"nccl"``,
    bound to this rank's card: ``cuda:LOCAL_RANK`` (``torchrun`` sets it;
    else the rank modulo the card count) becomes the current device and the
    group's ``device_id``.  Without a card the NCCL default raises the port's
    "no CUDA device" error; ``backend="gloo"`` runs the group on the CPU.
    The other keywords (``init_method``, ``rank``, ``world_size``, ...) pass
    through verbatim."""
    kwargs.setdefault("backend", "nccl")
    if kwargs["backend"] == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; the port's process group runs NCCL on the "
                "GPU by default — pass backend='gloo' (and device='cpu' to the entry "
                "points) to run on the CPU explicitly")
        rank = kwargs.get("rank", int(os.environ.get("RANK", 0)))
        local = int(os.environ.get("LOCAL_RANK", rank)) % torch.cuda.device_count()
        torch.cuda.set_device(local)
        kwargs.setdefault("device_id", torch.device("cuda", local))
    dist.init_process_group(**kwargs)


class Mesh:
    """A ``(data, spatial)`` grid of ranks and the process groups along its
    axes.  ``shape`` is ``{"data": n_data, "spatial": n_spatial}`` and
    ``devices`` the (n_data, n_spatial) array of ranks, as in JAX.
    ``coords`` is this process's (data, spatial) position, or None for a
    rank the mesh leaves out (it took part in making the groups and may not
    use the mesh).  ``distributed`` is False for the mesh of one without a
    process group, whose collectives are the identity."""

    def __init__(self, devices: np.ndarray, groups: Dict[str, object],
                 coords: Optional[Tuple[int, int]], backend: Optional[str]):
        self.devices = devices
        self.shape = {"data": int(devices.shape[0]), "spatial": int(devices.shape[1])}
        self.coords = coords
        self.backend = backend
        self._groups = groups
        # the group rank of each position along an axis, so gathers
        # assemble in mesh order whatever the ranks' numbering
        self._order = {}
        if coords is not None and groups:
            d, s = coords
            along = {"data": devices[:, s], "spatial": devices[d, :]}
            self._order = {a: [dist.get_group_rank(groups[a], int(r)) for r in along[a]]
                           for a in AXES}

    @property
    def distributed(self) -> bool:
        return self.backend is not None

    def __repr__(self) -> str:
        return (f"Mesh(data={self.shape['data']}, spatial={self.shape['spatial']}, "
                f"backend={self.backend}, coords={self.coords})")

    def _mine(self) -> Tuple[int, int]:
        if self.coords is None:
            raise RuntimeError(f"rank {dist.get_rank()} is not in this mesh "
                               f"(ranks {self.devices.ravel().tolist()})")
        return self.coords

    def index(self, axis: str) -> int:
        """This process's position along ``axis`` (JAX's ``axis_index``)."""
        return self._mine()[AXES.index(axis)]

    def group(self, axis: str):
        """The process group along ``axis`` that holds this process: its data
        row's spatial neighbours for ``"spatial"``, its spatial column's data
        replicas for ``"data"``; None without a process group."""
        self._mine()
        return self._groups.get(axis)

    def peer(self, axis: str, i: int) -> int:
        """The global rank at position ``i`` along ``axis`` from here."""
        d, s = self._mine()
        return int(self.devices[i, s] if axis == "data" else self.devices[d, i])

    @property
    def device(self) -> torch.device:
        """The device this process's collectives run on: its card under NCCL,
        the CPU under gloo; for the mesh of one, the port's default device
        (the card, raising without one)."""
        if self.backend == "nccl":
            return torch.device("cuda", torch.cuda.current_device())
        if self.backend is not None:
            return torch.device("cpu")
        from ..utils.device import resolve_device

        return resolve_device(None)

    def check_device(self, device: torch.device) -> None:
        """Refuse a device this mesh's backend does not run collectives on
        (a gloo mesh with CUDA tensors would stage them through the host)."""
        if self.backend is None:
            return
        want = "cuda" if self.backend == "nccl" else "cpu"
        if torch.device(device).type != want:
            raise ValueError(f"a {self.backend} mesh runs its collectives on {want} tensors; "
                             f"this call runs on {device} (NCCL: the card; gloo: "
                             "device='cpu')")

    # --- collectives (the identity without a process group) ---

    def all_gather(self, t: torch.Tensor, axis: str = "data", dim: int = 0) -> torch.Tensor:
        """Concatenate every position's ``t`` along ``axis`` on ``dim``, in
        mesh order; every position gets the whole."""
        if not self.distributed:
            return t
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.shape[axis])]
        dist.all_gather(parts, t, group=self.group(axis))
        return torch.cat([parts[g] for g in self._order[axis]], dim)

    def all_reduce(self, t: torch.Tensor, axis: str = "data") -> torch.Tensor:
        """Sum ``t`` over ``axis`` in place (and return it)."""
        if self.distributed:
            dist.all_reduce(t, group=self.group(axis))
        return t


# meshes already made, by (shape, ranks, the default group): new_group is a
# collective every rank must call in the same order, so a mesh is made once
_MESHES: Dict[tuple, Mesh] = {}


def main_process() -> bool:
    """Whether this process writes the files of a call: rank 0 of the
    process group, or the only process."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def _world() -> Tuple[Optional[object], int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD, dist.get_world_size(), dist.get_rank()
    return None, 1, 0


def get_mesh(n_data: Optional[int] = None, n_spatial: int = 1,
             devices: Optional[Sequence[int]] = None) -> Mesh:
    """Build a mesh with axes ``('data', 'spatial')`` over the ranks of the
    process group (``devices``: a list of ranks, all of them by default).

    ``n_data=None`` uses all ranks (divided by ``n_spatial``).  With no
    process group this is the 1×1 mesh of this process, so every code path
    runs unchanged on one device.  Every rank of the group must make the same
    call: it creates the mesh's process groups, one per data row and one per
    spatial column, in the same order everywhere."""
    world, size, rank = _world()
    devices = list(range(size) if devices is None else (int(r) for r in devices))
    if n_data is None:
        n_data = len(devices) // n_spatial
    n = n_data * n_spatial
    if n <= 0:  # e.g. n_spatial > device count → n_data floor-divides to 0
        raise ValueError(
            f"mesh {n_data}x{n_spatial} is empty — n_spatial={n_spatial} "
            f"exceeds the {len(devices)} available device(s)"
        )
    if n > len(devices):
        raise ValueError(
            f"mesh {n_data}x{n_spatial} needs {n} devices, have {len(devices)}"
        )
    grid = np.asarray(devices[:n]).reshape(n_data, n_spatial)
    if world is None:
        return Mesh(grid, {}, (0, 0), None)
    key = (n_data, n_spatial, tuple(grid.ravel().tolist()), id(world))
    if key not in _MESHES:
        groups, mine = {}, {}
        for d in range(n_data):  # the data rows: spatial neighbours
            g = dist.new_group([int(r) for r in grid[d]])
            if rank in grid[d]:
                mine["spatial"] = g
        for s in range(n_spatial):  # the spatial columns: data replicas
            g = dist.new_group([int(r) for r in grid[:, s]])
            if rank in grid[:, s]:
                mine["data"] = g
        where = np.argwhere(grid == rank)
        coords = tuple(int(v) for v in where[0]) if len(where) else None
        _MESHES[key] = Mesh(grid, mine, coords, dist.get_backend())
    return _MESHES[key]


@dataclass(frozen=True)
class Placement:
    """Where a tensor lives on a mesh, by axis name per dimension (JAX's
    ``NamedSharding(mesh, PartitionSpec(...))``).  JAX's placement moves an
    array onto the devices; here every rank holds its own tensors, and
    :meth:`local` cuts a rank's part out of the whole (a replicated tensor is
    the whole)."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...]

    def local(self, t):
        """This rank's contiguous part of ``t`` (a tensor or a numpy array)."""
        for dim, axis in enumerate(self.spec):
            if axis is not None:
                m = t.shape[dim] // self.mesh.shape[axis]
                at = self.mesh.index(axis) * m
                t = t[(slice(None),) * dim + (slice(at, at + m),)]
        return t


def check_mesh(mesh, batch_size: int, device: torch.device) -> Mesh:
    """An entry point's ``mesh=``: a :class:`Mesh` holding this rank, whose
    ``data`` axis divides ``batch_size`` (JAX's words, ``predictor.py:439-443``,
    ``trainer.py:267-271``) and whose backend runs on ``device``."""
    if not isinstance(mesh, Mesh):
        raise TypeError("mesh= takes a bio_image_unet_tpu_torch.parallel.Mesh "
                        f"(get_mesh(...)), got {type(mesh).__name__}")
    if batch_size % mesh.shape["data"] != 0:
        raise ValueError(
            f"batch_size {batch_size} must be divisible by the mesh "
            f"data axis ({mesh.shape['data']})"
        )
    mesh.check_device(device)
    mesh.index("data")  # a rank the mesh leaves out raises here
    return mesh


def data_sharding(mesh: Mesh, ndim: int = 1) -> Placement:
    """Axis 0 (the batch) split over ``data``, the rest replicated."""
    return Placement(mesh, ("data",) + (None,) * (ndim - 1))


def replicated(mesh: Mesh) -> Placement:
    """Whole on every rank (parameters, scalars)."""
    return Placement(mesh, ())


def pad_to_multiple(n: int, k: int) -> int:
    """Smallest multiple of ``k`` that is ≥ ``n`` (≥ k even for n=0)."""
    return max(((n + k - 1) // k) * k, k)


def shard_batch(batch, mesh: Mesh, device=None):
    """Pad a host array's leading axis to a multiple of the ``data`` axis
    size (repeating the last element) and return ``(this rank's contiguous
    slice on its device, n)``; the caller keeps the first ``n`` rows of the
    gathered per-sample result.  ``device`` defaults to the mesh's
    (:attr:`Mesh.device`)."""
    batch = np.asarray(batch)
    n = batch.shape[0]
    k = mesh.shape["data"]
    n_pad = pad_to_multiple(n, k)
    if n_pad != n:
        pad = np.broadcast_to(batch[-1:], (n_pad - n,) + batch.shape[1:])
        batch = np.concatenate([batch, pad], axis=0)
    device = mesh.device if device is None else torch.device(device)
    mesh.check_device(device)
    part = data_sharding(mesh, batch.ndim).local(batch)
    return torch.from_numpy(np.ascontiguousarray(part)).to(device), n
