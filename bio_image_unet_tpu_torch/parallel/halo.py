"""Spatial (halo) sharding on ``torch.distributed`` (counterpart of
``bio_image_unet_tpu/parallel/halo.py``, ROADMAP B2).

For frames or volumes too large for one card, the H axis is split over the
mesh's ``spatial`` axis and each rank exchanges ``halo`` boundary rows with
its neighbours, so a stack of convolutions computes the unsharded result as
long as ``halo`` ≥ the half receptive field of the applied function.  The
exchange is point-to-point traffic (``dist.batch_isend_irecv`` over the data
row's process group: NCCL on the card, gloo on the CPU), not a kernel.

The port's tensors are NCHW / NCDHW, so H is axis 2 (frames) or 3
(volumes); JAX's ``spatial_axis`` defaults to its NHWC axis 1.  The argument
is kept and defaults to the port's 2.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from .mesh import Mesh, Placement


def halo_exchange(x: torch.Tensor, halo: int, axis_name: str = "spatial",
                  spatial_axis: int = 2, *, mesh: Mesh) -> torch.Tensor:
    """Pad this rank's block ``x`` with ``halo`` rows from each neighbour
    along ``axis_name`` of ``mesh`` (JAX's runs inside ``shard_map``, which
    binds the axis): (N, C, H_local, ...) → (N, C, H_local + 2·halo, ...).
    The edge ranks receive zeros (conv 'SAME' zero-pad semantics at the
    global border, ``halo.py:45-47``)."""
    n, idx = mesh.shape[axis_name], mesh.index(axis_name)
    h = x.shape[spatial_axis]
    top = x.narrow(spatial_axis, 0, halo).contiguous()
    bottom = x.narrow(spatial_axis, h - halo, halo).contiguous()
    top_halo, bottom_halo = torch.zeros_like(top), torch.zeros_like(bottom)
    if mesh.distributed and n > 1:
        # neighbour i receives my bottom rows as its top halo and vice versa
        group, ops = mesh.group(axis_name), []
        if idx > 0:
            above = mesh.peer(axis_name, idx - 1)
            ops += [dist.P2POp(dist.isend, top, above, group),
                    dist.P2POp(dist.irecv, top_halo, above, group)]
        if idx < n - 1:
            below = mesh.peer(axis_name, idx + 1)
            ops += [dist.P2POp(dist.isend, bottom, below, group),
                    dist.P2POp(dist.irecv, bottom_halo, below, group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return torch.cat([top_halo, x, bottom_halo], spatial_axis)


def spatial_shard_apply(fn: Callable, x: torch.Tensor, mesh: Mesh, halo: int,
                        spatial_axis: int = 2) -> torch.Tensor:
    """Apply ``fn`` (a shift-invariant conv stack with zero-padding
    semantics, shape-preserving over ``spatial_axis``, receptive-field
    half-width ≤ ``halo``) to ``x`` with its ``spatial_axis`` split over the
    mesh's ``spatial`` axis and halos exchanged at the block boundaries.

    Every rank passes the whole ``x`` and gets the whole result: it cuts its
    block, on a 2-D mesh also its share of the batch over ``data`` when that
    divides (``halo.py:84-85``), exchanges halos, applies ``fn``, crops, and
    gathers the blocks (over ``spatial``, then ``data``).  The result is
    ``crop(fn(zero_pad(x, halo)), halo)``: rows farther than ``halo`` from the
    global border equal ``fn(x)``'s; border rows see a zero frame."""
    n_spatial = mesh.shape["spatial"]
    h = x.shape[spatial_axis]
    if h % n_spatial != 0:
        raise ValueError(f"spatial extent {h} not divisible by mesh spatial size {n_spatial}")
    spec = [None] * x.ndim
    spec[spatial_axis] = "spatial"
    n_data = mesh.shape["data"]
    split_batch = n_data > 1 and spatial_axis != 0 and x.shape[0] % n_data == 0
    if split_batch:
        spec[0] = "data"
    block = Placement(mesh, tuple(spec)).local(x)
    out = fn(halo_exchange(block, halo, "spatial", spatial_axis, mesh=mesh))
    out = out.narrow(spatial_axis, halo, out.shape[spatial_axis] - 2 * halo)
    out = mesh.all_gather(out, "spatial", spatial_axis)
    return mesh.all_gather(out, "data", 0) if split_batch else out
