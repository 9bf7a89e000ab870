"""Multi-device runtime on ``torch.distributed`` (counterpart of
``bio_image_unet_tpu/parallel``): one process per device, every rank making
the same call and getting the whole result back.

- :mod:`.mesh`      — ``initialize_distributed`` (NCCL on the card by
  default, gloo on the CPU on request), the ``(data, spatial)`` mesh of ranks
  with a process group per row and per column, placements, batch padding.
- :mod:`.halo`      — spatial sharding with halo exchange
  (``dist.batch_isend_irecv`` between neighbours; ROADMAP B2).
- :mod:`.batchnorm` — what XLA does for a jitted step on a split batch:
  BatchNorm statistics over the global batch and the loss over the gathered
  outputs.
"""

from .halo import halo_exchange, spatial_shard_apply
from .mesh import (Mesh, data_sharding, get_mesh, initialize_distributed, pad_to_multiple,
                   replicated, shard_batch)

__all__ = [
    "get_mesh",
    "initialize_distributed",
    "data_sharding",
    "replicated",
    "shard_batch",
    "pad_to_multiple",
    "halo_exchange",
    "spatial_shard_apply",
    "Mesh",
]
