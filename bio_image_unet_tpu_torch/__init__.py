"""bio-image-unet-tpu, ported to PyTorch and CUDA for NVIDIA Hopper (H100).

The port sits beside the JAX package ``bio_image_unet_tpu`` (the reference it
is held against) and imports nothing of it, nor JAX.  Its layout mirrors the
JAX package's, so each module's counterpart is easy to find:

- :mod:`~bio_image_unet_tpu_torch.models`     — ``Unet``, ``MultiOutputUnet`` and
  both UNet++ depths (``nn.Module``, float32 or bf16 compute)
- :mod:`~bio_image_unet_tpu_torch.checkpoint` — reference ``.pt`` loading and saving
- :mod:`~bio_image_unet_tpu_torch.interop`    — JAX variables → the port's state dict
- :mod:`~bio_image_unet_tpu_torch.ops`        — blocks and the hand-written kernels
  (K1 clip bounds, K3 sigmoid + stitch, K5/K5s safe-margin stitch) with their
  plain PyTorch versions
- :mod:`~bio_image_unet_tpu_torch.predict`    — BN fold, K2/K2h normalize-and-tile,
  tiled 2D ``Predict`` and ``PredictMultiOutput`` (fused device pipeline and
  host-staged path)
- :mod:`~bio_image_unet_tpu_torch.data`       — the TIFF codec, ``DataProcess2D``,
  ``DataProcessMultiOutput`` and their loader, host augmentation, and the K4 /
  K4h on-device augmentation
- :mod:`~bio_image_unet_tpu_torch.losses`     — the loss zoo
- :mod:`~bio_image_unet_tpu_torch.train`      — the ``Trainer`` of the 2D ``Unet``
  and the multi-output family
- :mod:`~bio_image_unet_tpu_torch.unet`, :mod:`~bio_image_unet_tpu_torch.multi_output_unet`
  — the facades (DataProcess, Trainer, Predict)
- :mod:`~bio_image_unet_tpu_torch.utils`      — device rule, synthetic data,
  TIFF saving, the TensorBoard event writer

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; without a card and without that request they raise.
"""

__version__ = "0.1.0"

from . import checkpoint, progress  # noqa: F401

__all__ = ["checkpoint", "progress", "__version__"]
