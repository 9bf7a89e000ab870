"""bio-image-unet-tpu, ported to PyTorch and CUDA for NVIDIA Hopper (H100).

The port sits beside the JAX package ``bio_image_unet_tpu`` (the reference it
is held against) and imports nothing of it, nor JAX.  Its layout mirrors the
JAX package's, so each module's counterpart is easy to find:

- :mod:`~bio_image_unet_tpu_torch.models`     — ``Unet``, ``Siam_UNet`` (joins
  ``max``, ``concat``, ``corr``, ``control``), ``MultiOutputUnet``, both UNet++
  depths, ``UNet3D`` and ``MultiOutputUnet3D`` (``nn.Module``, float32 or bf16
  compute)
- :mod:`~bio_image_unet_tpu_torch.checkpoint` — reference ``.pt`` loading and saving
- :mod:`~bio_image_unet_tpu_torch.interop`    — JAX variables → the port's state dict
- :mod:`~bio_image_unet_tpu_torch.ops`        — blocks and the hand-written kernels
  (K1 clip bounds with its Siam pair-row form, K3/K3v sigmoid + stitch, K5/K5s
  safe-margin stitch, K5v 3D blend stitch, K6 depthwise cross-correlation and
  K6b its backward,
  K7–K10 the int8 trunk's conv, up-conv, requant and max pool) with their
  plain PyTorch versions
- :mod:`~bio_image_unet_tpu_torch.predict`    — BN fold, K2/K2h/K2v/K2p
  normalize-and-tile, the w8a8 int8 trunk (``quantized=True``), and the five
  predictors: tiled ``Predict``, ``PredictMultiOutput``, the streaming
  ``PredictSiam``, ``Predict3D`` and ``PredictMultiOutput3D`` (fused device
  pipeline and host-staged path)
- :mod:`~bio_image_unet_tpu_torch.data`       — the TIFF codec, ``DataProcess2D``,
  ``DataProcessSiam``, ``DataProcessMultiOutput``, ``DataProcess3D``, ``DataProcessMultiOutput3D``
  and their loader, host augmentation, and the K4 / K4h / K4v / K4hv
  on-device augmentation
- :mod:`~bio_image_unet_tpu_torch.losses`     — the loss zoo
- :mod:`~bio_image_unet_tpu_torch.train`      — the ``Trainer`` of the 2D ``Unet``,
  ``Siam_UNet`` (``mode=``), the multi-output family (``MultiOutputUnet``, both
  UNet++ depths), ``UNet3D`` and ``MultiOutputUnet3D``
- :mod:`~bio_image_unet_tpu_torch.unet`, :mod:`~bio_image_unet_tpu_torch.multi_output_unet`,
  :mod:`~bio_image_unet_tpu_torch.unet3d`,
  :mod:`~bio_image_unet_tpu_torch.multi_output_unet3d` — the facades
  (DataProcess, Trainer, Predict); :mod:`~bio_image_unet_tpu_torch.siam_unet` —
  the Siam facade (DataProcess, Trainer, Predict, ``Siam_UNet``, the losses)
- :mod:`~bio_image_unet_tpu_torch.tools`      — host helpers: the Siam
  training-input generators
- :mod:`~bio_image_unet_tpu_torch.utils`      — device rule, synthetic data,
  TIFF saving, the TensorBoard event writer

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; without a card and without that request they raise.
"""

__version__ = "0.1.0"

from . import checkpoint, progress  # noqa: F401

__all__ = ["checkpoint", "progress", "__version__"]
