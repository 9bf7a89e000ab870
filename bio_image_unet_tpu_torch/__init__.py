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
  (K1 clip bounds with its Siam pair-row form and the 256-bin histogram
  oracle, K3/K3v sigmoid + stitch, K5/K5s
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
  training-input generators, frame search, folder image operations, movie
  export (ffmpeg), the napari annotator, host/device introspection
- :mod:`~bio_image_unet_tpu_torch.parallel`   — multi-device on ``torch.distributed``
  (one process per device): the mesh of ranks, the halo exchange, the
  cross-rank BatchNorm; :mod:`~bio_image_unet_tpu_torch.testing` — the
  cross-layout contract ``assert_mesh_parity``
- :mod:`~bio_image_unet_tpu_torch.utils`      — device rule, synthetic data,
  TIFF saving, segmentation metrics, the TensorBoard event writer, the
  smoke recipes (``utils.test``)
- ``python -m bio_image_unet_tpu_torch train|predict|devices`` — the
  command line (:mod:`~bio_image_unet_tpu_torch.__main__`)

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; without a card and without that request they raise.
"""

__version__ = "0.1.0"

from . import checkpoint, losses, progress  # noqa: F401

__all__ = ["checkpoint", "losses", "progress", "__version__"]
