"""Tiled 2D and 3D inference: the fused device pipeline and the host-staged path.

- :class:`Predict`            ≙ ``bio_image_unet_tpu.predict.Predict`` (K1 → K2 →
  cuDNN forward → K3 per 16-frame chunk)
- :class:`PredictMultiOutput` ≙ ``bio_image_unet_tpu.predict.PredictMultiOutput``
  (K1 → K2h → multi-head forward → K5, with the K5s fill)
- :class:`PredictSiam`        ≙ ``bio_image_unet_tpu.predict.PredictSiam`` (a TIFF
  streamed in chunks of Siam pairs: K1 → K2p → twin-input forward, K6 for the
  ``corr`` join → K3, each chunk appended to the output TIFF)
- :class:`Predict3D`          ≙ ``bio_image_unet_tpu.predict.Predict3D`` (K1 over the
  volume → K2v → 3D forward → K3v)
- :class:`PredictMultiOutput3D` ≙ ``bio_image_unet_tpu.predict.PredictMultiOutput3D``
  (K1 → K2v float tiles → multi-head 3D forward → K5v blend stitch)

``quantized=True`` on ``Predict``, ``PredictMultiOutput`` (``MultiOutputUnet``)
and ``PredictSiam`` (``max``/``control``/``concat``) runs the plain 2D trunk
in w8a8 int8 (:mod:`.quant`, K7–K10) inside the fused pipeline.

Each class takes ``mesh=`` (``parallel.get_mesh``): every rank makes the
same call and gets the whole result, the 2D fused frames path splitting each
chunk's frames over ``data``, the other paths their forward batch.
:func:`predict_frames_spatial_sharded` and :func:`predict_volume_spatial_sharded`
run whole frames (volumes) split over ``spatial`` with a halo exchange
(:mod:`.sharded`).
"""

from .predictor import Predict, Predict3D, PredictMultiOutput, PredictMultiOutput3D, PredictSiam
from .sharded import predict_frames_spatial_sharded, predict_volume_spatial_sharded
from .tiling import grid_starts, overlap_starts, stitch_blend3d, stitch_margin, stitch_mean

__all__ = ["Predict", "PredictMultiOutput", "PredictSiam", "Predict3D", "PredictMultiOutput3D",
           "predict_frames_spatial_sharded", "predict_volume_spatial_sharded",
           "grid_starts", "overlap_starts", "stitch_mean", "stitch_margin", "stitch_blend3d"]
