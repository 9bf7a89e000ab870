"""Tiled 2D inference: the fused device pipeline and the host-staged path.

- :class:`Predict`            ≙ ``bio_image_unet_tpu.predict.Predict`` (K1 → K2 →
  cuDNN forward → K3 per 16-frame chunk)
- :class:`PredictMultiOutput` ≙ ``bio_image_unet_tpu.predict.PredictMultiOutput``
  (K1 → K2h → multi-head forward → K5, with the K5s fill)
"""

from .predictor import Predict, PredictMultiOutput
from .tiling import grid_starts, stitch_margin, stitch_mean

__all__ = ["Predict", "PredictMultiOutput", "grid_starts", "stitch_mean", "stitch_margin"]
