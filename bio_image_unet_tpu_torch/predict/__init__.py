"""Tiled 2D inference: the fused device pipeline (K1 → K2 → cuDNN forward →
K3 per 16-frame chunk) and the host-staged path.

- :class:`Predict` ≙ ``bio_image_unet_tpu.predict.Predict``
"""

from .predictor import Predict
from .tiling import grid_starts, stitch_mean

__all__ = ["Predict", "grid_starts", "stitch_mean"]
