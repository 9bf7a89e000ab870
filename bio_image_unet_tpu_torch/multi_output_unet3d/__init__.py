"""Multi-output 3D U-Net facade of the port (counterpart of
``bio_image_unet_tpu/multi_output_unet3d/__init__.py``, the surface of the
reference's ``bio_image_unet.multi_output_unet3d``): ``Predict``
(``PredictMultiOutput3D``), ``MultiOutputUnet3D`` and the losses.
``DataProcess`` and ``Trainer`` raise NotImplementedError until 3D training
is ported."""

from ..losses import (BCEDiceLoss, BCEDiceTemporalLoss, BCELoss, SoftDiceLoss,
                      TemporalConsistencyLoss, TverskyLoss, logcoshDiceLoss, logcoshTverskyLoss)
from ..models import MultiOutputUnet3D
from ..predict import PredictMultiOutput3D as Predict
from ..unet3d import DataProcess, Trainer

__all__ = [
    "DataProcess", "Trainer", "Predict", "MultiOutputUnet3D", "BCEDiceLoss",
    "BCELoss", "SoftDiceLoss", "TverskyLoss", "logcoshDiceLoss",
    "logcoshTverskyLoss", "TemporalConsistencyLoss", "BCEDiceTemporalLoss",
]
