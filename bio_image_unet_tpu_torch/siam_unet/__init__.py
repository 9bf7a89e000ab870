"""Siamese U-Net facade of the port (counterpart of
``bio_image_unet_tpu/siam_unet/__init__.py``, the surface of the reference's
``bio_image_unet.siam_unet``): ``Predict`` (the streaming ``PredictSiam``),
``Siam_UNet`` and the losses.  ``DataProcess`` and ``Trainer`` raise
NotImplementedError until the Siam training slice ports
``DataProcessSiam`` and the Trainer's ``mode=``."""

from ..losses import (BCEDiceLoss, BCELoss2d, SoftDiceLoss, TverskyLoss, logcoshDiceLoss,
                      logcoshTverskyLoss, weightedBCELoss)
from ..models import Siam_UNet
from ..predict import PredictSiam as Predict


class DataProcess:
    """``DataProcessSiam`` is not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("Siam training (DataProcessSiam) is not ported yet: the "
                                  "Siam training slice ports it")


class Trainer:
    """The siamese trainer is not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("Siam training (the Trainer's mode=) is not ported yet: the "
                                  "Siam training slice ports it")


__all__ = [
    "DataProcess", "Trainer", "Predict", "Siam_UNet", "BCEDiceLoss", "BCELoss2d",
    "SoftDiceLoss", "TverskyLoss", "logcoshDiceLoss", "logcoshTverskyLoss", "weightedBCELoss",
]
