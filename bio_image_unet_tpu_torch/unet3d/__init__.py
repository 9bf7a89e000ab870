"""3D U-Net facade of the port (counterpart of
``bio_image_unet_tpu/unet3d/__init__.py``, the surface of the reference's
``bio_image_unet.unet3d``): ``Predict`` (``Predict3D``), ``UNet3D`` and the
losses.  ``DataProcess`` and ``Trainer`` raise NotImplementedError until 3D
training is ported."""

from ..losses import (BCEDiceLoss, BCELoss2d, SoftDiceLoss, TverskyLoss, logcoshDiceLoss,
                      logcoshTverskyLoss)
from ..models import UNet3D
from ..predict import Predict3D as Predict


class DataProcess:
    """``DataProcess3D`` is not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("3D training is not ported yet")


class Trainer:
    """The 3D trainer is not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("3D training is not ported yet")


__all__ = [
    "DataProcess", "Trainer", "Predict", "UNet3D", "BCEDiceLoss", "BCELoss2d",
    "SoftDiceLoss", "TverskyLoss", "logcoshDiceLoss", "logcoshTverskyLoss",
]
