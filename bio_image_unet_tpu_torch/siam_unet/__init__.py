"""Siamese U-Net facade of the port (counterpart of
``bio_image_unet_tpu/siam_unet/__init__.py``, the surface of the reference's
``bio_image_unet.siam_unet``): ``DataProcess`` (``DataProcessSiam``),
``Trainer``, ``Predict`` (the streaming ``PredictSiam``), ``Siam_UNet`` and
the losses."""

from ..data.pipelines import DataProcessSiam as DataProcess
from ..losses import (BCEDiceLoss, BCELoss2d, SoftDiceLoss, TverskyLoss, logcoshDiceLoss,
                      logcoshTverskyLoss, weightedBCELoss)
from ..models import Siam_UNet
from ..predict import PredictSiam as Predict
from ..train.trainer import Trainer as _GenericTrainer


class Trainer(_GenericTrainer):
    """siam_unet.Trainer defaults (``siam_unet/__init__.py:19-35`` of the JAX
    package; reference siam_unet/train.py:52-54): ``Siam_UNet`` with join
    ``mode``, n_filter 32, 'weightedBCE' available, plateau patience 4 /
    factor 0.1; ``load_weights`` is a checkpoint *path* (siam_unet/train.py:
    96-98).  ``device="auto"`` means the card; pass ``device="cpu"`` to train
    on the CPU."""

    def __init__(self, dataset, num_epochs, batch_size=4, lr=1e-3, n_filter=32,
                 mode="max", val_split=0.2, save_dir="./", save_name="model.ckpt",
                 save_iter=False, loss_function="BCEDice", loss_params=(1, 1),
                 load_weights=None, device="auto", **kwargs):
        super().__init__(
            dataset, num_epochs, network="Siam_UNet", batch_size=batch_size, lr=lr,
            n_filter=n_filter, mode=mode, val_split=val_split, save_dir=save_dir,
            save_name=save_name, save_iter=save_iter, loss_function=loss_function,
            loss_params=loss_params, load_weights=load_weights, scheduler_patience=4,
            scheduler_factor=0.1, device=device, **kwargs,
        )


__all__ = [
    "DataProcess", "Trainer", "Predict", "Siam_UNet", "BCEDiceLoss", "BCELoss2d",
    "SoftDiceLoss", "TverskyLoss", "logcoshDiceLoss", "logcoshTverskyLoss", "weightedBCELoss",
]
