"""2D U-Net facade of the port (counterpart of
``bio_image_unet_tpu/unet/__init__.py``, the surface of the reference's
``bio_image_unet.unet``): ``DataProcess``, ``Trainer``, ``Predict``, the
models ``Unet``, ``AttentionUnet``, ``Unet_v0`` and ``BabyUnet``, and the
losses."""

from ..data.pipelines import DataProcess2D as DataProcess
from ..losses import (BCEDiceLoss, BCELoss2d, SoftDiceLoss, TverskyLoss, logcoshDiceLoss,
                      logcoshTverskyLoss)
from ..models import AttentionUnet, BabyUnet, Unet, Unet_v0
from ..predict import Predict
from ..train.trainer import Trainer as _GenericTrainer


class Trainer(_GenericTrainer):
    """unet.Trainer defaults (reference unet/train.py:58-61): network Unet,
    loss 'BCEDice', plateau patience 4 / factor 0.1.  ``device="auto"`` means
    the card; pass ``device="cpu"`` to train on the CPU."""

    def __init__(self, dataset, num_epochs, network="Unet", batch_size=4,
                 lr=1e-3, in_channels=1, out_channels=1, channel_weights=None,
                 n_filter=64, dilation=1, val_split=0.2, save_dir="./",
                 save_name="model.pt", save_iter=False, load_weights=False,
                 loss_function="BCEDice", loss_params=(0.5, 0.5), device="auto",
                 **kwargs):
        super().__init__(
            dataset, num_epochs, network=network, batch_size=batch_size, lr=lr,
            in_channels=in_channels, out_channels=out_channels,
            channel_weights=channel_weights, n_filter=n_filter, dilation=dilation,
            val_split=val_split, save_dir=save_dir, save_name=save_name,
            save_iter=save_iter, load_weights=load_weights,
            loss_function=loss_function, loss_params=loss_params,
            scheduler_patience=4, scheduler_factor=0.1, device=device, **kwargs,
        )


__all__ = [
    "DataProcess", "Trainer", "Predict", "Unet", "AttentionUnet", "Unet_v0", "BabyUnet",
    "BCEDiceLoss", "BCELoss2d", "SoftDiceLoss",
    "TverskyLoss", "logcoshDiceLoss", "logcoshTverskyLoss",
]
