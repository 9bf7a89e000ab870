"""3D U-Net facade of the port (counterpart of
``bio_image_unet_tpu/unet3d/__init__.py``, the surface of the reference's
``bio_image_unet.unet3d``): ``DataProcess`` (``DataProcess3D``), ``Trainer``,
``Predict`` (``Predict3D``), ``UNet3D`` and the losses."""

from ..data.pipelines import DataProcess3D as DataProcess
from ..losses import (BCEDiceLoss, BCELoss2d, SoftDiceLoss, TverskyLoss, logcoshDiceLoss,
                      logcoshTverskyLoss)
from ..models import UNet3D
from ..predict import Predict3D as Predict
from ..train.trainer import Trainer as _GenericTrainer


class Trainer(_GenericTrainer):
    """unet3d.Trainer defaults (reference unet3d/train.py:59-62): network
    ``UNet3D`` with the transposed-conv decoder (``use_interpolation=True``
    for the trilinear one), loss 'BCEDice', the temporal-consistency term
    ``time_loss_weight=0.1`` (SmoothL1 between batch-adjacent logits),
    plateau patience 4 / factor 0.1.  ``device="auto"`` means the card; pass
    ``device="cpu"`` to train on the CPU."""

    def __init__(self, dataset, num_epochs, network="UNet3D", use_interpolation=False,
                 batch_size=4, lr=1e-3, in_channels=1, out_channels=1, channel_weights=None,
                 n_filter=64, dilation=1, val_split=0.2, save_dir="./", save_name="model.ckpt",
                 save_iter=False, load_weights=False, loss_function="BCEDice",
                 loss_params=(0.5, 0.5), time_loss_weight=0.1, device="auto", **kwargs):
        super().__init__(
            dataset, num_epochs, network=network, use_interpolation=use_interpolation,
            batch_size=batch_size, lr=lr, in_channels=in_channels, out_channels=out_channels,
            channel_weights=channel_weights, n_filter=n_filter, dilation=dilation,
            val_split=val_split, save_dir=save_dir, save_name=save_name, save_iter=save_iter,
            load_weights=load_weights, loss_function=loss_function, loss_params=loss_params,
            time_loss_weight=time_loss_weight, scheduler_patience=4, scheduler_factor=0.1,
            device=device, **kwargs,
        )


__all__ = [
    "DataProcess", "Trainer", "Predict", "UNet3D", "BCEDiceLoss", "BCELoss2d",
    "SoftDiceLoss", "TverskyLoss", "logcoshDiceLoss", "logcoshTverskyLoss",
]
