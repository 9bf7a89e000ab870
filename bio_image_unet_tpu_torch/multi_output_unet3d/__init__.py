"""Multi-output 3D U-Net facade of the port (counterpart of
``bio_image_unet_tpu/multi_output_unet3d/__init__.py``, the surface of the
reference's ``bio_image_unet.multi_output_unet3d``): ``DataProcess``
(``DataProcessMultiOutput3D``), ``Trainer``, ``Predict``
(``PredictMultiOutput3D``), ``MultiOutputUnet3D`` and the losses."""

from ..data.pipelines import DataProcessMultiOutput3D as DataProcess
from ..losses import (BCEDiceLoss, BCEDiceTemporalLoss, BCELoss, SoftDiceLoss,
                      TemporalConsistencyLoss, TverskyLoss, logcoshDiceLoss, logcoshTverskyLoss)
from ..models import MultiOutputUnet3D
from ..predict import PredictMultiOutput3D as Predict
from ..train.trainer import Trainer as _GenericTrainer


class Trainer(_GenericTrainer):
    """multi_output_unet3d.Trainer defaults (reference
    multi_output_unet3d/train.py:57-60): ``MultiOutputUnet3D`` with the
    transposed-conv decoder, per-head ``output_heads`` (the second positional
    argument) with the 3D head losses, gradient clipping at 1.0, plateau
    patience 5 / factor 0.2.  ``loss_function``, ``loss_params`` and
    ``time_loss_weight`` are accepted and dropped, as in JAX (the per-head
    losses govern).  ``device="auto"`` means the card; pass ``device="cpu"``
    to train on the CPU."""

    def __init__(self, dataset, output_heads, num_epochs, network="MultiOutputUnet3D",
                 use_interpolation=False, batch_size=4, lr=1e-3, in_channels=1, n_filter=64,
                 dilation=1, val_split=0.2, save_dir="./", save_name="model.ckpt",
                 save_iter=False, load_weights=False, loss_function="BCEDice",
                 loss_params=(0.5, 0.5), time_loss_weight=None, device="auto", **kwargs):
        del loss_function, loss_params, time_loss_weight
        super().__init__(
            dataset, num_epochs, network=network, use_interpolation=use_interpolation,
            batch_size=batch_size, lr=lr, in_channels=in_channels, output_heads=output_heads,
            n_filter=n_filter, dilation=dilation, val_split=val_split, save_dir=save_dir,
            save_name=save_name, save_iter=save_iter, load_weights=load_weights, grad_clip=1.0,
            scheduler_patience=5, scheduler_factor=0.2, device=device, **kwargs,
        )


__all__ = [
    "DataProcess", "Trainer", "Predict", "MultiOutputUnet3D", "BCEDiceLoss",
    "BCELoss", "SoftDiceLoss", "TverskyLoss", "logcoshDiceLoss",
    "logcoshTverskyLoss", "TemporalConsistencyLoss", "BCEDiceTemporalLoss",
]
