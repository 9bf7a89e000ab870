"""Multi-output U-Net facade of the port (counterpart of
``bio_image_unet_tpu/multi_output_unet/__init__.py``, the surface of the
reference's ``bio_image_unet.multi_output_unet``): ``DataProcess``,
``Trainer``, ``Predict``, the three models and the head losses.  Its
``BCEDiceLoss`` is the probability-space variant
(multi_output_unet/losses.py:8-28)."""

from ..data.pipelines import DataProcessMultiOutput as DataProcess
from ..losses import BCEDiceLossProb as BCEDiceLoss
from ..losses import (DistanceGradientLoss, HuberLoss, MAELoss, MSELoss, TverskyLoss,
                      WeightedDistanceGradientLoss, WeightedVectorFieldLoss, logcoshTverskyLoss)
from ..models import MultiOutputNestedUNet, MultiOutputNestedUNet_3Levels, MultiOutputUnet
from ..predict import PredictMultiOutput as Predict
from ..train.trainer import Trainer as _GenericTrainer


class Trainer(_GenericTrainer):
    """multi_output_unet.Trainer defaults (reference
    multi_output_unet/train.py:19-25): ``MultiOutputNestedUNet``, 4 levels,
    lr 1e-4, per-head ``output_heads``, gradient clipping at 1.0, plateau
    patience 5 / factor 0.2, TensorBoard scalars and validation image grids
    on.  ``device="auto"`` means the card; pass ``device="cpu"`` to train on
    the CPU."""

    def __init__(self, dataset, num_epochs, network="MultiOutputNestedUNet",
                 levels=4, batch_size=4, lr=1e-4, in_channels=1,
                 output_heads=None, n_filter=64, deep_supervision=False,
                 dilation=False, val_split=0.2, save_dir="./",
                 save_name="model.ckpt", save_iter=False, load_weights=False,
                 device="auto", tensorboard=True, log_images=True, **kwargs):
        super().__init__(
            dataset, num_epochs, network=network, levels=levels,
            batch_size=batch_size, lr=lr, in_channels=in_channels,
            output_heads=output_heads, n_filter=n_filter,
            deep_supervision=deep_supervision, dilation=dilation,
            val_split=val_split, save_dir=save_dir, save_name=save_name,
            save_iter=save_iter, load_weights=load_weights, grad_clip=1.0,
            scheduler_patience=5, scheduler_factor=0.2, device=device,
            tensorboard=tensorboard, log_images=log_images, **kwargs,
        )


__all__ = [
    "DataProcess", "Trainer", "Predict", "MultiOutputUnet",
    "MultiOutputNestedUNet", "MultiOutputNestedUNet_3Levels", "BCEDiceLoss",
    "TverskyLoss", "logcoshTverskyLoss", "MSELoss", "MAELoss", "HuberLoss",
    "DistanceGradientLoss", "WeightedDistanceGradientLoss",
    "WeightedVectorFieldLoss",
]
