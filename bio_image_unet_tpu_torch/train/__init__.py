"""Training (counterpart of ``bio_image_unet_tpu/train``): the 2D ``Unet``
Trainer and its plateau scheduler."""

from .trainer import ReduceLROnPlateau, Trainer

__all__ = ["Trainer", "ReduceLROnPlateau"]
