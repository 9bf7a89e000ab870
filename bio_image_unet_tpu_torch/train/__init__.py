"""Training (counterpart of ``bio_image_unet_tpu/train``): the Trainer of the
2D ``Unet`` and the multi-output family, and its plateau scheduler."""

from .trainer import ReduceLROnPlateau, Trainer

__all__ = ["Trainer", "ReduceLROnPlateau"]
