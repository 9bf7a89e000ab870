"""Data of the port: the TIFF codec, the 2D training-data pipeline and its
loader, host augmentation, mask morphology, and on-device augmentation (K4)."""

from . import augment, augment_device, morphology, pipelines, tiff
from .pipelines import DataLoader, DataProcess2D, Subset, random_split

__all__ = ["tiff", "augment", "augment_device", "morphology", "pipelines", "DataProcess2D",
           "DataLoader", "Subset", "random_split"]
