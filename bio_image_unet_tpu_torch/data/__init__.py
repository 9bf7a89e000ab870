"""Data of the port: the TIFF codec, the 2D training-data pipelines and their
loader, host augmentation, mask morphology, and on-device augmentation (K4,
K4h)."""

from . import augment, augment_device, morphology, pipelines, tiff
from .pipelines import DataLoader, DataProcess2D, DataProcessMultiOutput, Subset, random_split

__all__ = ["tiff", "augment", "augment_device", "morphology", "pipelines", "DataProcess2D",
           "DataProcessMultiOutput", "DataLoader", "Subset", "random_split"]
