"""Data of the port: the TIFF codec, the 2D and 3D training-data pipelines and
their loader (the Siam pairs' too), host augmentation, mask morphology, and
on-device augmentation (K4, K4h, K4v, K4hv)."""

from . import augment, augment_device, morphology, pipelines, tiff
from .pipelines import (DataLoader, DataProcess2D, DataProcess3D, DataProcessMultiOutput,
                        DataProcessMultiOutput3D, DataProcessSiam, Subset, clip_and_normalize,
                        edit_mask, random_split, tile_starts)

__all__ = ["tiff", "augment", "augment_device", "morphology", "pipelines", "DataProcess2D",
           "DataProcessSiam", "DataProcessMultiOutput", "DataProcess3D",
           "DataProcessMultiOutput3D", "DataLoader", "Subset", "random_split",
           "clip_and_normalize", "edit_mask", "tile_starts"]
