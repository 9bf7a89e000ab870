"""Model registry (counterpart of ``bio_image_unet_tpu/models/__init__.py``).
Every registry name of the JAX package is ported: the plain 2D ``Unet``,
``AttentionUnet``, the legacy ``Unet_v0`` and ``BabyUnet``, ``Siam_UNet``
(all four joins), ``MultiOutputUnet``, both UNet++ depths, ``UNet3D`` and
``MultiOutputUnet3D``."""

import inspect

from .legacy import BabyUnet, Unet_v0
from .nested_unet import MultiOutputNestedUNet, MultiOutputNestedUNet_3Levels
from .unet2d import AttentionUnet, MultiOutputUnet, Siam_UNet, Unet
from .unet3d import MultiOutputUnet3D, UNet3D

MODEL_REGISTRY = {
    "Unet": Unet,
    "AttentionUnet": AttentionUnet,
    "Unet_v0": Unet_v0,
    "BabyUnet": BabyUnet,
    "Siam_UNet": Siam_UNet,
    "MultiOutputUnet": MultiOutputUnet,
    "MultiOutputNestedUNet": MultiOutputNestedUNet,
    "MultiOutputNestedUNet_3Levels": MultiOutputNestedUNet_3Levels,
    "UNet3D": UNet3D,
    "MultiOutputUnet3D": MultiOutputUnet3D,
}


def get_model(name, **kwargs):
    """Instantiate a model by registry name or class, dropping unknown kwargs
    (checkpoints carry extra hyperparameters)."""
    if isinstance(name, str):
        if name not in MODEL_REGISTRY:
            raise ValueError(f"unknown model '{name}'; available: "
                             f"{sorted(MODEL_REGISTRY)}")
        cls = MODEL_REGISTRY[name]
    else:
        cls = name
    fields = set(inspect.signature(cls.__init__).parameters) - {"self"}
    return cls(**{k: v for k, v in kwargs.items() if k in fields})


__all__ = ["Unet", "AttentionUnet", "Unet_v0", "BabyUnet", "Siam_UNet", "MultiOutputUnet",
           "MultiOutputNestedUNet", "MultiOutputNestedUNet_3Levels", "UNet3D", "MultiOutputUnet3D", "MODEL_REGISTRY",
           "get_model"]
