"""Model registry (counterpart of ``bio_image_unet_tpu/models/__init__.py``).
Ported so far: the plain 2D ``Unet``, ``AttentionUnet``, ``Siam_UNet`` (all
four joins), ``MultiOutputUnet``, both UNet++ depths, ``UNet3D`` and
``MultiOutputUnet3D``; the other registry names of the JAX package
(``Unet_v0``, ``BabyUnet``) raise a clear "not ported yet" error."""

import inspect

from .nested_unet import MultiOutputNestedUNet, MultiOutputNestedUNet_3Levels
from .unet2d import AttentionUnet, MultiOutputUnet, Siam_UNet, Unet
from .unet3d import MultiOutputUnet3D, UNet3D

MODEL_REGISTRY = {
    "Unet": Unet,
    "AttentionUnet": AttentionUnet,
    "Siam_UNet": Siam_UNet,
    "MultiOutputUnet": MultiOutputUnet,
    "MultiOutputNestedUNet": MultiOutputNestedUNet,
    "MultiOutputNestedUNet_3Levels": MultiOutputNestedUNet_3Levels,
    "UNet3D": UNet3D,
    "MultiOutputUnet3D": MultiOutputUnet3D,
}

# registry names of the JAX package that later slices port
_NOT_PORTED = ("Unet_v0", "BabyUnet")


def get_model(name, **kwargs):
    """Instantiate a model by registry name or class, dropping unknown kwargs
    (checkpoints carry extra hyperparameters)."""
    if isinstance(name, str):
        if name in _NOT_PORTED:
            raise NotImplementedError(
                f"model '{name}' is not ported to PyTorch yet; ported: "
                f"{sorted(MODEL_REGISTRY)}")
        if name not in MODEL_REGISTRY:
            raise ValueError(f"unknown model '{name}'; available: "
                             f"{sorted(MODEL_REGISTRY)}")
        cls = MODEL_REGISTRY[name]
    else:
        cls = name
    fields = set(inspect.signature(cls.__init__).parameters) - {"self"}
    return cls(**{k: v for k, v in kwargs.items() if k in fields})


__all__ = ["Unet", "AttentionUnet", "Siam_UNet", "MultiOutputUnet", "MultiOutputNestedUNet",
           "MultiOutputNestedUNet_3Levels", "UNet3D", "MultiOutputUnet3D", "MODEL_REGISTRY",
           "get_model"]
