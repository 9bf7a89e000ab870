"""Building blocks and the hand-written kernels of the fused predict path.

- :mod:`.blocks`    — ``ConvBlock`` / ``ConvTranspose`` with the reference schema
- :mod:`.histogram` — K1 / K1f per-frame clip bounds (``csrc/clip_bounds.cu``)
- :mod:`.stitch`    — K3 sigmoid·255 → uint8 → mean stitch (``csrc/sigmoid_stitch.cu``)
- :mod:`._cuda`     — nvcc build and ctypes binding of ``csrc/*.cu``

K2 (normalize → pad → uint8 → tiles) lives in :mod:`..predict.normalize`,
K4 (gather + augmentation of a training batch) in
:mod:`..data.augment_device`.
"""

from .blocks import ConvBlock, ConvTranspose
from .histogram import clip_bounds, float_clip_bounds, int_clip_bounds
from .stitch import sigmoid_stitch

__all__ = ["ConvBlock", "ConvTranspose", "clip_bounds", "int_clip_bounds",
           "float_clip_bounds", "sigmoid_stitch"]
