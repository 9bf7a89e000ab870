"""Building blocks and the hand-written kernels of the fused predict path.

- :mod:`.blocks`    — ``conv_block`` / ``conv_transpose`` with the reference schema
- :mod:`.histogram` — K1 / K1f per-frame clip bounds (``csrc/clip_bounds.cu``)
- :mod:`.stitch`    — K3 sigmoid·255 → uint8 → mean stitch (``csrc/sigmoid_stitch.cu``)
- :mod:`._cuda`     — nvcc build and ctypes binding of ``csrc/*.cu``

K2 (normalize → pad → uint8 → tiles) lives in :mod:`..predict.normalize`.
"""

from .blocks import conv_block, conv_transpose
from .histogram import clip_bounds, float_clip_bounds, int_clip_bounds
from .stitch import sigmoid_stitch

__all__ = ["conv_block", "conv_transpose", "clip_bounds", "int_clip_bounds",
           "float_clip_bounds", "sigmoid_stitch"]
