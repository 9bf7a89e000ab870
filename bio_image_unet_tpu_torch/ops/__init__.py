"""Building blocks and the hand-written kernels of the fused predict path.

- :mod:`.blocks`    — ``ConvBlock`` (2D and 3D) / ``ConvTranspose`` /
  ``ConvTranspose3D`` with the reference schema
- :mod:`.histogram` — K1 / K1f per-frame clip bounds and their Siam pair-row
  form (``csrc/clip_bounds.cu``)
- :mod:`.stitch`    — K3 / K3v sigmoid·255 → uint8 → mean stitch of frames /
  a volume (``csrc/sigmoid_stitch.cu``); K5 safe-margin weighted stitch, K5s
  tile sum and K5v 3D linear-blend stitch (``csrc/margin_stitch.cu``)
- :mod:`.functional` — max pool, nearest and linear resampling at spatial
  rank 2 and 3; K6, the depthwise cross-correlation of the Siam ``corr`` join
  (``csrc/depthwise_xcorr.cu``)
- :mod:`.int8`      — K7–K10, the w8a8 int8 trunk's 3×3 conv, 2×2 up-conv,
  requant and max pool (``csrc/int8_trunk.cu``)
- :mod:`._cuda`     — nvcc build and ctypes binding of ``csrc/*.cu``

K2 (normalize → pad → uint8 → tiles), K2h (its float-tile mode), K2v
(their 3D form) and K2p (the Siam pair mode) live in
:mod:`..predict.normalize`,
K4 (gather + augmentation of a training batch) in
:mod:`..data.augment_device`.
"""

from .blocks import ConvBlock, ConvTranspose, ConvTranspose3D, VGGBlock
from .histogram import clip_bounds, float_clip_bounds, int_clip_bounds
from .stitch import blend_stitch_3d, margin_stitch, sigmoid_stitch, sigmoid_stitch_3d, tile_sum

__all__ = ["ConvBlock", "ConvTranspose", "ConvTranspose3D", "VGGBlock", "clip_bounds",
           "int_clip_bounds", "float_clip_bounds", "sigmoid_stitch", "sigmoid_stitch_3d",
           "margin_stitch", "tile_sum", "blend_stitch_3d"]
