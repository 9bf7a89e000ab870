"""Cross-layout determinism contract, as an executable assertion (a copy of
``bio_image_unet_tpu/testing.py``: numpy only, so the port keeps its own).

The float-compute predict paths run a different forward batch per layout: a
rank of a ``data`` mesh forwards its share of the tiles, one device all of
them, so cuDNN (or the CPU's convolutions) may pick different algorithms and
accumulation orders, which differ by up to 1 ULP.  At the final output
quantization a half-level boundary pixel can then round differently.  The
contract the port promises (and that every mesh-parity test and the
``[mesh]`` phase of ``chip_smoke.py`` hold) is:

- **float paths** (default bf16/fp32 predict): sharded output matches the
  single-device output to at most ONE output quantization level (1 uint8
  level for integer outputs; 2e-3 absolute — one fp16 ULP near 1.0 — for
  float outputs) on at most 0.1% of pixels;
- **int8 paths** (``quantized=True``): bitwise-identical across layouts
  (integer conv math has no rounding freedom) — use
  ``numpy.array_equal`` directly, not this helper;
- **single-layout reruns** are bitwise-deterministic either way.
"""

import numpy as np

__all__ = ["assert_mesh_parity", "MESH_PARITY_MAX_LEVELS",
           "MESH_PARITY_FLOAT_TOL", "MESH_PARITY_MAX_FRACTION"]

# One output quantization level (integer outputs, e.g. uint8 masks).
MESH_PARITY_MAX_LEVELS = 1
# One fp16 ULP near 1.0 (float outputs, e.g. fp16 multi-head results).
MESH_PARITY_FLOAT_TOL = 2e-3
# At most this fraction of pixels may differ at all.
MESH_PARITY_MAX_FRACTION = 1e-3


def assert_mesh_parity(sharded, single):
    """Assert `sharded` equals `single` within the cross-layout contract.

    Integer outputs: <=MESH_PARITY_MAX_LEVELS difference on
    <=MESH_PARITY_MAX_FRACTION of pixels. Float outputs:
    <=MESH_PARITY_FLOAT_TOL absolute on the same fraction. Shapes and
    dtypes must match exactly. Raises AssertionError with the measured
    divergence otherwise.
    """
    sharded, single = np.asarray(sharded), np.asarray(single)
    assert sharded.shape == single.shape, (
        f"shape mismatch: {sharded.shape} vs {single.shape}")
    assert sharded.dtype == single.dtype, (
        f"dtype mismatch: {sharded.dtype} vs {single.dtype}")
    if np.issubdtype(single.dtype, np.integer):
        diff = np.abs(sharded.astype(np.int64) - single.astype(np.int64))
        tol = MESH_PARITY_MAX_LEVELS
    else:
        diff = np.abs(sharded.astype(np.float64) - single.astype(np.float64))
        tol = MESH_PARITY_FLOAT_TOL
    assert diff.max() <= tol, f"max mesh divergence {diff.max()} > {tol}"
    frac = np.mean(diff > 0)
    assert frac <= MESH_PARITY_MAX_FRACTION, (
        f"{frac:.2%} of pixels diverge "
        f"(allowed {MESH_PARITY_MAX_FRACTION:.1%})")
