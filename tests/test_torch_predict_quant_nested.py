"""``PredictMultiOutput(quantized=True)`` on UNet++ in the port, held against
the port's bf16 and the JAX package's int8 on the same ``.pt`` (the port on
the CPU: K7, K9, K10 and K11 through their plain versions).

Under ``BIU_INT8_EXPERIMENTAL=1`` the fused path runs the int8 grid (the
engine's forward is an ``Int8NestedUNet``) within JAX's UNet++ int8 bounds
(``tests/test_quant_families.py:203-227``: max under 25% and mean under 3%
of a head's range, floored at 0.5); without it the request warns and runs
bf16, as in JAX (``tests/test_torch_predict_quant.py``).  The models are
BN-warmed in the port at ``n_filter=4``
(``torch_parity.write_seeded_checkpoint``): ``MultiOutputNestedUNet`` (4
levels) and ``MultiOutputNestedUNet_3Levels`` with deep supervision.
"""

import numpy as np
import pytest

from bio_image_unet_tpu.predict import PredictMultiOutput as JPredictMultiOutput
from bio_image_unet_tpu_torch.predict import PredictMultiOutput, quant_nested
from torch_parity import write_seeded_checkpoint

HEADS = {"mask": {"channels": 1, "activation": "sigmoid"},
         "orientation": {"channels": 2, "activation": None}}
# (registry, seed, deep supervision)
MODELS = {"L4": ("MultiOutputNestedUNet", 84, False),
          "L3_ds": ("MultiOutputNestedUNet_3Levels", 85, True)}
TILE = 48


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("predict_quant_nested_pt")
    return {name: write_seeded_checkpoint(root, name, registry, seed, warm=True,
                                          output_heads=HEADS, deep_supervision=deep)[0]
            for name, (registry, seed, deep) in MODELS.items()}


def _movie(seed, n=2, size=80):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size]
    frames = [25 + 150 * np.exp(-((yy - 30 - 5 * i) ** 2 + (xx - 40) ** 2) / 200.0)
              + 50 * rng.random((size, size)) for i in range(n)]
    return np.clip(np.stack(frames), 0, 255).astype(np.uint8)


def _within_bounds(ours, ref, what):
    """JAX's UNet++ int8 bounds (``tests/test_quant_families.py:203-227``),
    relative to a head's output range floored at 0.5, as there."""
    for head in HEADS:
        d = np.abs(np.asarray(ours[head], np.float32) - np.asarray(ref[head], np.float32))
        rg = max(float(np.max(ref[head]) - np.min(ref[head])), 0.5)
        assert d.max() / rg < 0.25, (what, head, d.max() / rg)
        assert d.mean() / rg < 0.03, (what, head, d.mean() / rg)


@pytest.mark.parametrize("name", list(MODELS))
def test_predict_multi_output_quantized_runs_int8(ckpts, monkeypatch, name):
    """Under ``BIU_INT8_EXPERIMENTAL=1`` the fused path runs the int8 grid
    (the engine's forward is an ``Int8NestedUNet``) within JAX's bounds of
    the port's bf16 and of JAX's int8 on the same ``.pt``."""
    monkeypatch.setenv("BIU_INT8_EXPERIMENTAL", "1")
    movie = _movie(7)
    kw = dict(max_patch_size=(TILE, TILE), safe_margin=4, show_progress=False,
              half_precision=True)
    q = PredictMultiOutput(movie, ckpts[name], quantized=True, device="cpu", **kw)
    assert q.engine._quant_ready
    assert isinstance(q.engine.forward, quant_nested.Int8NestedUNet)
    bf16 = PredictMultiOutput(movie, ckpts[name], device="cpu", **kw).result
    _within_bounds(q.result, bf16, "port int8 vs port bf16")
    ref = JPredictMultiOutput(movie, ckpts[name], quantized=True, **kw).result
    _within_bounds(q.result, ref, "port int8 vs JAX int8")
    assert any(not np.array_equal(q.result[h], bf16[h]) for h in HEADS)
