"""The port's kernel stages (K1 / K1f clip bounds, K2 normalize-and-tile, K3
sigmoid + stitch), held against the JAX functions they replace.

On the CPU each wrapper takes its plain PyTorch version, so these tests pin
the arithmetic that the CUDA kernels must reproduce; ``test_torch_gpu.py``
holds the kernels against these plain versions on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bio_image_unet_tpu.ops import histogram as jhist
from bio_image_unet_tpu.predict.predictor import (
    _extract_tiles,
    _normalize_clip,
    _stitch_chunk_u8,
    _tile_plan,
)
from bio_image_unet_tpu.predict.tiling import grid_starts
from bio_image_unet_tpu_torch.ops import histogram as thist
from bio_image_unet_tpu_torch.ops.stitch import sigmoid_stitch
from bio_image_unet_tpu_torch.predict.normalize import normalize_tile
from bio_image_unet_tpu_torch.predict.tiling import TilePlan


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


# --- K1 / K1f ---------------------------------------------------------------

def _int_cases(dtype, rng):
    top = np.iinfo(dtype).max
    dup = rng.integers(0, 5, (2, 32, 32)).astype(dtype)
    dup[0, :3] = top  # a tie at the very top
    return [
        ("random", rng.integers(0, top, (3, 37, 53), endpoint=True).astype(dtype)),
        ("constant", np.full((2, 16, 16), top // 3, dtype)),
        ("tiny", rng.integers(0, top, (1, 7, 5), endpoint=True).astype(dtype)),
        ("duplicates", dup),
    ]


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("qs", [(0.0, 99.8), (0.3, 99.7), (50.0, 100.0)])
def test_int_clip_bounds_bit_equal_to_jax(rng, dtype, qs):
    n_bits = 8 * np.dtype(dtype).itemsize
    before = thist.int_clip_bounds.launches
    for name, frames in _int_cases(dtype, rng):
        ours = thist.int_clip_bounds(torch.from_numpy(frames), *qs).numpy()
        ref = np.stack([np.asarray(v) for v in
                        jhist.int_clip_bounds(frames, *qs, n_bits=n_bits)])
        assert ours.shape == (4, frames.shape[0]) and ours.dtype == np.float32
        np.testing.assert_array_equal(_bits(ours), _bits(ref), err_msg=name)
    # the CPU path is the plain version: no kernel launch is counted
    assert thist.int_clip_bounds.launches == before


def _float_cases(rng):
    mixed = (rng.standard_normal((2, 53, 29)) * 50).astype(np.float32)
    mixed[1, :2] = 0.0
    return [
        ("mixed-sign", mixed),
        ("tiny", (rng.random((1, 7, 5)) * 1e-6).astype(np.float32)),
        ("duplicates", rng.integers(-3, 3, (2, 32, 32)).astype(np.float32)),
        ("constant", np.full((2, 16, 16), -3.25, np.float32)),
        ("large", (rng.standard_normal((2, 24, 24)) * 1e30).astype(np.float32)),
    ]


@pytest.mark.parametrize("qs", [(0.0, 99.8), (0.2, 99.98)])
def test_float_clip_bounds_bit_equal_to_jax(rng, qs):
    for name, frames in _float_cases(rng):
        ours = thist.float_clip_bounds(torch.from_numpy(frames), *qs).numpy()
        ref = np.stack([np.asarray(v) for v in jhist.float_clip_bounds(frames, *qs)])
        np.testing.assert_array_equal(_bits(ours), _bits(ref), err_msg=name)


def test_float_clip_bounds_signed_zero(rng):
    """A frame of +0.0 and -0.0 only: the order statistics keep their signs
    (-0.0 sorts below +0.0 in the bit image, as in the JAX search).  The
    clamped extremes are compared by value: which zero a min/max reduction
    returns among equal zeros is left to the library."""
    frames = np.where(rng.random((2, 16, 16)) > 0.5, 0.0, -0.0).astype(np.float32)
    ours = thist.float_clip_bounds(torch.from_numpy(frames), 0.2, 99.8).numpy()
    ref = np.stack([np.asarray(v) for v in jhist.float_clip_bounds(frames, 0.2, 99.8)])
    np.testing.assert_array_equal(_bits(ours[:2]), _bits(ref[:2]))
    np.testing.assert_array_equal(ours[2:], ref[2:])


def test_clip_bounds_dispatch_and_dtype_checks():
    u8 = torch.zeros((1, 4, 4), dtype=torch.uint8)
    f32 = torch.zeros((1, 4, 4), dtype=torch.float32)
    assert thist.clip_bounds(u8, 0, 100).shape == (4, 1)
    assert thist.clip_bounds(f32, 0, 100).shape == (4, 1)
    with pytest.raises(ValueError):
        thist.int_clip_bounds(f32, 0, 100)
    with pytest.raises(ValueError):
        thist.float_clip_bounds(u8, 0, 100)


# --- K2 ---------------------------------------------------------------------

def _jax_normalize_tile(frames, bounds, h, w, th, tw, xs, ys, invert, n_pad):
    """The fused program's lines that K2 replaces (``predictor.py:742-755``)."""
    nx, ny = len(xs), len(ys)
    exact, row_idx, col_idx = _tile_plan(h, w, th, tw, xs, ys)

    @jax.jit
    def run(frames, bounds):
        if bounds.shape[1] == 1:
            lo, hi, fmin, fmax = (bounds[i, 0] for i in range(4))
        else:
            lo, hi, fmin, fmax = (bounds[i][:, None, None] for i in range(4))
        f = _normalize_clip(frames.astype(jnp.float32), lo, hi, fmin, fmax, invert)
        if th > h:
            f = jnp.pad(f, ((0, 0), (0, th - h), (0, 0)), mode="reflect")
        if tw > w:
            f = jnp.pad(f, ((0, 0), (0, 0), (0, tw - w)), mode="reflect")
        patches = _extract_tiles(f.astype(jnp.uint8), nx, ny, th, tw, exact,
                                 row_idx, col_idx)
        n = patches.shape[0]
        if n_pad != n:
            patches = jnp.concatenate(
                [patches, jnp.broadcast_to(patches[-1:], (n_pad - n,) + patches.shape[1:])])
        return patches[..., 0]

    return np.asarray(run(jnp.asarray(frames), jnp.asarray(bounds)))


def _jax_bounds(frames, qs):
    if frames.dtype == np.float32:
        vals = jhist.float_clip_bounds(frames, *qs)
    else:
        vals = jhist.int_clip_bounds(frames, *qs, n_bits=8 * frames.dtype.itemsize)
    return np.stack([np.asarray(v) for v in vals]).astype(np.float32)


def _frames(rng, dtype, shape):
    if dtype == np.float32:
        return (rng.standard_normal(shape) * 40 + 5).astype(np.float32)
    return rng.integers(0, np.iinfo(dtype).max, shape, endpoint=True).astype(dtype)


K2_CASES = [
    # name, dtype, (F, h, w), tile, add_tile, invert, fixed bounds, extra batch pad
    ("exact", np.uint8, (2, 128, 128), 64, 0, False, False, 0),
    ("gather", np.uint16, (2, 96, 96), 64, 0, False, False, 3),
    ("gather-add-tile", np.uint8, (2, 96, 80), 64, 1, False, False, 0),
    ("reflect-pad", np.float32, (2, 48, 80), 64, 0, False, False, 1),
    ("invert", np.uint8, (3, 96, 96), 64, 0, True, False, 0),
    ("fixed-bounds", np.uint16, (2, 128, 128), 64, 0, False, True, 2),
    ("fixed-bounds-float", np.float32, (2, 96, 72), 64, 1, True, True, 0),
]


@pytest.mark.parametrize("case", K2_CASES, ids=[c[0] for c in K2_CASES])
def test_normalize_tile_equals_jax(rng, case):
    name, dtype, (n_frames, h, w), t, add, invert, fixed, extra = case
    frames = _frames(rng, dtype, (n_frames, h, w))
    qs = (0.5, 99.5)
    if fixed:
        # 'first'/'all': one stack-global (lo, hi, lo, hi), as Predict builds it
        b = _jax_bounds(frames[:1], qs)[:, 0]
        bounds = np.array([b[0], b[1], b[0], b[1]], np.float32)[:, None]
    else:
        bounds = _jax_bounds(frames, qs)
    xs, ys = grid_starts(h, t, add), grid_starts(w, t, add)
    plan = TilePlan(h, w, t, t, xs, ys, "cpu")
    n_pad = n_frames * plan.per_frame + extra
    before = normalize_tile.launches
    ours = normalize_tile(torch.from_numpy(frames), torch.from_numpy(bounds), plan,
                          n_pad, invert).numpy()
    assert normalize_tile.launches == before
    ref = _jax_normalize_tile(frames, bounds, h, w, t, t, tuple(xs), tuple(ys),
                              invert, n_pad)
    assert ours.shape == ref.shape == (n_pad, t, t) and ours.dtype == np.uint8
    np.testing.assert_array_equal(ours, ref, err_msg=name)


def test_normalize_tile_rejects_bad_arguments():
    plan = TilePlan(32, 32, 16, 16, [0, 16], [0, 16], "cpu")
    frames = torch.zeros((2, 32, 32), dtype=torch.uint8)
    good = torch.zeros((4, 2), dtype=torch.float32)
    with pytest.raises(ValueError):
        normalize_tile(frames, good, plan, 7, False)  # fewer tiles than the grid
    with pytest.raises(ValueError):
        normalize_tile(frames, torch.zeros((4, 3)), plan, 8, False)
    with pytest.raises(ValueError):
        normalize_tile(frames[:, :16], good, plan, 8, False)
    with pytest.raises(ValueError):
        normalize_tile(frames.to(torch.int32), good, plan, 8, False)


# --- K3 ---------------------------------------------------------------------

def _jax_sigmoid_stitch(logits, n_frames, h, w, th, tw, xs, ys):
    """``_forward_with``'s sigmoid·255 → uint8 (``predictor.py:460-462``)
    followed by ``_stitch_chunk_u8`` (``:117``)."""
    exact, _, _ = _tile_plan(h, w, th, tw, xs, ys)
    per = len(xs) * len(ys)

    @jax.jit
    def run(z):
        probs = jax.nn.sigmoid(z[: n_frames * per].astype(jnp.float32))
        u8 = (probs.astype(jnp.float32) * 255.0).astype(jnp.uint8)[..., None]
        return _stitch_chunk_u8(u8, n_frames, xs, ys, th, tw, h, w,
                                max(th, h), max(tw, w), exact)[..., 0]

    return np.asarray(run(jnp.asarray(logits)))


K3_CASES = [
    # name, (F, h, w), tile, add_tile, extra batch pad, bf16 logits
    ("exact", (2, 128, 128), 64, 0, 0, False),
    ("overlap", (2, 96, 96), 64, 0, 2, False),
    ("overlap-add-tile", (2, 96, 80), 64, 1, 0, False),
    ("reflect-pad", (2, 48, 80), 64, 0, 1, False),
    ("overlap-bf16", (3, 100, 90), 32, 1, 0, True),
]


@pytest.mark.parametrize("case", K3_CASES, ids=[c[0] for c in K3_CASES])
def test_sigmoid_stitch_within_one_level_of_jax(rng, case):
    name, (n_frames, h, w), t, add, extra, bf16 = case
    xs, ys = grid_starts(h, t, add), grid_starts(w, t, add)
    plan = TilePlan(h, w, t, t, xs, ys, "cpu")
    n = n_frames * plan.per_frame + extra
    logits = torch.from_numpy((rng.standard_normal((n, 1, t, t)) * 4).astype(np.float32))
    if bf16:
        logits = logits.to(torch.bfloat16)
    before = sigmoid_stitch.launches
    ours = sigmoid_stitch(logits, n_frames, plan).numpy()
    assert sigmoid_stitch.launches == before
    ref = _jax_sigmoid_stitch(logits.float().numpy()[:, 0], n_frames, h, w, t, t,
                              tuple(xs), tuple(ys))
    assert ours.shape == ref.shape == (n_frames, h, w) and ours.dtype == np.uint8
    # sigmoid may round one ulp apart between the libraries, which moves a
    # tile value across a uint8 boundary at most by one level
    diff = np.abs(ours.astype(int) - ref.astype(int))
    assert diff.max() <= 1, (name, diff.max())
    assert diff.mean() < 1e-3, (name, diff.mean())


def test_sigmoid_stitch_averages_uint8_values_not_probabilities():
    """Overlap means run on the per-tile uint8 values: (200 + 201) / 2 → 200."""
    plan = TilePlan(1, 3, 1, 2, [0], [0, 1], "cpu")
    p = np.array([200.5, 201.5]) / 255.0
    z = np.log(p / (1 - p)).astype(np.float32)
    logits = torch.tensor([[[z[0], z[0]]], [[z[1], z[1]]]], dtype=torch.float32)
    out = sigmoid_stitch(logits, 1, plan).numpy()
    np.testing.assert_array_equal(out, [[[200, 200, 201]]])


@pytest.mark.parametrize("shape,tile,add", [((96, 80), 64, 0), ((100, 90), 32, 1), ((128, 128), 64, 0)])
def test_host_stitch_mean_matches_jax(rng, shape, tile, add):
    from bio_image_unet_tpu.predict.tiling import stitch_mean as jstitch_mean
    from bio_image_unet_tpu_torch.predict.tiling import stitch_mean

    starts = (grid_starts(shape[0], tile, add), grid_starts(shape[1], tile, add))
    n = len(starts[0]) * len(starts[1])
    logits = torch.from_numpy((rng.standard_normal((n, tile, tile)) * 4).astype(np.float32))
    patches = (torch.sigmoid(logits) * 255.0).to(torch.uint8).numpy()[..., None]
    ours = stitch_mean(patches, starts, shape)
    np.testing.assert_allclose(ours, jstitch_mean(patches, starts, shape), rtol=1e-6)
    # K3 is this host mean of the per-tile uint8 values, truncated to uint8
    plan = TilePlan(shape[0], shape[1], tile, tile, *starts, "cpu")
    dev = sigmoid_stitch(logits, 1, plan).numpy()[0]
    np.testing.assert_array_equal(dev, ours[..., 0].astype(np.uint8))
