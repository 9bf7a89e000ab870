"""The normalization front end of the fused 2D ``Predict`` path on the CPU:
K1 (``ops/histogram``, ``csrc/clip_bounds.cu``) and K2
(``predict/normalize``, ``csrc/normalize_tile.cu``).

- K1's plain version against JAX's ``int_clip_bounds`` / ``float_clip_bounds``
  bit for bit on frames of microscopy statistics (most pixels on a few
  background levels: ``kernel_ab_times.microscopy_frames``, in uint8 and its
  uint16 and float32 twins);
- a numpy model of the kernel's radix select (the digit plan ``DIGITS``, one
  histogram a distinct prefix, the last block's bucket scan) bit-equal to
  the plain version, and the launch grid's limits;
- K2's launch geometry (``_k2_geometry``): every tile pixel written exactly
  once, and the kernel's map from a thread's run to its source pixels
  rebuilding ``normalize_tile_plain``'s tiles;
- a numpy model of K2's division (``NormRN``: a float64 reciprocal, the
  rounded product where it is safely off a midpoint, else an exact
  residual) against IEEE float32 division, on quotients built to lie
  within 2^-43 of a midpoint too.

``test_torch_gpu.py`` holds the kernels themselves against the plain
versions on the card.
"""

import numpy as np
import pytest
import torch

from bio_image_unet_tpu.ops import histogram as jhist
from bio_image_unet_tpu_torch.ops import histogram as thist
from bio_image_unet_tpu_torch.predict import normalize as tnorm
from bio_image_unet_tpu_torch.predict.tiling import TilePlan, grid_starts
from bio_image_unet_tpu_torch.utils.kernel_ab_times import microscopy_frames


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.fixture(scope="module")
def microscopy():
    return dict(zip((np.uint8, np.uint16, np.float32), microscopy_frames(18, 3, 96)))


# --- K1 ---------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
@pytest.mark.parametrize("qs", [(0.0, 99.8), (0.5, 99.5)])
def test_clip_bounds_plain_bit_equal_to_jax_on_microscopy_frames(microscopy, dtype, qs):
    frames = microscopy[dtype]
    values, counts = np.unique(frames[0], return_counts=True)
    assert counts.max() > 0.4 * frames[0].size  # the background level
    ours = thist.clip_bounds_plain(torch.from_numpy(frames), *qs).numpy()
    if dtype == np.float32:
        ref = jhist.float_clip_bounds(frames, *qs)
    else:
        ref = jhist.int_clip_bounds(frames, *qs, n_bits=8 * np.dtype(dtype).itemsize)
    np.testing.assert_array_equal(_bits(ours), _bits(np.stack([np.asarray(v) for v in ref])))


def _keys(flat: np.ndarray) -> np.ndarray:
    """The kernel's order-preserving uint32 keys (csrc/clip_bounds.cu to_key)."""
    if flat.dtype != np.float32:
        return flat.astype(np.int64)
    b = flat.view(np.uint32).astype(np.int64)
    return np.where(b >> 31 == 1, ~b & 0xFFFFFFFF, b | 0x80000000)


def _key_values(keys, dtype) -> np.ndarray:
    keys = np.asarray(keys, np.int64)
    if dtype != np.float32:
        return keys.astype(np.float32)
    b = np.where(keys >> 31 == 1, keys ^ 0x80000000, ~keys & 0xFFFFFFFF)
    return b.astype(np.uint32).view(np.float32)


def _select(hist: np.ndarray, rank: int):
    """The bucket holding ``rank`` and the rank left in it (select_bucket)."""
    cum = np.cumsum(hist)
    bucket = int(np.searchsorted(cum, rank, side="right"))
    return bucket, rank - (int(cum[bucket - 1]) if bucket else 0)


def _radix_select_emulated(flat: np.ndarray, q_lo: float, q_hi: float) -> np.ndarray:
    """The kernel's passes on the CPU: per digit, one histogram for each
    distinct prefix of the four ranked statistics; the min and max as ranks
    0 and P-1 for uint8, else the keys' extremes; the blend in float32 with
    separate rounding steps."""
    n, p = flat.shape
    digits = thist.DIGITS[torch.from_numpy(flat[:1, :1]).dtype]
    ks, fracs = thist._quantile_plan(p, q_lo, q_hi)
    out = np.empty((4, n), np.float32)
    for f in range(n):
        keys = _keys(flat[f])
        pref, rank = [0] * 4, list(ks)
        ext = None
        for d, bits in enumerate(digits):
            shift = sum(digits[d + 1:])
            dig = (keys >> shift) & ((1 << bits) - 1)
            slots = {}
            for s in range(4):
                under = (keys >> (shift + bits)) == pref[s] if d else np.ones(p, bool)
                key = pref[s] if d else 0
                if key not in slots:
                    slots[key] = np.bincount(dig[under], minlength=1 << bits)
                if d == 0 and len(digits) == 1 and ext is None:
                    ext = [_select(slots[key], r)[0] for r in (0, p - 1)]
                bucket, rank[s] = _select(slots[key], rank[s])
                pref[s] = (pref[s] << bits) | bucket
            assert len(slots) <= 4
        kmin, kmax = ext if ext is not None else (keys.min(), keys.max())
        v = _key_values(pref, flat.dtype)
        vmin, vmax = _key_values([kmin, kmax], flat.dtype)
        lo = v[0] + np.float32(fracs[0]) * (v[1] - v[0]) if ks[0] != ks[1] else v[0]
        hi = v[2] + np.float32(fracs[1]) * (v[3] - v[2]) if ks[2] != ks[3] else v[2]
        out[:, f] = (lo, hi, max(vmin, lo), min(vmax, hi))
    return out


def _k1_cases(microscopy, rng, dtype):
    if dtype == np.float32:
        uniform = (rng.standard_normal((2, 40, 50)) * 40 + 5).astype(np.float32)
        ties = rng.integers(-3, 3, (2, 32, 32)).astype(np.float32)
    else:
        top = np.iinfo(dtype).max
        uniform = rng.integers(0, top, (2, 40, 50), endpoint=True).astype(dtype)
        ties = rng.integers(0, 5, (2, 32, 32)).astype(dtype)
    skewed = microscopy[dtype]
    return {"microscopy": skewed, "uniform": uniform, "ties": ties,
            "constant": np.full((1, 16, 16), skewed.flat[7], dtype),
            "pair rows": np.concatenate([skewed[:-1], skewed[1:]], axis=2)}


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
def test_k1_radix_select_model_bit_equal_to_plain(microscopy, rng, dtype):
    for name, frames in _k1_cases(microscopy, rng, dtype).items():
        flat = frames.reshape(frames.shape[0], -1)
        for qs in ((0.0, 99.8), (0.3, 99.7), (50.0, 100.0)):
            ref = thist.clip_bounds_plain(torch.from_numpy(flat), *qs).numpy()
            np.testing.assert_array_equal(_bits(_radix_select_emulated(flat, *qs)), _bits(ref),
                                          err_msg=f"{name} {qs}")


def test_k1_digit_plan_and_grid():
    for dtype, digits in thist.DIGITS.items():
        assert sum(digits) == 8 * torch.empty((), dtype=dtype).element_size()
        assert max(digits) <= 11 and thist.LAUNCHES[dtype] == len(digits)
    # a 16-frame chunk, the Siam pair rows, one 67 M-voxel uint16 volume row
    # and frames too small for a block of loads
    for n, items in ((16, 1024 * 1024 // 16), (8, 2 * 1024 * 1024 // 16),
                     (1, 64 * 1024 * 1024 // 8), (3, 35), (64, 1)):
        bpf = thist._blocks_per_frame(n, items)
        assert 1 <= bpf <= max(1, -(-items // thist._THREADS))
        assert bpf * n <= 4 * 132 + n  # about four blocks an SM over the call


# --- K2 ---------------------------------------------------------------------

def _k2_runs(th: int, tw: int, n_total: int):
    """The (tile, first element, length) of every thread's run of the K2
    launch, as the kernel walks them."""
    run, bpt, iters = tnorm._k2_geometry(th, tw, n_total)
    b = np.arange(n_total * bpt)
    t, strip = b // bpt, b % bpt
    thread, it = np.arange(tnorm._K2_THREADS), np.arange(iters)
    e = ((strip[:, None, None] * iters + it[None, :, None]) * tnorm._K2_THREADS
         + thread[None, None, :]) * run
    keep = e < th * tw
    return np.broadcast_to(t[:, None, None], e.shape)[keep], e[keep], run


@pytest.mark.parametrize("th,tw", [(256, 256), (512, 512), (64, 48), (16, 16), (30, 30),
                                   (37, 53), (8, 24), (128, 1008)])
def test_k2_geometry_writes_every_tile_pixel_once(th, tw):
    n_total = 5
    t, e, run = _k2_runs(th, tw, n_total)
    assert run == (16 if tw % 16 == 0 else 1)
    # a run never leaves its tile row, and the runs cover each tile once
    assert np.all(e % tw + run <= tw)
    written = np.zeros((n_total, th * tw), np.int64)
    np.add.at(written, (t[:, None], e[:, None] + np.arange(run)[None]), 1)
    assert np.all(written == 1)


def _k2_emulated(frames, bounds, plan, n_total, invert):
    """The kernel's map from runs to source pixels on the CPU: tile t shows
    tile min(t, n_real - 1); frame f, grid cell (i, j); row x0 + r and
    column y0 + c reflected at the frame's edge; the values normalized by the
    plain steps, truncated to uint8."""
    norm = tnorm._normalize_clip(frames, bounds, invert, 255.0).to(torch.uint8).numpy()
    th, tw, h, w = plan.th, plan.tw, plan.h, plan.w
    n_real = frames.shape[0] * plan.per_frame
    out = np.full((n_total, th * tw), 7, np.uint8)
    t, e, run = _k2_runs(th, tw, n_total)
    ts = np.minimum(t, n_real - 1)
    f, ij = ts // plan.per_frame, ts % plan.per_frame
    i, j = ij // plan.ny, ij % plan.ny
    cols = e[:, None] % tw + np.arange(run)[None]
    r = np.broadcast_to((e // tw)[:, None], cols.shape)
    pr, pc = plan.xs[i][:, None] + r, plan.ys[j][:, None] + cols
    pr = np.where(pr >= h, 2 * (h - 1) - pr, pr)
    pc = np.where(pc >= w, 2 * (w - 1) - pc, pc)
    out[t[:, None], e[:, None] + np.arange(run)[None]] = norm[f[:, None], pr, pc]
    return out.reshape(n_total, th, tw)


K2_CASES = [
    # name, dtype, frames (n, h, w), tile, add_tile, invert, global bounds
    ("exact", np.uint8, (2, 128, 128), 64, 0, False, False),
    ("gather", np.uint16, (2, 100, 90), 32, 1, False, False),
    ("reflect-pad-invert", np.float32, (2, 40, 56), 64, 0, True, False),
    ("global-bounds", np.uint8, (3, 96, 96), 48, 1, False, True),
    ("odd-tile", np.uint8, (2, 40, 40), 30, 0, False, False),
]


@pytest.mark.parametrize("case", K2_CASES, ids=[c[0] for c in K2_CASES])
def test_k2_run_map_rebuilds_plain_tiles(microscopy, rng, case):
    _, dtype, (n, h, w), tile, add, invert, fixed = case
    if dtype == np.float32:
        frames = microscopy[dtype][:n, :h, :w]
    else:
        frames = rng.integers(0, np.iinfo(dtype).max, (n, h, w), endpoint=True).astype(dtype)
    x = torch.from_numpy(np.ascontiguousarray(frames))
    bounds = thist.clip_bounds(x, 0.5, 99.5)
    if fixed:
        bounds = torch.stack([bounds[0, :1], bounds[1, :1], bounds[0, :1], bounds[1, :1]])
    xs = grid_starts(max(h, tile), tile, add) if h < tile else grid_starts(h, tile, add)
    ys = grid_starts(max(w, tile), tile, add) if w < tile else grid_starts(w, tile, add)
    plan = TilePlan(h, w, tile, tile, xs, ys, "cpu")
    n_total = n * plan.per_frame + 3  # batch padding repeats the last tile
    ref = tnorm.normalize_tile_plain(x, bounds, plan, n_total, invert).numpy()
    np.testing.assert_array_equal(_k2_emulated(x, bounds, plan, n_total, invert), ref)


def _norm_rn(v, lo, hi, fmin, fmax, scale, invert, err):
    """``csrc/normalize_tile.cu`` ``NormRN`` on float32 arrays, the hardware
    reciprocal estimate off by the relative error ``err``; its float64 steps
    are separate IEEE operations (``-fmad=false``), so numpy repeats them bit
    for bit."""
    f32 = np.float32
    v = np.minimum(np.maximum(np.asarray(v, f32), f32(lo)), f32(hi))
    den = f32(fmax) - f32(fmin)
    e = f32(2.0 ** -64) if den > 2.0 ** 100 else (f32(2.0 ** 64) if den < 2.0 ** -100 else f32(1))
    y = np.float64(f32(1.0 / np.float64(den * e) * (1.0 + err))) * np.float64(e)
    inv = y * (2.0 - np.float64(den) * y)
    a = v - f32(fmin)
    m = np.abs(a.astype(np.float64))
    z = m * inv
    low = (z.view(np.int64) & 0x1FFFFFFF) - (1 << 28)
    fast = (z >= 2.0 ** -126) & (np.abs(low) > 8192)
    # the exact path
    bd = np.float64(den)
    q = z.astype(f32)
    r = m - bd * q.astype(np.float64)
    qb = q.view(np.uint32)
    with np.errstate(invalid="ignore", over="ignore"):
        up = (qb + np.uint32(1)).view(f32)
        dn = (qb - np.uint32(1)).view(f32)
        h_up = bd * (0.5 * (up.astype(np.float64) - q))
        h_dn = bd * (0.5 * (q.astype(np.float64) - dn))
        odd = (qb & 1) == 1
        exact = np.where((r > h_up) | ((r == h_up) & odd), up,
                         np.where((-r > h_dn) | ((-r == h_dn) & odd), dn, q))
    quot = np.where(a == 0, a, np.copysign(np.where(fast, q, exact), a))
    out = quot * f32(scale) if fmax > fmin else np.zeros_like(a)
    return f32(scale) - out if invert else out


@pytest.mark.parametrize("err", [0.0, 2.0 ** -21, -(2.0 ** -21)])
def test_k2_division_rounds_as_ieee_division(rng, err):
    """The model of NormRN equals IEEE float32 division: uint16 spans, float
    spans (fractional bounds), spans that take the 2^64 scaling, quotients
    next to powers of two and the subnormal quotients whose ties go to
    even; and on all 256 uint8 levels (K2's table) it equals the plain
    version's steps for random bounds, inverted or not."""
    f32 = np.float32
    cases = []
    for _ in range(300):
        lo = f32(rng.uniform(0, 3000))
        hi = f32(lo + rng.choice([1.0, 7.0, rng.uniform(1, 60000)]))
        cases.append((lo, hi, rng.uniform(lo, hi, 200).astype(f32)))
    for den in (f32(2.0 ** 110), f32(2.0 ** -110), f32(1.5e-39)):
        cases.append((f32(0), den, (rng.random(200) * den).astype(f32)))
    for _ in range(50):  # numerators whose quotient lies next to a power of two
        den = f32(rng.uniform(1, 5000))
        q = (f32(2) ** rng.integers(-12, 0, 40)).astype(f32)
        a = np.concatenate([((q.view(np.int32) + k).view(f32) * den).astype(f32)
                            for k in (-1, 0, 1)])
        cases.append((f32(0), den, np.minimum(a, den)))
    # quotients within 2^-43 of a midpoint between floats, on both sides: for
    # an odd 24-bit D pick the odd 25-bit M with M·D ≡ ±t (mod 2^25), t small;
    # then A = round(M·D / 2^25) over D lies t / 2^48 (relative) off M / 2^25
    for _ in range(200):
        d_int = int(rng.integers(2 ** 23, 2 ** 24)) | 1
        t = int(rng.integers(1, 16)) * 2 - 1
        for sign in (1, -1):
            m_int = (sign * t * pow(d_int, -1, 2 ** 25)) % 2 ** 25
            if m_int < 2 ** 24:
                continue
            a_int = (m_int * d_int + 2 ** 24) >> 25
            den = f32(d_int * 2.0 ** int(rng.integers(-20, 4)))
            a = f32(a_int * 2.0 ** -27) * (den / f32(d_int))
            cases.append((f32(0), den, np.float32([a])))
    # subnormal quotients, ties included: a = k * 2^-149, den = 2
    cases.append((f32(0), f32(2), (np.arange(1, 64) * f32(2.0 ** -149)).astype(f32)))
    for lo, hi, v in cases:
        got = _norm_rn(v, lo, hi, lo, hi, 1.0, False, err)
        want = (v - lo) / (hi - lo)
        np.testing.assert_array_equal(got.view(np.uint32), want.astype(f32).view(np.uint32),
                                      err_msg=f"{lo} {hi}")
    levels = torch.arange(256, dtype=torch.float32)
    for _ in range(200):
        lo, hi = np.sort(rng.uniform(0, 255, 2)).astype(f32)
        fmin, fmax = f32(rng.uniform(lo, hi)), hi
        invert = bool(rng.integers(2))
        bounds = torch.tensor([[lo], [hi], [fmin], [fmax]], dtype=torch.float32)
        want = tnorm._normalize_clip(levels[:, None, None], bounds, invert, 255.0)
        got = _norm_rn(levels.numpy(), lo, hi, fmin, fmax, 255.0, invert, err)
        np.testing.assert_array_equal(got.view(np.uint32), want.numpy().ravel().view(np.uint32))
