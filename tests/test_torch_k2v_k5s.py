"""The launch layouts of K5s (the fill's float64 tile sum, ``ops/stitch.py``
``tile_sum``, ``csrc/margin_stitch.cu`` ``tile_sum<LOADS>``) and K2v (3D
normalize → reflect pad → tiles, ``predict/normalize.py``
``normalize_tile_3d``, K2's kernel ``normalize_tile<T, O, RUN, true>`` in
``csrc/normalize_tile.cu``) on the CPU, as numpy models of what the kernels do:

- K5s: ``_k5s_geometry`` hands each of the n values to exactly one thread (the
  unaligned head, the 16-byte vectors, the ragged tail) at every float16
  offset, for n below 8, n off a multiple of 8 and more threads than vectors,
  and never more than 4096 values to a thread; the model of the kernel's
  arithmetic (v·2^24 split exactly into a multiple of 2^20 and a remainder,
  float32 sums of a vector, the thread's float64 sum, the warp butterfly, the
  warps and then the blocks in a fixed order) gives the exact sum, equal to
  ``tile_sum_plain``, and NaN, +inf or -inf where the plain sum does;
- K2v: K2's geometry over tz·tx rows of ty writes each output voxel exactly
  once (``Predict3D``'s and ``PredictMultiOutput3D``'s tiles), each from the
  source voxel that ``normalize_tile_3d_plain`` gathers (an exact grid, the
  0/230/256 grid, a grid that reflects on every axis, batch padding, every
  input type and out type); and the shifted 16-byte loads of an unaligned
  run (``load_run_shifted``) read only chunks that hold a byte of the run and
  put each value in place.

``test_torch_gpu.py`` holds the kernels themselves against the plain versions
on the card; ``test_torch_3d.py`` holds K2v's plain version against JAX.
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

from bio_image_unet_tpu_torch.ops import histogram as thist
from bio_image_unet_tpu_torch.ops import stitch as tstitch
from bio_image_unet_tpu_torch.predict import normalize as tnorm
from bio_image_unet_tpu_torch.predict.tiling import TilePlan3D, grid_starts, overlap_starts

F32 = np.float32
THREADS = tstitch._K5S_THREADS
NAN, POS_INF, NEG_INF = 1, 2, 4  # csrc/margin_stitch.cu K5S_NAN, K5S_POS_INF, K5S_NEG_INF


# --- K5s ----------------------------------------------------------------------

def _k5s_owners(n: int, address: int):
    """How often each of the n values is summed, and by which thread: vector
    k by thread k % stride, value g of the head and of the tail by thread g."""
    head, n_vec, tail, blocks = tstitch._k5s_geometry(n, address)
    owner = np.full(n, -1, np.int64)
    k = np.arange(n_vec)
    body = head + 8 * k[:, None] + np.arange(8)[None]
    owner[body] = (k % (blocks * THREADS))[:, None]
    seen = np.zeros(n, np.int64)
    np.add.at(seen, body.ravel(), 1)
    for first, count in ((0, head), (head + 8 * n_vec, tail)):
        owner[first + np.arange(count)] = np.arange(count)
        seen[first + np.arange(count)] += 1
    return seen, owner, (head, n_vec, tail, blocks)


def _special(bits: np.ndarray) -> np.ndarray:
    """``special_of``: the flag of each float16 pattern with exponent 31."""
    inf_or_nan = (bits & 0x7C00) == 0x7C00
    return np.where(~inf_or_nan, 0,
                    np.where(bits & 0x3FF, NAN, np.where(bits & 0x8000, NEG_INF, POS_INF)))


def _split(v: np.ndarray):
    """``split_add``'s h and l of float32 values (the kernel's fused
    multiply-add rounds v·2^24 + C once; v·2^24 is exact, so numpy's product
    and sum round the same)."""
    c = F32(1.5 * 2.0 ** 43)
    x = v * F32(2.0 ** 24)
    h = (x + c) - c
    with np.errstate(invalid="ignore"):  # inf - inf: the kernel's NaN too
        return h, x - h


def _block_total(s: np.ndarray, flags: np.ndarray):
    """``block_total`` over (blocks, 256) threads: a butterfly a warp, then
    the warps in order."""
    s = s.reshape(s.shape[0], THREADS // 32, 32)
    flags = flags.reshape(s.shape)
    lane = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        s = s + s[..., lane ^ o]
    flags = np.bitwise_or.reduce(flags, axis=2)
    total = s[:, 0, 0].copy()
    for w in range(1, THREADS // 32):
        total = total + s[:, w, 0]
    return total, np.bitwise_or.reduce(flags, axis=1)


def _k5s_emulated(values: np.ndarray, address: int) -> float:
    """The kernel's sum of float16 ``values`` lying at byte ``address``."""
    n = values.size
    head, n_vec, tail, blocks = tstitch._k5s_geometry(n, address)
    stride = blocks * THREADS
    bits = values.view(np.uint16).astype(np.int64)
    s = np.zeros(stride, np.float64)
    flags = np.zeros(stride, np.int64)
    vec = values[head: head + 8 * n_vec].astype(F32).reshape(n_vec, 8)
    h, l = _split(vec)
    hs, ls = np.zeros(n_vec, F32), np.zeros(n_vec, F32)
    for i in range(8):
        ls, hs = ls + l[:, i], hs + h[:, i]
    with np.errstate(invalid="ignore"):
        finite = np.abs(hs + ls) <= F32(2.0 ** 64)
    vflags = np.bitwise_or.reduce(_special(bits[head: head + 8 * n_vec].reshape(n_vec, 8)), axis=1)
    for j in range(-(-n_vec // stride)):  # each thread's vectors in order
        k = np.arange(j * stride, min(n_vec, (j + 1) * stride))
        t = k % stride
        s[t] = np.where(finite[k], s[t] + hs[k].astype(np.float64), s[t])
        s[t] = np.where(finite[k], s[t] + ls[k].astype(np.float64), s[t])
        flags[t] |= np.where(finite[k], 0, vflags[k])
    for first, count in ((0, head), (head + 8 * n_vec, tail)):
        g = np.arange(count)
        sp = _special(bits[first + g])
        hv, lv = _split(values[first + g].astype(F32))
        ok = sp == 0
        s[g] = np.where(ok, s[g] + (F32(0) + hv).astype(np.float64), s[g])
        s[g] = np.where(ok, s[g] + (F32(0) + lv).astype(np.float64), s[g])
        flags[g] |= sp
    partials, pflags = _block_total(s.reshape(blocks, THREADS), flags.reshape(blocks, THREADS))
    # the last block: thread t adds partials t, t + 256, ... in order
    s = np.zeros(THREADS, np.float64)
    f = np.zeros(THREADS, np.int64)
    for b in range(blocks):
        s[b % THREADS] += partials[b]
        f[b % THREADS] |= pflags[b]
    total, fl = _block_total(s[None], f[None])
    fl = int(fl[0])
    if fl & NAN or (fl & POS_INF and fl & NEG_INF):
        return float("nan")
    if fl:
        return float("inf") if fl & POS_INF else float("-inf")
    return float(total[0] * 2.0 ** -24)


def _plain_sum(values: np.ndarray) -> float:
    return tstitch.tile_sum_plain(torch.from_numpy(values).view(-1, 1, 1, 1), values.size).item()


def _values(rng, n: int) -> np.ndarray:
    """float16 values of mixed magnitudes: most of a unit normal times 2, a
    few up to ±1000, a few subnormal, a few zeros (sums far below 2^29, so
    every float64 partial sum is exact)."""
    v = rng.standard_normal(n) * 2
    pick = rng.random(n)
    v = np.where(pick < 0.01, rng.uniform(-1000, 1000, n), v)
    v = np.where((pick >= 0.01) & (pick < 0.02), rng.integers(-1023, 1024, n) * 2.0 ** -24, v)
    v = np.where((pick >= 0.02) & (pick < 0.03), 0.0, v)
    return v.astype(np.float16)


K5S_SIZES = [1, 3, 5, 7, 8, 9, 15, 17, 100, 1003, 2 * 8 * 4 * 132 * 256 + 13]


@pytest.mark.parametrize("n", K5S_SIZES)
def test_k5s_geometry_sums_each_value_once(n):
    """Every float16 offset 0–7 of a 16-byte line: each value has one
    owner; the head and the tail are under 8 values and go to the first
    threads; more threads than vectors where n is small; at most 511
    vectors (4090 values) a thread."""
    for offset in range(8):
        address = 4096 + 2 * offset
        seen, owner, (head, n_vec, tail, blocks) = _k5s_owners(n, address)
        assert np.all(seen == 1) and np.all(owner >= 0)
        assert 0 <= head < 8 and 0 <= tail < 8 and head + 8 * n_vec + tail == n
        assert n_vec == 0 or (address + 2 * head) % 16 == 0
        assert n > 10 ** 5 or blocks * THREADS > n_vec  # idle threads where n is small
        assert -(-n_vec // (blocks * THREADS)) <= 511
        assert np.bincount(owner).max() <= 8 * 511 + 2


def test_k5s_geometry_keeps_a_thread_under_4096_values():
    for n in (10 ** 6, 10 ** 9, 3 * 2 ** 31 + 5, 2 ** 40):
        head, n_vec, tail, blocks = tstitch._k5s_geometry(n, 6)
        per_thread = -(-n_vec // (blocks * THREADS))
        assert blocks >= 4 * 132 and per_thread <= 511 and 8 * per_thread + 2 < 4096


@pytest.mark.parametrize("n", K5S_SIZES)
def test_k5s_model_sum_is_exact_and_equals_plain(rng, n):
    values = _values(rng, n)
    # each value times 2^24 is an integer below 2^40: their int64 sum is exact
    exact = Fraction(int((values.astype(np.float64) * 2.0 ** 24).astype(np.int64).sum()), 2 ** 24)
    for offset in (0, 1, 3, 7):
        got = _k5s_emulated(values, 4096 + 2 * offset)
        assert Fraction(got) == exact
        assert got == _plain_sum(values)


@pytest.mark.parametrize("specials", [(np.inf,), (-np.inf,), (np.inf, -np.inf), (np.nan,),
                                      (np.inf, np.nan), (-np.inf, -np.inf)])
def test_k5s_model_non_finite_values_give_the_plain_result(rng, specials):
    """NaN and ±inf in the head, a vector or the tail: the flags give what
    the plain float64 sum gives."""
    n = 8 * 4 * 132 * 256 + 11
    for where in ((1,), (n // 2,), (n - 2,), (2, n - 1)):
        values = _values(rng, n)
        for i, pos in enumerate(where):
            values[pos] = specials[i % len(specials)]
        for j, sp in enumerate(specials[len(where):]):
            values[n // 3 + j] = sp
        got, want = _k5s_emulated(values, 4096 + 6), _plain_sum(values)
        assert (np.isnan(got) and np.isnan(want)) or got == want, (where, got, want)


def test_k5s_wrapper_takes_the_plain_version_on_the_cpu(rng):
    values = _values(rng, 4 * 3 * 16 * 16).reshape(4, 3, 16, 16)
    before = tstitch.tile_sum.launches
    got = tstitch.tile_sum(torch.from_numpy(values), 3)
    assert tstitch.tile_sum.launches == before
    assert got.dtype == torch.float64 and got.item() == _plain_sum(values[:3].ravel())


# --- K2v ----------------------------------------------------------------------

def _k2v_runs(tile, n_total: int):
    """(tile, first element, length) of every thread's run of the K2v launch,
    as the kernel walks them: K2's geometry of tz·tx rows of ty."""
    tz, tx, ty = tile
    run, bpt, iters = tnorm._k2_geometry(tz * tx, ty, n_total)
    b = np.arange(n_total * bpt)
    t, strip = b // bpt, b % bpt
    e = ((strip[:, None, None] * iters + np.arange(iters)[None, :, None]) * tnorm._K2_THREADS
         + np.arange(tnorm._K2_THREADS)[None, None, :]) * run
    keep = e < tz * tx * ty
    return np.broadcast_to(t[:, None, None], e.shape)[keep], e[keep], run


@pytest.mark.parametrize("tile,n_total", [
    ((32, 128, 128), 32),   # Predict3D: config 5's volume, one call
    ((64, 256, 256), 18),   # PredictMultiOutput3D: two volumes of 9 tiles
    ((8, 32, 32), 5), ((5, 15, 15), 7), ((3, 17, 48), 2)])
def test_k2v_geometry_writes_every_tile_voxel_once(tile, n_total):
    t, e, run = _k2v_runs(tile, n_total)
    tz, tx, ty = tile
    assert run == (16 if ty % 16 == 0 else 1)
    # runs start on multiples of run, never leave their tile row, and cover
    # each tile once
    assert np.all(e % run == 0) and np.all(e % ty + run <= ty)
    key = np.sort(t * (tz * tx * ty) + e)
    np.testing.assert_array_equal(key, np.arange(0, n_total * tz * tx * ty, run))


def _reflect(p, n):
    return np.where(p >= n, 2 * (n - 1) - p, p)


def _k2v_emulated(vols, bounds, plan, n_total, invert, out_dtype):
    """The kernel's map from runs to source voxels on the CPU: tile t shows
    tile min(t, n_real - 1); volume v, grid cell (iz, i, j); tile row r =
    rz·tx + rx from row reflect(xs[i] + rx) of plane reflect(zs[iz] + rz),
    columns reflect(ys[j] + c); the values through the plain steps."""
    scale = 255.0 if out_dtype == torch.uint8 else 1.0
    norm = tnorm._normalize_clip(vols, bounds, invert, scale).to(out_dtype)
    norm = norm.view(torch.int16) if out_dtype == torch.bfloat16 else norm
    norm = norm.numpy()
    tz, tx, ty = plan.tile
    n_real = vols.shape[0] * plan.per_volume
    out = np.full((n_total, tz * tx * ty), 77, norm.dtype)
    t, e, run = _k2v_runs(plan.tile, n_total)
    ts = np.minimum(t, n_real - 1)
    v, ijk = ts // plan.per_volume, ts % plan.per_volume
    iz, ij = ijk // (plan.nx * plan.ny), ijk % (plan.nx * plan.ny)
    i, j = ij // plan.ny, ij % plan.ny
    r, c0 = e // ty, e % ty
    rz = r // tx
    pz = _reflect(plan.zs[iz] + rz, plan.d)
    px = _reflect(plan.xs[i] + r - rz * tx, plan.h)
    pc = _reflect(plan.ys[j][:, None] + c0[:, None] + np.arange(run)[None], plan.w)
    out[t[:, None], e[:, None] + np.arange(run)[None]] = norm[v[:, None], pz[:, None],
                                                              px[:, None], pc]
    return out.reshape((n_total,) + plan.tile)


K2V_CASES = [
    # name, dtype, (V, d, h, w), tile, starts ("grid", add) or ("overlap", f),
    # invert, global bounds, out dtype, batch padding
    ("predict3d-grid-u8", np.uint8, (1, 8, 256, 256), (4, 128, 128), ("grid", 0), False, False,
     torch.uint8, 0),
    ("heads-grid-0-230-256-u8-bf16", np.uint8, (2, 4, 512, 512), (4, 256, 256),
     ("overlap", 0.1), False, False, torch.bfloat16, 0),
    ("heads-grid-u16-f32-invert-global", np.uint16, (1, 3, 512, 512), (3, 256, 256),
     ("overlap", 0.1), True, True, torch.float32, 2),
    ("heads-grid-f32-bf16", np.float32, (1, 2, 512, 512), (2, 256, 256), ("overlap", 0.1),
     False, False, torch.bfloat16, 1),
    ("reflect-every-axis-u8-invert", np.uint8, (2, 6, 20, 24), (8, 32, 32), ("grid", 0), True,
     False, torch.uint8, 3),
    ("reflect-every-axis-f32-bf16", np.float32, (1, 5, 17, 30), (8, 32, 32), ("grid", 0), False,
     True, torch.bfloat16, 0),
    ("overlap-u16-u8", np.uint16, (1, 12, 40, 36), (8, 32, 32), ("grid", 1), False, False,
     torch.uint8, 1),
    ("odd-tile-u16-f32", np.uint16, (2, 9, 21, 23), (5, 15, 15), ("grid", 0), False, True,
     torch.float32, 2),
]


def _volumes(rng, dtype, shape):
    if dtype == np.float32:
        return (rng.standard_normal(shape) * 40 + 5).astype(np.float32)
    return rng.integers(0, np.iinfo(dtype).max, shape, endpoint=True).astype(dtype)


def _plan(shape, tile, starts):
    kind, arg = starts
    extents = shape[1:]
    if kind == "overlap":
        grid = [overlap_starts(e, t, arg) for e, t in zip(extents, tile)]
    else:
        grid = [grid_starts(max(e, t), t, arg) for e, t in zip(extents, tile)]
    return TilePlan3D(*extents, tile, *grid, "cpu")


@pytest.mark.parametrize("case", K2V_CASES, ids=[c[0] for c in K2V_CASES])
def test_k2v_run_map_rebuilds_plain_tiles(rng, case):
    _, dtype, shape, tile, starts, invert, fixed, out_dtype, extra = case
    x = torch.from_numpy(_volumes(rng, dtype, shape))
    bounds = thist.clip_bounds(x, 0.5, 99.5)
    if fixed:
        bounds = torch.stack([bounds[0, :1], bounds[1, :1], bounds[0, :1], bounds[1, :1]])
    plan = _plan(shape, tile, starts)
    if starts[0] == "overlap":
        assert list(plan.ys) == [0, 230, 256]
    n_total = shape[0] * plan.per_volume + extra
    ref = tnorm.normalize_tile_3d_plain(x, bounds, plan, n_total, invert, out_dtype)
    ref = (ref.view(torch.int16) if out_dtype == torch.bfloat16 else ref).numpy()
    np.testing.assert_array_equal(_k2v_emulated(x, bounds, plan, n_total, invert, out_dtype),
                                  ref)


def _load_run_shifted(words: np.ndarray, addr: np.ndarray, itemsize: int, run: int = 16):
    """``load_run_shifted<T, RUN>`` on a buffer of uint32 ``words``: the
    aligned 16-byte chunks at and after the run's line (only those that hold
    a byte of it), the words shifted into place by funnel shifts."""
    nw = run * itemsize // 4
    nc = nw // 4 + 1
    base, o = addr & ~15, addr & 15
    last = (o + nw * 4 - 1) >> 4
    w = np.zeros((addr.size, 4 * nc), np.uint32)
    for c in range(nc):
        take = c <= last
        assert np.all(base[take] + 16 * c < addr[take] + run * itemsize)
        w[take, 4 * c: 4 * c + 4] = words[(base[take] + 16 * c)[:, None] // 4 + np.arange(4)]
    q, sh = (o >> 2), ((o & 3) * 8).astype(np.uint32)
    rows = np.arange(addr.size)[:, None]
    s = w[rows, q[:, None] + np.arange(nw + 1)[None]]
    lo, hi = s[:, :-1], s[:, 1:]
    with np.errstate(over="ignore"):
        shifted = np.where(sh[:, None] == 0, lo,
                           (lo >> sh[:, None]) | (hi << ((32 - sh[:, None]) % 32)))
    return shifted.astype(np.uint32)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
def test_k2v_shifted_loads_put_unaligned_runs_in_place(rng, dtype):
    """``PredictMultiOutput3D``'s in-plane start 230 (6 mod 16): every run
    inside the volume at an address off 16 bytes, read as the kernel reads
    it, equals the volume's values."""
    shape, tile = (1, 2, 512, 512), (2, 256, 256)
    vol = _volumes(rng, dtype, shape)
    plan = _plan(shape, tile, ("overlap", 0.1))
    t, e, run = _k2v_runs(tile, plan.per_volume)
    ijk = t % plan.per_volume
    iz, ij = ijk // (plan.nx * plan.ny), ijk % (plan.nx * plan.ny)
    i, j = ij // plan.ny, ij % plan.ny
    r, c0 = e // tile[2], e % tile[2]
    rz = r // tile[1]
    pz, px = plan.zs[iz] + rz, plan.xs[i] + r - rz * tile[1]
    pc0 = plan.ys[j] + c0
    item = vol.itemsize
    addr = (((pz * shape[2] + px) * shape[3]) + pc0) * item
    inside = (pc0 + run <= shape[3]) & (addr % 16 != 0)
    assert inside.sum() > 0 and set(np.unique(plan.ys[j][inside])) == {230}
    words = np.frombuffer(vol.tobytes(), np.uint32)
    got = _load_run_shifted(words, addr[inside], item, run)
    want = np.stack([np.frombuffer(vol.tobytes()[a: a + run * item], np.uint32)
                     for a in addr[inside][:2000]])
    np.testing.assert_array_equal(got[:2000], want)
    flat = vol.reshape(-1)
    got_values = got.view(vol.dtype).reshape(-1, run)
    np.testing.assert_array_equal(got_values, flat[(addr[inside] // item)[:, None]
                                                   + np.arange(run)[None]])
