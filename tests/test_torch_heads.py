"""The port's multi-head 2D prediction (``MultiOutputUnet``, both UNet++
depths), held against the JAX package on the same reference ``.pt`` and the
same inputs: models, BN fold, weight mapping, the UNet++ upsampling, the
safe-margin tiling, K2h (float tiles), K5/K5s (safe-margin stitch and its
fill) and ``PredictMultiOutput`` on both paths.

Tolerances: models float32 atol 2e-4; ``PredictMultiOutput`` port vs JAX on
the same path ``|port − JAX| ≤ 1e-3 + 1e-3·|JAX|`` on every head and pixel
(one float16 ulp at 1.0 is 9.8e-4); port fused vs port host atol 2e-3, the
contract the JAX package holds between its own two paths.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bio_image_unet_tpu import checkpoint as jcheckpoint
from bio_image_unet_tpu.interop.torch_export import export_torch_checkpoint
from bio_image_unet_tpu.models import (MultiOutputNestedUNet as JNested,
                                       MultiOutputNestedUNet_3Levels as JNested3,
                                       MultiOutputUnet as JMultiOutputUnet)
from bio_image_unet_tpu.ops import stitch as jstitch
from bio_image_unet_tpu.ops.blocks import VGGBlock as JVGGBlock
from bio_image_unet_tpu.ops.functional import upsample_linear as jupsample_linear
from bio_image_unet_tpu.predict import PredictMultiOutput as JPredictMultiOutput
from bio_image_unet_tpu.predict import tiling as jtiling
from bio_image_unet_tpu.predict.predictor import _extract_tiles, _normalize_clip, _tile_plan
from bio_image_unet_tpu_torch import checkpoint
from bio_image_unet_tpu_torch.data import tiff
from bio_image_unet_tpu_torch.interop import state_dict_from_jax
from bio_image_unet_tpu_torch.models import get_model
from bio_image_unet_tpu_torch.ops.blocks import VGGBlock, init_weights_
from bio_image_unet_tpu_torch.ops.functional import upsample_linear
from bio_image_unet_tpu_torch.ops.stitch import (_fma_f32, blend_stitch_3d_plain, margin_stitch,
                                                  margin_stitch_plain, tile_sum)
from bio_image_unet_tpu_torch.predict import PredictMultiOutput
from bio_image_unet_tpu_torch.predict import tiling
from bio_image_unet_tpu_torch.predict.fastpath import folded_forward
from bio_image_unet_tpu_torch.predict.normalize import normalize_tile_float
from bio_image_unet_tpu_torch.predict.predictor import _Engine

REPO = Path(__file__).resolve().parent.parent
HEADS = {"mask": {"channels": 1, "activation": "sigmoid"},
         "orientation": {"channels": 2, "activation": None}}
N_FILTER = 4

# name: (JAX class, registry name, extra hyperparams)
MODELS = {
    "mo_unet": (JMultiOutputUnet, "MultiOutputUnet", {}),
    "nested4": (JNested, "MultiOutputNestedUNet", {}),
    "nested3_deep_dilated": (JNested3, "MultiOutputNestedUNet_3Levels",
                             {"deep_supervision": True, "dilation": (1, 2, 1, 1)}),
}


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """``{name: (path, JAX model, JAX variables)}``: one reference-schema
    ``.pt`` per model, read by both packages.  Seeded random weights and
    BatchNorm statistics (so the BN fold has something to fold) are drawn in
    the port's model, read by the JAX package's ``.pt`` reader and written
    back by its ``export_torch_checkpoint``: the file both packages load."""
    root = tmp_path_factory.mktemp("heads")
    out = {}
    for seed, (name, (cls, reg, extra)) in enumerate(MODELS.items()):
        hyper = {"model_name": reg, "n_filter": N_FILTER, "in_channels": 1,
                 "output_heads": HEADS, **extra}
        net = init_weights_(get_model(reg, **hyper), torch.Generator().manual_seed(seed),
                            random_bn_stats=True)
        drawn = str(root / f"{name}_drawn.pt")
        torch.save({"state_dict": net.state_dict(), **hyper}, drawn)
        variables = jcheckpoint.load(drawn)["variables"]
        path = str(root / f"{name}.pt")
        export_torch_checkpoint(path, variables, hyper)
        out[name] = (path, cls(n_filter=N_FILTER, output_heads=HEADS, **extra), variables)
    return out


def _port_model(path):
    state = checkpoint.load(path)
    net = get_model(state["hyperparams"]["model_name"], **state["hyperparams"])
    net.load_state_dict(state["state_dict"], strict=True)
    return net.eval()


def _nchw(x):
    return torch.from_numpy(np.moveaxis(x, -1, 1).copy())


# --- models, fold, weights ----------------------------------------------------

@pytest.mark.parametrize("name", list(MODELS))
def test_model_eval_forward_matches_jax(ckpts, rng, name):
    path, model, variables = ckpts[name]
    x = rng.random((2, 32, 32, 1)).astype(np.float32)
    apply = jax.jit(lambda v, a: model.apply(v, a, train=False))
    ref = apply(variables, jnp.asarray(x))
    net = _port_model(path)
    with torch.no_grad():
        ours = net(_nchw(x))
        folded = folded_forward(net)(_nchw(x))
    # eval: a deep-supervision model emits only each head, from the deepest level
    assert set(ours) == set(ref) == set(HEADS) == set(folded)
    for head in HEADS:
        want = np.moveaxis(np.asarray(ref[head]), -1, 1)
        assert ours[head].dtype == torch.float32
        np.testing.assert_allclose(ours[head].numpy(), want, atol=2e-4, rtol=0, err_msg=head)
        # the folded forward against the unfolded one
        np.testing.assert_allclose(folded[head].numpy(), ours[head].numpy(), atol=1e-4,
                                   rtol=0, err_msg=head)


def test_deep_supervision_train_outputs_every_level(ckpts):
    net = _port_model(ckpts["nested3_deep_dilated"][0]).train()
    assert net.dilations == (1, 2, 1, 1)
    with torch.no_grad():
        out = net(torch.rand((2, 1, 32, 32)))
    assert set(out) == {f"{h}{s}" for h in HEADS for s in ("", "_1", "_2", "_3")}
    assert torch.equal(out["mask"], out["mask_3"])


@pytest.mark.parametrize("dilation", [1, 2])
def test_vgg_block_matches_jax(rng, dilation):
    block = JVGGBlock(6, 5, dilation=dilation)
    params, stats = {}, {}
    for k, (ci, co) in enumerate(((3, 6), (6, 5)), start=1):
        params[f"conv{k}"] = {"kernel": rng.standard_normal((3, 3, ci, co)).astype(np.float32) * 0.3,
                              "bias": rng.standard_normal(co).astype(np.float32) * 0.1}
        params[f"bn{k}"] = {"scale": rng.uniform(0.8, 1.2, co).astype(np.float32),
                            "bias": rng.uniform(-0.1, 0.1, co).astype(np.float32)}
        stats[f"bn{k}"] = {"mean": rng.standard_normal(co).astype(np.float32) * 0.1,
                           "var": rng.uniform(0.5, 1.5, co).astype(np.float32)}
    variables = {"params": params, "batch_stats": stats}
    x = rng.random((2, 12, 12, 3)).astype(np.float32)
    ref = np.asarray(block.apply(variables, jnp.asarray(x), train=False))
    sd = {k[len("b."):]: v for k, v in state_dict_from_jax(
        {"params": {"grid_b": params}, "batch_stats": {"grid_b": stats}}).items()}
    ours = VGGBlock(3, 6, 5, dilation)
    ours.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = ours.eval()(_nchw(x)).numpy()
    np.testing.assert_allclose(out, np.moveaxis(ref, -1, 1), atol=2e-4, rtol=0)


@pytest.mark.parametrize("name", list(MODELS))
def test_state_dict_from_jax_equals_exported_pt(ckpts, name):
    path, _, variables = ckpts[name]
    ours = state_dict_from_jax(variables)
    loaded = checkpoint.load(path)["state_dict"]
    assert set(ours) == set(loaded)
    for k, v in loaded.items():
        assert ours[k].dtype == v.dtype and torch.equal(ours[k], v), k
    net = _port_model(path)
    missing, unexpected = net.load_state_dict(ours, strict=True)
    assert not missing and not unexpected


def test_state_dict_from_jax_still_rejects_unknown_blocks():
    with pytest.raises(ValueError, match="unmapped"):
        state_dict_from_jax({"params": {"grid_conv0_0": {"conv1": {}}}})
    with pytest.raises(ValueError, match="unmapped"):
        state_dict_from_jax({"params": {"output_layers_mask": {"kernel": 0}}})


def test_bf16_folded_nested_forward_is_close(ckpts, rng):
    net = _port_model(ckpts["nested4"][0])
    x = _nchw(rng.random((2, 32, 32, 1)).astype(np.float32))
    with torch.no_grad():
        f32 = folded_forward(net)(x)
        bf16 = folded_forward(net, torch.bfloat16)(x.to(torch.bfloat16))
    for head in HEADS:
        assert bf16[head].dtype == torch.float32
        assert (bf16[head] - f32[head]).abs().max().item() < 0.1, head


@pytest.mark.parametrize("shape", [(2, 5, 7, 3), (1, 1, 4, 2)])
def test_upsample_linear_matches_jax(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    ref = np.asarray(jupsample_linear(jnp.asarray(x), 2, align_corners=True))
    ours = upsample_linear(_nchw(x), 2, align_corners=True).numpy()
    np.testing.assert_allclose(ours, np.moveaxis(ref, -1, 1), atol=1e-6, rtol=0)


# --- tiling -------------------------------------------------------------------

GRIDS = [((2, 3), (16, 24), 4), ((1, 2), (8, 8), 3), ((3, 1), (8, 16), 10), ((2, 2), (8, 8), 0)]


@pytest.mark.parametrize("grid,tile,margin", GRIDS)
def test_margin_weights_and_factors_equal_jax(grid, tile, margin):
    np.testing.assert_array_equal(tiling._margin_weights(grid, tile, margin),
                                  jtiling._margin_weights(grid, tile, margin))
    for a, b in zip(tiling._margin_factors(grid, tile, margin),
                    jtiling._margin_factors(grid, tile, margin)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape,tile,add,margin", [((64, 64), 32, 0, 4), ((48, 40), 32, 1, 3),
                                                   ((40, 40), 32, 0, 0), ((24, 40), 32, 0, 5)])
def test_stitch_margin_and_uncovered_mask_equal_jax(rng, shape, tile, add, margin):
    out = (max(shape[0], tile), max(shape[1], tile))
    starts = (jtiling.grid_starts(out[0], tile, add), jtiling.grid_starts(out[1], tile, add))
    n = len(starts[0]) * len(starts[1])
    patches = rng.random((n, tile, tile, 2)).astype(np.float16)
    ours = tiling.stitch_margin(patches, starts, out, margin)
    ref = jtiling.stitch_margin(patches, starts, out, margin)
    np.testing.assert_array_equal(ours.view(np.uint32), ref.view(np.uint32))
    w = jtiling._margin_weights([len(s) for s in starts], (tile, tile), margin)
    res, wsum = jtiling._accumulate(patches.astype(np.float32), w, starts, out + (2,))
    r2, w2 = tiling._accumulate(patches.astype(np.float32), w, starts, out + (2,))
    np.testing.assert_array_equal(res, r2)
    np.testing.assert_array_equal(wsum, w2)
    # the static uncovered mask is exactly the zero-weight set of the grid
    factors = tiling._margin_factors([len(s) for s in starts], (tile, tile), margin)
    mask = tiling.uncovered_mask(starts, factors, shape)
    np.testing.assert_array_equal(mask, wsum[: shape[0], : shape[1], 0] == 0)
    if margin == 0:  # the reference's slice(-0, None) quirk: whole tiles weigh 0
        assert mask.any()


# --- K2h ----------------------------------------------------------------------

def _jax_bounds(frames, qs):
    from bio_image_unet_tpu.ops import histogram as jhist

    if frames.dtype == np.float32:
        vals = jhist.float_clip_bounds(frames, *qs)
    else:
        vals = jhist.int_clip_bounds(frames, *qs, n_bits=8 * frames.dtype.itemsize)
    return np.stack([np.asarray(v) for v in vals]).astype(np.float32)


def _frames(rng, dtype, shape):
    if dtype == np.float32:
        return (rng.standard_normal(shape) * 40 + 5).astype(np.float32)
    return rng.integers(0, np.iinfo(dtype).max, shape, endpoint=True).astype(dtype)


K2H_CASES = [
    # name, dtype, (F, h, w), tile, add_tile, fixed bounds, extra batch pad
    ("exact-u8", np.uint8, (2, 64, 64), 32, 0, False, 0),
    ("overlap-u16", np.uint16, (2, 48, 40), 32, 1, False, 3),
    ("reflect-pad-f32", np.float32, (2, 24, 40), 32, 0, False, 1),
    ("fixed-bounds-u16", np.uint16, (3, 64, 48), 32, 0, True, 0),
]


@pytest.mark.parametrize("case", K2H_CASES, ids=[c[0] for c in K2H_CASES])
def test_normalize_tile_float_equals_jax(rng, case):
    """K2h's plain version against ``predictor.py:1101-1117``: normalize to
    [0, 1] (``scale=1.0``), reflect pad after the normalization, tile, pad
    the batch with the last tile; float32 exact, bfloat16 the same cast."""
    name, dtype, (n_frames, h, w), t, add, fixed, extra = case
    frames = _frames(rng, dtype, (n_frames, h, w))
    qs = (0.5, 99.5)
    if fixed:
        b = _jax_bounds(frames[:1], qs)[:, 0]
        bounds = np.array([b[0], b[1], b[0], b[1]], np.float32)[:, None]
    else:
        bounds = _jax_bounds(frames, qs)
    xs = jtiling.grid_starts(max(h, t), t, add)
    ys = jtiling.grid_starts(max(w, t), t, add)
    nx, ny = len(xs), len(ys)
    n = n_frames * nx * ny
    n_pad = n + extra
    exact, row_idx, col_idx = _tile_plan(h, w, t, t, tuple(xs), tuple(ys))

    @jax.jit
    def run(frames, bounds):
        if bounds.shape[1] == 1:
            lo, hi, fmin, fmax = (bounds[i, 0] for i in range(4))
        else:
            lo, hi, fmin, fmax = (bounds[i][:, None, None] for i in range(4))
        f = _normalize_clip(frames.astype(jnp.float32), lo, hi, fmin, fmax, invert=False,
                            scale=1.0)
        if t > h:
            f = jnp.pad(f, ((0, 0), (0, t - h), (0, 0)), mode="reflect")
        if t > w:
            f = jnp.pad(f, ((0, 0), (0, 0), (0, t - w)), mode="reflect")
        p = _extract_tiles(f, nx, ny, t, t, exact, row_idx, col_idx)
        if n_pad != n:
            p = jnp.concatenate([p, jnp.broadcast_to(p[-1:], (n_pad - n,) + p.shape[1:])])
        return p[..., 0]

    ref = np.asarray(run(jnp.asarray(frames), jnp.asarray(bounds)))
    plan = tiling.TilePlan(h, w, t, t, xs, ys, "cpu")
    before = normalize_tile_float.launches
    for dt in (torch.float32, torch.bfloat16):
        ours = normalize_tile_float(torch.from_numpy(frames), torch.from_numpy(bounds), plan,
                                    n_pad, dt)
        assert ours.dtype == dt and ours.shape == (n_pad, t, t)
        want = ref if dt == torch.float32 else np.asarray(
            jnp.asarray(ref).astype(jnp.bfloat16).astype(jnp.float32))
        np.testing.assert_array_equal(ours.float().numpy().view(np.uint32),
                                      want.view(np.uint32), err_msg=f"{name} {dt}")
    assert normalize_tile_float.launches == before  # the CPU takes the plain version


# --- K5 / K5s -----------------------------------------------------------------

STITCH_CASES = [
    # name, (F, h, w), tile, add_tile, margin, channels, chunks
    ("exact", (3, 64, 64), 32, 0, 4, 1, 1),
    ("overlap-2ch", (2, 48, 40), 32, 1, 3, 2, 1),
    ("reflect-pad", (2, 24, 40), 32, 0, 5, 2, 1),
    ("margin0-two-chunks", (5, 40, 40), 32, 0, 0, 1, 2),
]


@pytest.mark.parametrize("case", STITCH_CASES, ids=[c[0] for c in STITCH_CASES])
def test_margin_stitch_and_fill_bit_equal_to_jax(rng, case):
    """K5's plain version and the K5s fill, run chunk by chunk as the port's
    ``PredictMultiOutput`` runs them, against JAX's factored stitch with the
    fused epilogue (float16 out) and its dense weighted stitch of the host
    path (float32 out), on the same float16 tiles.  Every covered pixel is
    bit-equal.  The fill: JAX's is ``jnp.mean`` in float32, a reduction in
    XLA's order; the port's is the float64 sum over the chunks divided by the
    count, the exactly rounded mean.  Rounded to float16 (the fused path) the
    two are equal; in float32 (the host path) they differ by the float32
    reduction's error, bounded by 1e-6 of the tiles' mean magnitude."""
    name, (n_frames, h, w), t, add, margin, c, n_chunks = case
    out = (max(h, t), max(w, t))
    xs, ys = jtiling.grid_starts(out[0], t, add), jtiling.grid_starts(out[1], t, add)
    nx, ny = len(xs), len(ys)
    per = nx * ny
    factors = tiling._margin_factors((nx, ny), (t, t), margin)
    plan = tiling.TilePlan(h, w, t, t, xs, ys, "cpu", factors)
    tiles = (rng.standard_normal((n_frames * per, c, t, t)) * 2).astype(np.float16)

    # JAX: the fused program's epilogue (predictor.py:1130-1145) and the host form
    hp = jnp.asarray(np.moveaxis(tiles, 1, -1)).astype(jnp.float32)
    fill = jnp.mean(hp)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    starts = jnp.asarray(np.stack([gx.ravel(), gy.ravel()], 1).astype(np.int32))
    gi, gj = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    gidx = jnp.asarray(np.stack([gi.ravel(), gj.ravel()], 1).astype(np.int32))
    facs = tuple(jnp.asarray(f) for f in factors)

    def one(frame_patches):
        s, wsum = jstitch._stitch_factored_xla(frame_patches, facs, gidx, starts, out)
        return jnp.where(wsum > 0, s / jnp.maximum(wsum, 1e-12), fill)

    fused_ref = np.asarray(jax.jit(jax.vmap(one))(hp.reshape((n_frames, per) + hp.shape[1:]))
                           .astype(jnp.float16))[:, :h, :w]
    weights = jtiling._margin_weights((nx, ny), (t, t), margin)
    host_ref = np.asarray(jstitch._stitch_weighted_frames(
        jnp.asarray(np.moveaxis(tiles, 1, -1)), jnp.asarray(weights), starts, n_frames, out,
        True))[:, :h, :w]
    exact_mean = np.float32(tiles.astype(np.float64).mean())

    # the port: K5 per chunk, K5s into a float64 total, the fill after the last chunk
    k = -(-n_frames // n_chunks)
    for out_dtype, ref in ((torch.float16, fused_ref), (torch.float32, host_ref)):
        res = np.empty((n_frames, c, h, w), np.float16 if out_dtype == torch.float16
                       else np.float32)
        total = None
        for s in range(0, n_frames, k):
            chunk = torch.from_numpy(tiles[s * per:(s + k) * per])
            frames = chunk.shape[0] // per
            res[s:s + frames] = margin_stitch(chunk, frames, plan, out_dtype).numpy()
            part = tile_sum(chunk, frames * per)
            total = part if total is None else total + part
        _Engine._fill({"h": res}, {"h": total}, plan, n_frames)
        want = np.moveaxis(ref, -1, 1)
        assert res.dtype == want.dtype
        bits = np.uint16 if res.dtype == np.float16 else np.uint32
        covered = np.broadcast_to(~plan.uncovered, res.shape)
        np.testing.assert_array_equal(res[covered].view(bits), want[covered].view(bits),
                                      err_msg=f"{name} {out_dtype}")
        filled = res[~covered]
        if filled.size:
            assert (filled == exact_mean.astype(res.dtype)).all(), name
            if out_dtype == torch.float16:
                np.testing.assert_array_equal(filled.view(bits), want[~covered].view(bits))
            else:
                err = np.abs(filled - want[~covered]).max()
                assert err <= 1e-6 * np.abs(tiles.astype(np.float64)).mean(), (name, err)


def _div_rn(a, b, err: float) -> np.ndarray:
    """``csrc/margin_stitch.cu`` ``div_rn`` on float32 arrays (b > 0), with
    the hardware estimate of 1/b off by the relative error ``err``.  Its
    float64 steps are separate IEEE operations (``-fmad=false``), so numpy
    repeats them bit for bit."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    m, bd = np.abs(a.astype(np.float64)), b.astype(np.float64)
    y = (1.0 / bd * (1.0 + err)).astype(np.float32).astype(np.float64)
    y = y * (2.0 - bd * y)
    q = (m * y).astype(np.float32)
    r = m - bd * q.astype(np.float64)
    with np.errstate(invalid="ignore"):
        up = (q.view(np.uint32) + np.uint32(1)).view(np.float32)
        dn = (q.view(np.uint32) - np.uint32(1)).view(np.float32)
        q = np.where(r > bd * (0.5 * (up.astype(np.float64) - q)), up,
                     np.where(-r > bd * (0.5 * (q.astype(np.float64) - dn)), dn, q))
    return np.copysign(q, a)


def _quotient(acc, wsum, err: float) -> np.ndarray:
    """``quotient``: a power-of-two weight sum divides as a multiply by its
    exact reciprocal, any other through ``div_rn``."""
    acc, wsum = np.asarray(acc, np.float32), np.asarray(wsum, np.float32)
    bits = wsum.view(np.uint32)
    pow2 = (bits & np.uint32(0x7FFFFF)) == 0
    recip = (np.uint32(0x7F000000) - np.where(pow2, bits, np.uint32(0x3F800000))).view(np.float32)
    return np.where(pow2, acc * recip, _div_rn(acc, np.where(pow2, np.float32(1), wsum), err))


@pytest.mark.parametrize("err", [0.0, 2.0 ** -21, -(2.0 ** -21)])
def test_k5_division_rounds_as_ieee_division(rng, err):
    """K5's and K5v's quotient (``div_rn``: one float64 Newton step from a
    hardware estimate off by up to 2^-21, the float nearest the product, then
    an exact residual that moves it to the neighbour across the midpoint)
    equals IEEE float32 division, and so ``__fdiv_rn`` and the plain
    versions' ``acc / wsum``: weight sums of the blend ramps and of binary
    margins, random and edge numerators (quotients at binade edges, 0,
    negatives, float16 extremes)."""
    ramp = np.arange(16, dtype=np.float32) / np.float32(16)
    ramp5 = np.arange(5, dtype=np.float32) / np.float32(5)
    sums = np.concatenate([
        np.float32(1) + ramp, ramp[1:] + ramp[::-1][:-1], ramp5[1:], ramp5[1:] + ramp5[::-1][:-1],
        np.arange(1, 9, dtype=np.float32),
        rng.uniform(0.05, 8.0, 4000).astype(np.float32)]).astype(np.float32)
    b = np.repeat(sums, 64)
    scale = rng.choice([1e-3, 1.0, 300.0, 6e4], b.size)
    a = (rng.standard_normal(b.size) * scale).astype(np.float32)
    # numerators whose quotient lies next to a power of two
    edge = (np.float32(2) ** rng.integers(-10, 10, b.size)).astype(np.float32)
    for k in (-2, -1, 0, 1, 2):
        a_edge = (edge.view(np.int32) + k).view(np.float32) * b
        a = np.concatenate([a, a_edge.astype(np.float32), -a_edge.astype(np.float32)])
    a = np.concatenate([a, np.zeros(16, np.float32), np.float32([2 ** -24, 65504, -65504] * 8)])
    b = np.resize(b, a.size)
    np.testing.assert_array_equal(_div_rn(a, b, err).view(np.uint32), (a / b).view(np.uint32))
    pow2 = np.float32([0.25, 0.5, 1, 2, 4, 8])
    np.testing.assert_array_equal(_quotient(a[:pow2.size * 100], np.resize(pow2, 600), err).view(
        np.uint32), (a[:600] / np.resize(pow2, 600)).view(np.uint32))


def _stitch_rows_emulated(tiles: np.ndarray, n_units: int, plan, vol: bool, err: float):
    """``csrc/margin_stitch.cu`` ``stitch_rows`` on the CPU, float32 out:
    each row in runs of 8 outputs; for every z and row cover, every column
    tile of the run's range, with the outputs it does not cover masked out;
    K5's multiply and add (``vol`` False) or K5v's fused multiply-add; the
    quotient as above."""
    if vol:
        (tz, tx, ty), d = plan.tile, plan.d
        zs, fz, fx, fy = plan.zs, *plan.factors
    else:
        (tz, tx, ty), d = (1, plan.th, plan.tw), 1
        zs, fz, (fx, fy) = np.zeros(1, np.int64), np.ones((1, 1), np.float32), plan.factors
    h, w, xs, ys = plan.h, plan.w, plan.xs, plan.ys
    nz, nx, ny, c = len(zs), len(xs), len(ys), tiles.shape[1]
    z_lo, z_hi = tiling.cover_ranges(zs, tz, d)
    row_lo, row_hi = tiling.cover_ranges(xs, tx, h)
    col_lo, col_hi = tiling.cover_ranges(ys, ty, w)
    t = tiles.astype(np.float32).reshape(n_units, nz, nx, ny, c, tz, tx, ty)
    q0 = np.arange(0, w, 8)
    n = np.minimum(8, w - q0)
    e = np.arange(8)
    jlo, jhi = col_lo[q0], col_hi[q0 + n - 1]
    out = np.empty((n_units, c, d, h, w), np.float32)
    for z in range(d):
        for r in range(h):
            acc = np.zeros((n_units, c, q0.size, 8), np.float32)
            wsum = np.zeros((q0.size, 8), np.float32)
            for k in range(z_lo[z], z_hi[z]):
                tzo = z - zs[k]
                for i in range(row_lo[r], row_hi[r]):
                    txo = r - xs[i]
                    wzx = np.minimum(fz[k, tzo], fx[i, txo]) if vol else fx[i, txo]
                    row = t[:, k, i, :, :, tzo, txo, :]  # (units, ny, c, ty)
                    for s in range(int((jhi - jlo).max(initial=0))):
                        j = np.minimum(jlo + s, ny - 1)
                        o = q0 - ys[j]
                        valid = ((jlo + s < jhi)[:, None] & (e >= np.maximum(0, -o)[:, None])
                                 & (e < np.minimum(n, ty - o)[:, None]))
                        col = np.clip(o[:, None] + e, 0, ty - 1)
                        v = np.moveaxis(row[:, j[:, None], :, col], (0, 1), (2, 3))
                        wt = np.minimum(wzx, fy[j[:, None], col]).astype(np.float32)
                        if vol:
                            step = _fma_f32(torch.from_numpy(np.ascontiguousarray(v)),
                                            torch.from_numpy(np.broadcast_to(wt, v.shape).copy()),
                                            torch.from_numpy(acc)).numpy()
                        else:
                            step = acc + v * wt
                        acc = np.where(valid, step, acc)
                        wsum = np.where(valid, wsum + wt, wsum)
            res = np.where(wsum > 0, _quotient(acc, np.where(wsum > 0, wsum, 1), err), 0)
            out[:, :, z, r] = res.reshape(n_units, c, -1)[..., :w]
    return out if vol else out[:, :, 0]


RUN_LOOP_CASES = [
    # name, 3D, (units, d, h, w), tile, starts (None: grid_starts), margin, channels, err
    ("config4-exact-1024", False, (1, 1, 1024, 1024), 512, None, 20, 1, 0.0),
    ("starts-0-491-1000x1003", False, (1, 1, 1000, 1003), 512, None, 20, 2, 2.0 ** -21),
    ("three-covers-add-tile", False, (1, 1, 1000, 1000), 512, (0, 244, 488), 20, 1, -(2.0 ** -21)),
    ("eight-column-tiles", False, (2, 1, 40, 200), 32, "add1", 4, 1, 2.0 ** -21),
    ("3d-main-inplane", True, (1, 2, 512, 512), (2, 256, 256), "overlap", 16, 1, -(2.0 ** -21)),
    ("3d-z-seams", True, (2, 12, 40, 36), (8, 32, 32), "overlap", 4, 2, 2.0 ** -21),
]


@pytest.mark.parametrize("case", RUN_LOOP_CASES, ids=[c[0] for c in RUN_LOOP_CASES])
def test_k5_run_loop_bit_equal_to_plain(rng, case):
    """The kernels' loop (runs of 8 outputs over the union of their column
    tiles, uncovered outputs masked, the quotient by ``div_rn`` or an exact
    reciprocal) gives every output the plain versions' sum in the scan's
    order, bit for bit, on the paths' geometry: config 4's exact 1024² grid
    in 512² tiles, column starts off 8, an overlapping grid with three covers
    an axis, a strip of eight column tiles, and PredictMultiOutput3D's
    in-plane grid (starts 0, 230, 256) at a small depth."""
    name, vol, (n_units, d, h, w), tile, starts, margin, c, err = case
    if vol:
        tile = tuple(min(e, t) for e, t in zip((d, h, w), tile))
        grid = [tiling.overlap_starts(e, t, 0.1) for e, t in zip((d, h, w), tile)]
        plan = tiling.TilePlan3D(d, h, w, tile, *grid, "cpu",
                                 tiling._blend_factors([len(g) for g in grid], tile, margin))
        tiles = (rng.standard_normal((n_units * plan.per_volume, c) + tile) * 2).astype(np.float16)
        ref = blend_stitch_3d_plain(torch.from_numpy(tiles), n_units, plan, torch.float32)
    else:
        add = 1 if starts == "add1" else 0
        xs = tiling.grid_starts(h, tile, add) if not isinstance(starts, tuple) else starts
        ys = tiling.grid_starts(w, tile, add) if not isinstance(starts, tuple) else starts
        plan = tiling.TilePlan(h, w, tile, tile, xs, ys, "cpu",
                               tiling._margin_factors((len(xs), len(ys)), (tile, tile), margin))
        tiles = (rng.standard_normal((n_units * plan.per_frame, c, tile, tile)) * 2
                 ).astype(np.float16)
        ref = margin_stitch_plain(torch.from_numpy(tiles), n_units, plan, torch.float32)
    ours = _stitch_rows_emulated(tiles, n_units, plan, vol, err)
    np.testing.assert_array_equal(ours.view(np.uint32), ref.numpy().view(np.uint32), err_msg=name)


def test_stitch_wrappers_refuse_bad_arguments():
    factors = tiling._margin_factors((2, 2), (16, 16), 2)
    plan = tiling.TilePlan(32, 32, 16, 16, [0, 16], [0, 16], "cpu", factors)
    bare = tiling.TilePlan(32, 32, 16, 16, [0, 16], [0, 16], "cpu")
    good = torch.zeros((8, 1, 16, 16), dtype=torch.float16)
    with pytest.raises(ValueError, match="float16"):
        margin_stitch(good.float(), 2, plan)
    with pytest.raises(ValueError, match="tiles for"):
        margin_stitch(good[:7], 2, plan)
    with pytest.raises(ValueError, match="factor tables"):
        margin_stitch(good, 2, bare)
    with pytest.raises(ValueError):
        margin_stitch(good[:, :, :8], 2, plan)
    with pytest.raises(ValueError, match="writes"):
        margin_stitch(good, 2, plan, torch.bfloat16)
    with pytest.raises(ValueError, match="float16"):
        tile_sum(good.float(), 4)
    with pytest.raises(ValueError, match="n_real"):
        tile_sum(good, 9)
    with pytest.raises(ValueError, match="do not match"):
        tiling.TilePlan(32, 32, 16, 16, [0, 16], [0, 16], "cpu", [factors[0][:1], factors[1]])
    with pytest.raises(ValueError):
        normalize_tile_float(torch.zeros((2, 32, 32), dtype=torch.uint8),
                             torch.zeros((4, 2)), plan, 8, torch.float16)


# --- PredictMultiOutput -------------------------------------------------------

def _movie(rng, dtype, shape):
    if dtype == np.float32:
        return (rng.standard_normal(shape) * 30 - 10).astype(np.float32)
    top = np.iinfo(dtype).max
    base = rng.integers(0, top // 2, shape, endpoint=True)
    yy, xx = np.mgrid[: shape[1], : shape[2]]
    blob = ((yy - shape[1] / 2) ** 2 + (xx - shape[2] / 3) ** 2) < (min(shape[1:]) / 4) ** 2
    return (base + blob[None] * (top // 2)).astype(dtype)


def _close(ours, ref, what):
    assert set(ours) == set(ref) == set(HEADS), what
    for head in HEADS:
        a, b = ours[head], ref[head]
        assert a.shape == b.shape and a.dtype == b.dtype == np.float32, (what, head)
        bad = np.abs(a - b) > 1e-3 + 1e-3 * np.abs(b)
        assert not bad.any(), (what, head, int(bad.sum()), float(np.abs(a - b).max()))


PREDICT_CASES = [
    # name, model, dtype, movie shape, max patch, add_tile, mode, safe margin
    ("u8-single-exact-tail-chunk", "nested4", np.uint8, (18, 64, 64), 32, 0, "single", 4),
    ("u16-first-overlap", "mo_unet", np.uint16, (2, 48, 40), 32, 1, "first", 3),
    ("f32-all-reflect-pad", "nested3_deep_dilated", np.float32, (2, 24, 40), 32, 0, "all", 5),
]


@pytest.fixture(scope="module")
def predictions(ckpts):
    """Every case through JAX and the port (CPU), fused and host-staged."""
    rng = np.random.default_rng(5)
    out = {}
    for name, model, dtype, shape, patch, add, mode, margin in PREDICT_CASES:
        movie = _movie(rng, dtype, shape)
        kw = dict(max_patch_size=(patch, patch), add_tile=add, normalization_mode=mode,
                  safe_margin=margin, show_progress=False, batch_size=4)
        path = ckpts[model][0]
        out[name] = {dp: (JPredictMultiOutput(movie, path, device_pipeline=dp, **kw).result,
                          PredictMultiOutput(movie, path, device="cpu", device_pipeline=dp,
                                             **kw).result)
                     for dp in (None, False)}
    return out


@pytest.mark.parametrize("case", PREDICT_CASES, ids=[c[0] for c in PREDICT_CASES])
def test_predict_multi_output_matches_jax(predictions, case):
    name, _, _, shape, *_ = case
    for dp, (jax_res, ours) in predictions[name].items():
        _close(ours, jax_res, f"{name} device_pipeline={dp}")
        assert ours["mask"].shape == shape
        assert ours["orientation"].shape == (shape[0], 2) + shape[1:]
    # the port's two paths, within the JAX package's own fused-vs-host contract
    fused, host = predictions[name][None][1], predictions[name][False][1]
    for head in HEADS:
        np.testing.assert_allclose(fused[head], host[head], atol=2e-3, rtol=0,
                                   err_msg=f"{name} {head}")
        # the fused path rounds each stitched head to float16, the host path does not
        assert np.array_equal(fused[head], fused[head].astype(np.float16))


def test_predict_multi_output_saves_heads_and_squeezes(ckpts, rng, tmp_path):
    frame = _movie(rng, np.uint8, (1, 40, 40))[0]
    src = str(tmp_path / "frame.tif")
    tiff.imwrite(src, frame)
    p = PredictMultiOutput(src, ckpts["mo_unet"][0], result_path=str(tmp_path / "out"),
                           max_patch_size=(32, 32), safe_margin=2, compress_tif=True,
                           show_progress=False, device="cpu")
    assert p.patch_size == (32, 32) and p.target_keys == list(HEADS)
    assert p.result["mask"].shape == (40, 40)
    assert p.result["orientation"].shape == (2, 40, 40)
    for head in HEADS:
        np.testing.assert_array_equal(tiff.imread(str(tmp_path / "out" / f"{head}.tif")),
                                      p.result[head])


def test_predict_multi_output_blockers_take_host_path(ckpts, rng, monkeypatch):
    """What blocks the fused program in JAX blocks it here: a non-float,
    non-uint input and a movie beyond the fused tile-pixel budget."""
    path = ckpts["mo_unet"][0]
    kw = dict(max_patch_size=(32, 32), safe_margin=4, show_progress=False, device="cpu")
    movie = _movie(rng, np.uint16, (2, 48, 48)).astype(np.int32)
    with pytest.warns(UserWarning, match="device_pipeline=True cannot"):
        forced = PredictMultiOutput(movie, path, device_pipeline=True, **kw).result
    host = PredictMultiOutput(movie, path, device_pipeline=False, **kw).result
    for head in HEADS:
        np.testing.assert_array_equal(forced[head], host[head])
    monkeypatch.setattr(_Engine, "FUSED_HEADS_MAX_PX", 1000)
    with pytest.warns(UserWarning, match="budget"):
        PredictMultiOutput(movie.astype(np.uint16), path, device_pipeline=True, **kw)


def test_heads_batch_policy_and_oom_backoff(ckpts, monkeypatch):
    engine = _Engine(ckpts["nested4"][0], device="cpu")
    assert engine.heads_batch(64, 512, 512) == 16  # 2^22 tile pixels for UNet++
    assert engine.heads_batch(3, 512, 512) == 3
    mo = _Engine(ckpts["mo_unet"][0], batch_size=32, device="cpu")
    assert mo.heads_batch(256, 512, 512) == 64  # 2^24; batch_size is not the floor
    calls = []

    def run():
        raise torch.cuda.OutOfMemoryError("out of memory")

    with pytest.warns(UserWarning, match="retrying with batch 8"):
        assert engine._dispatch_with_oom_backoff(run, 16, lambda bs: calls.append(bs) or bs) == 8
    assert calls == [8]
    with pytest.raises(torch.cuda.OutOfMemoryError):
        engine._dispatch_with_oom_backoff(run, 1, lambda bs: bs)


def test_predict_multi_output_device_rule_and_refusals(ckpts, rng):
    path = ckpts["mo_unet"][0]
    movie = _movie(rng, np.uint8, (1, 32, 32))
    kw = dict(max_patch_size=(32, 32), show_progress=False)
    if torch.cuda.is_available():
        assert PredictMultiOutput(movie, path, **kw).engine.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PredictMultiOutput(movie, path, **kw)
    with pytest.raises(NotImplementedError, match="mesh"):
        PredictMultiOutput(movie, path, mesh=object(), device="cpu", **kw)
    # int8 prediction of MultiOutputUnet is ported
    assert PredictMultiOutput(movie, path, quantized=True, device="cpu", **kw).engine._quant_ready
    with pytest.raises(ValueError, match="not valid"):
        PredictMultiOutput(movie, path, normalization_mode="median", device="cpu", **kw)


def test_heads_modules_import_and_predict_without_jax(tmp_path):
    """The multi-head modules import, and a CPU ``PredictMultiOutput`` on a
    UNet++ runs, with JAX, flax, optax, ml_dtypes and the JAX package made
    unimportable (names matched exactly or followed by '.')."""
    code = textwrap.dedent(f"""
        import sys
        import numpy as np
        BLOCKED = ("jax", "jaxlib", "flax", "optax", "ml_dtypes", "bio_image_unet_tpu")
        for name in list(sys.modules):
            if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                del sys.modules[name]
        for b in BLOCKED:
            sys.modules[b] = None
        sys.path.insert(0, {str(REPO)!r})
        import torch
        from bio_image_unet_tpu_torch.models import MultiOutputNestedUNet
        import bio_image_unet_tpu_torch.models.nested_unet
        import bio_image_unet_tpu_torch.ops.functional
        import bio_image_unet_tpu_torch.ops.stitch
        from bio_image_unet_tpu_torch.ops.blocks import init_weights_
        from bio_image_unet_tpu_torch.predict import PredictMultiOutput
        heads = {HEADS!r}
        net = init_weights_(MultiOutputNestedUNet(n_filter=4, output_heads=heads),
                            torch.Generator().manual_seed(0), True)
        path = {str(tmp_path / "n.pt")!r}
        torch.save({{"state_dict": net.state_dict(), "model_name": "MultiOutputNestedUNet",
                    "n_filter": 4, "output_heads": heads}}, path)
        movie = np.random.default_rng(0).integers(0, 255, (2, 40, 40), dtype=np.uint8)
        res = PredictMultiOutput(movie, path, max_patch_size=(32, 32), show_progress=False,
                                 device="cpu").result
        assert res["mask"].shape == (2, 40, 40) and res["orientation"].shape == (2, 2, 40, 40)
        assert all(np.isfinite(v).all() for v in res.values())
        leaked = sorted(n for n in sys.modules if sys.modules[n] is not None and
                        any(n == b or n.startswith(b + ".") for b in BLOCKED))
        assert not leaked, leaked
        print("OK")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("OK"), out.stdout
