"""The port's 3D prediction on ``UNet3D`` (``Predict3D``), held against the
JAX package on the same reference ``.pt`` and the same inputs: the rank-3
primitives, the 3D blocks and models, the weight mapping, the BN-folded 3D
forward, the 3D tile plans, K2v (normalize and 3-axis tiles) and K3v
(sigmoid·255 and the volume's mean stitch), and ``Predict3D`` on both paths.

Tolerances: primitives atol 1e-6; models and folded forwards float32 atol
2e-4; K2v's tiles equal; K3v equal on the same logits; ``Predict3D`` port vs
JAX at most one uint8 level on at most 0.1% of voxels (the cross-layout
contract of ``bio_image_unet_tpu.testing``), port fused vs port host-staged
the same.
"""

import subprocess
import sys
import textwrap
from fractions import Fraction
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bio_image_unet_tpu.models import UNet3D as JUNet3D
from bio_image_unet_tpu.ops import functional as jfunctional
from bio_image_unet_tpu.ops import stitch as jstitch
from bio_image_unet_tpu.predict import Predict3D as JPredict3D
from bio_image_unet_tpu.predict import tiling as jtiling
from bio_image_unet_tpu.predict.fastpath import build_fast_apply
from bio_image_unet_tpu.predict.predictor import (_extract_tiles_3d, _normalize_clip,
                                                  _tile_plan_3d)
from bio_image_unet_tpu_torch import checkpoint, unet3d
from bio_image_unet_tpu_torch.interop import state_dict_from_jax
from bio_image_unet_tpu_torch.models import UNet3D, get_model
from bio_image_unet_tpu_torch.ops import functional
from bio_image_unet_tpu_torch.ops.blocks import ConvBlock, ConvTranspose3D, init_weights_
from bio_image_unet_tpu_torch.ops.stitch import _fma_f32, sigmoid_stitch_3d
from bio_image_unet_tpu_torch.predict import Predict3D, tiling
from bio_image_unet_tpu_torch.predict.fastpath import FoldedUNet3D, folded_forward
from bio_image_unet_tpu_torch.predict.normalize import normalize_tile_3d
from bio_image_unet_tpu_torch.predict.predictor import _Engine
from torch_parity import assert_u8_contract, write_3d_checkpoint

REPO = Path(__file__).resolve().parent.parent
# name: UNet3D hyperparams
MODELS = {"tconv": {"use_interpolation": False}, "trilinear": {"use_interpolation": True}}


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """``{name: (path, JAX model, JAX variables)}`` of seeded ``UNet3D``
    checkpoints, n_filter 4, both decoder styles."""
    root = tmp_path_factory.mktemp("unet3d")
    out = {}
    for seed, (name, extra) in enumerate(MODELS.items()):
        path, variables = write_3d_checkpoint(root, name, "UNet3D", seed, out_channels=1,
                                              **extra)
        out[name] = (path, JUNet3D(n_filter=4, **extra), variables)
    return out


def _ncdhw(x):
    return torch.from_numpy(np.moveaxis(x, -1, 1).copy())


def _port_model(path):
    state = checkpoint.load(path)
    net = get_model(state["hyperparams"]["model_name"], **state["hyperparams"])
    net.load_state_dict(state["state_dict"], strict=True)
    return net.eval()


# --- primitives -----------------------------------------------------------------

PRIMITIVES = {
    "max_pool": (lambda x: jfunctional.max_pool(x), functional.max_pool),
    "upsample_nearest": (jfunctional.upsample_nearest, functional.upsample_nearest),
    "downsample_nearest": (jfunctional.downsample_nearest, functional.downsample_nearest),
    "upsample_trilinear": (jfunctional.upsample_linear, functional.upsample_linear),
}


@pytest.mark.parametrize("shape", [(2, 4, 6, 10, 3), (1, 5, 7, 3, 2), (2, 6, 8, 3)],
                         ids=["3d", "3d-odd", "2d"])
@pytest.mark.parametrize("name", list(PRIMITIVES))
def test_functional_matches_jax(rng, name, shape):
    """Max pool, nearest ×2 and ×0.5 and linear ×2 (align_corners=False:
    JAX's ``jax.image.resize(method='linear')`` is torch's trilinear /
    bilinear ``F.interpolate``) at spatial rank 3 and 2."""
    ref_fn, ours_fn = PRIMITIVES[name]
    x = rng.standard_normal(shape).astype(np.float32)
    ref = np.moveaxis(np.asarray(ref_fn(jnp.asarray(x))), -1, 1)
    ours = ours_fn(_ncdhw(x)).numpy()
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=0)


# --- blocks, models, weights --------------------------------------------------------

def test_init_weights_draws_every_3d_layer():
    net = init_weights_(UNet3D(n_filter=4), torch.Generator().manual_seed(0),
                        random_bn_stats=True)
    again = init_weights_(UNet3D(n_filter=4), torch.Generator().manual_seed(0),
                          random_bn_stats=True)
    sd = net.state_dict()
    assert all(torch.equal(v, again.state_dict()[k]) for k, v in sd.items())
    assert not torch.equal(sd["encode1.1.running_var"], torch.ones(2))
    assert sd["encode1.0.weight"].shape == (2, 1, 3, 3, 3)
    # He-normal with the leaky gain (slope 0.01) on fan_in = 2·27
    w = sd["decode5.0.weight"]
    assert abs(float(w.std()) - np.sqrt(2 / (1 + 1e-4)) / np.sqrt(12 * 27)) < 0.05
    tconv = UNet3D(n_filter=4)
    assert isinstance(tconv.up1, ConvTranspose3D) and tconv.up1.weight.shape == (32, 32, 2, 2, 2)
    assert "final.weight" in tconv.state_dict()  # bare Conv3d, the reference's key
    assert not hasattr(UNet3D(n_filter=4, use_interpolation=True), "up1")


def test_conv_block_3d_bf16_mirrors_the_jax_casts(rng):
    block = init_weights_(ConvBlock(3, 4, ndim=3), torch.Generator().manual_seed(1), True).eval()
    x = torch.from_numpy(rng.random((2, 3, 4, 6, 6)).astype(np.float32))
    with torch.no_grad():
        f32 = block(x)
        block.compute_dtype = torch.bfloat16
        bf16 = block(x)
    assert bf16.dtype == torch.bfloat16 and block[1].running_var.dtype == torch.float32
    assert (bf16.float() - f32).abs().max().item() < 0.05


@pytest.mark.parametrize("name", list(MODELS))
def test_model_and_folded_forward_match_jax(ckpts, rng, name):
    path, model, variables = ckpts[name]
    x = rng.random((2, 8, 16, 16, 1)).astype(np.float32)
    ref_probs, ref_logits = model.apply(variables, jnp.asarray(x), train=False)
    apply_fn, packed = build_fast_apply(model, variables, None)
    fast_probs, fast_logits = apply_fn(packed, jnp.asarray(x))
    net = _port_model(path)
    with torch.no_grad():
        probs, logits = net(_ncdhw(x))
        folded = folded_forward(net)
        f_probs, f_logits = folded(_ncdhw(x))
    assert isinstance(folded, FoldedUNet3D) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.moveaxis(np.asarray(ref_logits), -1, 1),
                               atol=2e-4, rtol=0)
    np.testing.assert_allclose(probs.numpy(), np.moveaxis(np.asarray(ref_probs), -1, 1),
                               atol=2e-4, rtol=0)
    np.testing.assert_allclose(f_logits.numpy(), np.moveaxis(np.asarray(fast_logits), -1, 1),
                               atol=2e-4, rtol=0)
    np.testing.assert_allclose(f_probs.numpy(), np.moveaxis(np.asarray(fast_probs), -1, 1),
                               atol=2e-4, rtol=0)


@pytest.mark.parametrize("name", list(MODELS))
def test_state_dict_from_jax_equals_exported_pt(ckpts, name):
    path, _, variables = ckpts[name]
    ours = state_dict_from_jax(variables)
    loaded = checkpoint.load(path)["state_dict"]
    hyper = checkpoint.peek(path)["hyperparams"]
    assert hyper["model_name"] == "UNet3D" and hyper["use_interpolation"] == \
        MODELS[name]["use_interpolation"]
    assert set(ours) == set(loaded) and "final.weight" in ours
    for k, v in loaded.items():
        assert ours[k].dtype == v.dtype and torch.equal(ours[k], v), k
    missing, unexpected = _port_model(path).load_state_dict(ours, strict=True)
    assert not missing and not unexpected


def test_bf16_folded_3d_forward_is_close(ckpts, rng):
    net = _port_model(ckpts["trilinear"][0])
    x = torch.from_numpy(rng.random((2, 1, 8, 16, 16)).astype(np.float32))
    with torch.no_grad():
        f32 = folded_forward(net).logits(x)
        bf16 = folded_forward(net, torch.bfloat16).logits(x.to(torch.bfloat16))
    assert bf16.dtype == torch.bfloat16
    assert (bf16.float() - f32).abs().max().item() < 0.1


# --- tiling ------------------------------------------------------------------------

@pytest.mark.parametrize("extent,tile,overlap", [(512, 256, 0.1), (64, 64, 0.1), (40, 32, 0.1),
                                                 (33, 16, 0.0), (10, 6, 0.25), (5, 8, 0.1)])
def test_overlap_starts_equal_jax(extent, tile, overlap):
    assert tiling.overlap_starts(extent, tile, overlap) == \
        jtiling.overlap_starts(extent, tile, overlap)


@pytest.mark.parametrize("shape,tile,add", [((16, 64, 64), (8, 32, 32), 0),
                                            ((12, 40, 36), (8, 32, 32), 1),
                                            ((6, 40, 40), (8, 32, 32), 0),
                                            ((9, 21, 23), (5, 15, 15), 1)])
def test_tile_plan_3d_matches_jax(shape, tile, add):
    starts = [jtiling.grid_starts(e, t, add) for e, t in zip(shape, tile)]
    exact, *_ = _tile_plan_3d(*shape, *tile, *(tuple(s) for s in starts))
    plan = tiling.TilePlan3D(*shape, tile, *starts, "cpu")
    assert plan.exact == exact and plan.per_volume == np.prod([len(s) for s in starts])
    # the cover ranges hold exactly the tiles whose span covers each position
    for starts_a, t, lo, hi, n in zip(starts, tile, (plan.z_lo, plan.row_lo, plan.col_lo),
                                      (plan.z_hi, plan.row_hi, plan.col_hi), shape):
        for p in range(n):
            want = [i for i, s in enumerate(starts_a) if s <= p < s + t]
            assert list(range(int(lo[p]), int(hi[p]))) == want


# --- K2v ---------------------------------------------------------------------------

def _jax_bounds(vols, qs):
    from bio_image_unet_tpu.ops import histogram as jhist

    flat = vols.reshape(vols.shape[0], -1)
    if vols.dtype == np.float32:
        vals = jhist.float_clip_bounds(flat, *qs)
    else:
        vals = jhist.int_clip_bounds(flat, *qs, n_bits=8 * vols.dtype.itemsize)
    return np.stack([np.asarray(v) for v in vals]).astype(np.float32)


def _volumes(rng, dtype, shape):
    if dtype == np.float32:
        return (rng.standard_normal(shape) * 40 + 5).astype(np.float32)
    return rng.integers(0, np.iinfo(dtype).max, shape, endpoint=True).astype(dtype)


K2V_CASES = [
    # name, dtype, (V, d, h, w), tile, add_patch, invert, fixed bounds, out dtype, batch pad
    ("u8-exact", np.uint8, (1, 16, 64, 64), (8, 32, 32), 0, False, False, "uint8", 0),
    ("u16-overlap-invert", np.uint16, (1, 12, 40, 36), (8, 32, 32), 1, True, False, "uint8", 3),
    ("f32-reflect-pad", np.float32, (1, 6, 40, 20), (8, 32, 32), 0, False, False, "uint8", 1),
    ("u8-two-volumes-float", np.uint8, (2, 12, 40, 36), (8, 32, 32), 0, False, False,
     "float32", 0),
    ("u16-fixed-bounds-bf16", np.uint16, (2, 9, 21, 23), (5, 15, 15), 1, False, True,
     "bfloat16", 2),
]


@pytest.mark.parametrize("case", K2V_CASES, ids=[c[0] for c in K2V_CASES])
def test_normalize_tile_3d_equals_jax(rng, case):
    """K2v's plain version against ``predictor.py:1222-1235`` (uint8 mode:
    scale 255, invert, reflect pad, truncation) and ``:1324-1340`` (float
    mode: scale 1, the tile cast to the working dtype), per-volume or fixed
    bounds, tiles in volume-major z/x/y order, the batch padded with the last
    tile: equal."""
    name, dtype, shape, tile, add, invert, fixed, out, extra = case
    vols = _volumes(rng, dtype, shape)
    n_vols, d, h, w = shape
    qs = (0.5, 99.5)
    if fixed:
        b = _jax_bounds(vols[:1], qs)[:, 0]
        bounds = np.array([b[0], b[1], b[0], b[1]], np.float32)[:, None]
    else:
        bounds = _jax_bounds(vols, qs)
    starts = [jtiling.grid_starts(e, t, add) for e, t in zip((d, h, w), tile)]
    nz, nx, ny = (len(s) for s in starts)
    n = n_vols * nz * nx * ny
    scale = 255.0 if out == "uint8" else 1.0
    exact, iz, ix, iy = _tile_plan_3d(d, h, w, *tile, *(tuple(s) for s in starts))

    @jax.jit
    def run(vols, bounds):
        lo, hi, fmin, fmax = (bounds[i][:, None, None, None] for i in range(4))
        f = _normalize_clip(vols.astype(jnp.float32), lo, hi, fmin, fmax, invert, scale)
        pads = ((0, 0),) + tuple((0, max(t - e, 0)) for t, e in zip(tile, (d, h, w)))
        if any(p[1] for p in pads):
            f = jnp.pad(f, pads, mode="reflect")
        if out == "uint8":
            f = f.astype(jnp.uint8)
        p = _extract_tiles_3d(f, nz, nx, ny, *tile, exact, iz, ix, iy)
        if extra:
            p = jnp.concatenate([p, jnp.broadcast_to(p[-1:], (extra,) + p.shape[1:])])
        return p[..., 0].astype(getattr(jnp, out))

    ref = np.asarray(run(jnp.asarray(vols), jnp.asarray(np.broadcast_to(
        bounds, (4, n_vols)).copy())))
    plan = tiling.TilePlan3D(d, h, w, tile, *starts, "cpu")
    before = normalize_tile_3d.launches
    ours = normalize_tile_3d(torch.from_numpy(vols), torch.from_numpy(bounds), plan, n + extra,
                             invert, getattr(torch, out))
    assert normalize_tile_3d.launches == before  # the CPU takes the plain version
    assert ours.shape == (n + extra,) + tile and ours.dtype == getattr(torch, out)
    np.testing.assert_array_equal(ours.float().numpy(), ref.astype(np.float32), err_msg=name)


def test_normalize_tile_3d_rejects_bad_arguments():
    plan = tiling.TilePlan3D(8, 32, 32, (4, 16, 16), [0, 4], [0, 16], [0, 16], "cpu")
    vol = torch.zeros((1, 8, 32, 32), dtype=torch.uint8)
    good = torch.zeros((4, 1))
    with pytest.raises(ValueError, match="n_total"):
        normalize_tile_3d(vol, good, plan, 7)
    with pytest.raises(ValueError):
        normalize_tile_3d(vol, torch.zeros((4, 2)), plan, 8)
    with pytest.raises(ValueError, match="volumes"):
        normalize_tile_3d(vol[:, :4], good, plan, 8)
    with pytest.raises(ValueError, match="uint8/uint16/float32"):
        normalize_tile_3d(vol.to(torch.int32), good, plan, 8)
    with pytest.raises(ValueError, match="writes"):
        normalize_tile_3d(vol, good, plan, 8, out_dtype=torch.float16)
    deep = tiling.TilePlan3D(3, 32, 32, (8, 16, 16), [0], [0, 16], [0, 16], "cpu")
    with pytest.raises(ValueError, match="reflect"):
        normalize_tile_3d(torch.zeros((1, 3, 32, 32), dtype=torch.uint8), good, deep, 4)


# --- K3v ---------------------------------------------------------------------------

K3V_CASES = [
    # name, (d, h, w), tile, add_patch, logits dtype
    ("exact-f32", (16, 64, 64), (8, 32, 32), 0, "float32"),
    ("overlap-bf16", (12, 40, 36), (8, 32, 32), 1, "bfloat16"),
    ("shallow-f32", (6, 40, 40), (8, 32, 32), 0, "float32"),
    ("odd-tile-f32", (9, 21, 23), (5, 15, 15), 1, "float32"),
]


@pytest.mark.parametrize("case", K3V_CASES, ids=[c[0] for c in K3V_CASES])
def test_sigmoid_stitch_3d_equals_jax(rng, case):
    """K3v's plain version against the fused program's epilogue
    (``predictor.py:1242-1256``: float32 sigmoid ·255 → uint8, the inverse
    transpose on an exact grid, else ``_stitch_xla_3d`` with the mean and
    truncation of ``_stitch_3d_jit``) on the same logits: equal."""
    name, (d, h, w), tile, add, dtype = case
    starts = [jtiling.grid_starts(e, t, add) for e, t in zip((d, h, w), tile)]
    plan = tiling.TilePlan3D(d, h, w, tile, *starts, "cpu")
    n = plan.per_volume
    logits = jnp.asarray((rng.standard_normal((n + 2,) + tile) * 4).astype(np.float32)).astype(
        getattr(jnp, dtype))
    probs = (jax.nn.sigmoid(logits[:n].astype(jnp.float32)) * 255.0).astype(jnp.uint8)
    out_shape = tuple(max(t, e) for t, e in zip(tile, (d, h, w)))
    if plan.exact:
        ref = (probs.reshape(plan.nz, plan.nx, plan.ny, *tile).transpose(0, 3, 1, 4, 2, 5)
               .reshape(out_shape))
    else:
        ref = jstitch.stitch_mean_device_3d(probs[..., None], starts, out_shape,
                                            quantize_u8=True)[..., 0]
    ref = np.asarray(ref)[:d, :h, :w]
    before = sigmoid_stitch_3d.launches
    ours = sigmoid_stitch_3d(torch.from_numpy(np.asarray(logits.astype(jnp.float32))).to(
        getattr(torch, dtype)), plan)
    assert sigmoid_stitch_3d.launches == before
    assert ours.dtype == torch.uint8 and ours.shape == (d, h, w)
    np.testing.assert_array_equal(ours.numpy(), ref, err_msg=name)


def test_fma_f32_rounds_once():
    """The fused multiply-add of the K5v plain version: exactly rounded,
    including a float64 sum that lands on a float32 midpoint (where rounding
    the float64 sum would round twice)."""
    one_ulp = 2.0 ** -23
    a = torch.tensor([1 + one_ulp], dtype=torch.float32)
    b = torch.tensor([2.0 ** -24 * (1 - one_ulp)], dtype=torch.float32)
    c = torch.tensor([1 + one_ulp], dtype=torch.float32)
    # exact: 1 + 2^-23 + 2^-24 - 2^-70, just below the midpoint
    assert _fma_f32(a, b, c).item() == 1 + one_ulp
    assert (a.double() * b.double() + c.double()).float().item() == 1 + 2 * one_ulp
    rng = np.random.default_rng(0)
    x = [rng.standard_normal(2000).astype(np.float32) for _ in range(3)]
    x[1][:500] = rng.uniform(0, 1, 500).astype(np.float32)
    got = _fma_f32(*(torch.from_numpy(v) for v in x)).numpy()
    for i in range(2000):
        exact = Fraction(float(x[0][i])) * Fraction(float(x[1][i])) + Fraction(float(x[2][i]))
        lo = np.float32(float(exact))  # float() rounds once to float64
        # the float32 nearest to the exact value: compare both neighbours
        cands = [lo, np.nextafter(lo, np.float32(np.inf)), np.nextafter(lo, np.float32(-np.inf))]
        best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                         int(np.asarray(v).view(np.int32)) & 1))
        assert got[i] == best, i


# --- Predict3D ---------------------------------------------------------------------

def _volume(rng, dtype, shape):
    if dtype == np.float32:
        return (rng.standard_normal(shape) * 30 - 10).astype(np.float32)
    top = np.iinfo(dtype).max
    base = rng.integers(0, top // 2, shape, endpoint=True)
    zz, yy, xx = np.mgrid[: shape[0], : shape[1], : shape[2]]
    blob = (((zz - shape[0] / 2) * 3) ** 2 + (yy - shape[1] / 2) ** 2
            + (xx - shape[2] / 3) ** 2) < (min(shape[1:]) / 4) ** 2
    return (base + blob * (top // 2)).astype(dtype)


PREDICT_CASES = [
    # name, model, dtype, volume, tile, add_patch, invert
    ("u8-exact", "tconv", np.uint8, (16, 64, 64), (8, 32, 32), 0, False),
    ("u16-add-patch", "tconv", np.uint16, (12, 40, 36), (8, 32, 32), 1, False),
    ("f32-trilinear-invert", "trilinear", np.float32, (16, 48, 40), (8, 32, 32), 0, True),
    ("u8-shallower-than-tile", "trilinear", np.uint8, (6, 40, 40), (8, 32, 32), 0, False),
]


@pytest.fixture(scope="module")
def predictions(ckpts):
    """Every case through JAX and the port (CPU), fused and host-staged."""
    rng = np.random.default_rng(3)
    out = {}
    for name, model, dtype, shape, tile, add, invert in PREDICT_CASES:
        vol = _volume(rng, dtype, shape)
        kw = dict(resize_dim=tile, add_patch=add, invert=invert, show_progress=False,
                  batch_size=2)
        path = ckpts[model][0]
        out[name] = {dp: (JPredict3D(vol, None, path, device_pipeline=dp, **kw).result,
                          Predict3D(vol, None, path, device="cpu", device_pipeline=dp,
                                    **kw).result)
                     for dp in (None, False)}
    return out


@pytest.mark.parametrize("case", PREDICT_CASES, ids=[c[0] for c in PREDICT_CASES])
def test_predict_3d_matches_jax(predictions, case):
    name, _, _, shape, *_ = case
    for dp, (ref, ours) in predictions[name].items():
        assert ours.shape == shape
        assert_u8_contract(ours, ref)
    assert_u8_contract(predictions[name][None][1], predictions[name][False][1])


def test_predict_3d_tif_io_facade_and_refusals(ckpts, rng, tmp_path):
    from bio_image_unet_tpu_torch.data import tiff

    path = ckpts["tconv"][0]
    vol = _volume(rng, np.uint8, (8, 32, 32))
    src = str(tmp_path / "vol.tif")
    tiff.imwrite(src, vol)
    out = str(tmp_path / "mask.tif")
    p = unet3d.Predict(src, out, path, resize_dim=(8, 32, 32), show_progress=False,
                       device="cpu")
    assert isinstance(p, Predict3D) and p.result.shape == (8, 32, 32)
    np.testing.assert_array_equal(tiff.imread(out).astype(np.uint8), p.result)
    # 3D training is ported: the facade's DataProcess and Trainer are the real ones
    from bio_image_unet_tpu_torch.data.pipelines import DataProcess3D
    from bio_image_unet_tpu_torch.train import Trainer

    assert unet3d.DataProcess is DataProcess3D and issubclass(unet3d.Trainer, Trainer)
    kw = dict(resize_dim=(8, 32, 32), show_progress=False)
    if torch.cuda.is_available():
        assert Predict3D(vol, None, path, **kw).engine.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Predict3D(vol, None, path, **kw)
    with pytest.raises(NotImplementedError, match="mesh"):
        Predict3D(vol, None, path, mesh=object(), device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="quantized"):
        Predict3D(vol, None, path, quantized=True, device="cpu", **kw)
    with pytest.raises(ValueError, match="volume"):
        Predict3D(vol[0], None, path, device="cpu", **kw)


def test_predict_3d_blockers_take_host_path(ckpts, rng, monkeypatch):
    """What blocks the fused program in JAX blocks it here, with the warning
    when it was asked for: a dtype it does not normalize, a tile 2× the
    volume's extent, more tile voxels than the budget.  The batch policy is
    JAX's."""
    path = ckpts["tconv"][0]
    kw = dict(show_progress=False, device="cpu")
    vol = _volume(rng, np.uint16, (8, 32, 32))
    with pytest.warns(UserWarning, match="device_pipeline=True cannot"):
        forced = Predict3D(vol.astype(np.int32), None, path, resize_dim=(8, 32, 32),
                           device_pipeline=True, **kw).result
    host = Predict3D(vol, None, path, resize_dim=(8, 32, 32), device_pipeline=False, **kw).result
    np.testing.assert_array_equal(forced, host)
    with pytest.warns(UserWarning, match="2× the volume"):
        Predict3D(vol[:3], None, path, resize_dim=(8, 32, 32), device_pipeline=True, **kw)
    monkeypatch.setattr(_Engine, "FUSED_HEADS_MAX_PX", 1000)
    with pytest.warns(UserWarning, match="budget"):
        Predict3D(vol, None, path, resize_dim=(8, 32, 32), device_pipeline=True, **kw)
    engine = _Engine(path, "UNet3D", batch_size=4, device="cpu")
    # 2^23 tile voxels a step (predictor.py:1206), the user's batch_size the floor
    _, plan, bs = engine.volume_runner(64, 512, 512, [0, 32], *[range(0, 512, 128)] * 2,
                                       (32, 128, 128), (0.0, 99.8))
    assert plan.per_volume == 32 and bs == 16
    assert engine.volume_runner(8, 32, 32, [0], [0], [0], (8, 32, 32), (0.0, 99.8))[2] == 4


def test_3d_modules_import_and_predict_without_jax(tmp_path):
    """The 3D modules import, and a CPU ``Predict3D`` and
    ``PredictMultiOutput3D`` run, with JAX, flax, optax, ml_dtypes and the
    JAX package made unimportable (names matched exactly or followed by
    '.')."""
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
        from bio_image_unet_tpu_torch import multi_output_unet3d, unet3d
        from bio_image_unet_tpu_torch.ops.blocks import init_weights_
        heads = {{"mask": {{"channels": 1, "activation": "sigmoid"}},
                  "vec": {{"channels": 2, "activation": None}}}}
        vol = np.random.default_rng(0).integers(0, 255, (8, 40, 36), dtype=np.uint8)
        for cls, name, hyper in ((unet3d.UNet3D, "UNet3D", {{}}),
                                 (multi_output_unet3d.MultiOutputUnet3D, "MultiOutputUnet3D",
                                  {{"output_heads": heads}})):
            net = init_weights_(cls(n_filter=4, **hyper), torch.Generator().manual_seed(0), True)
            path = {str(tmp_path)!r} + f"/{{name}}.pt"
            torch.save({{"state_dict": net.state_dict(), "model_name": name, "n_filter": 4,
                        **hyper}}, path)
            if name == "UNet3D":
                res = unet3d.Predict(vol, None, path, resize_dim=(8, 32, 32),
                                     show_progress=False, device="cpu").result
                assert res.shape == vol.shape and res.dtype == np.uint8
            else:
                res = multi_output_unet3d.Predict(vol, path, max_patch_size=(8, 32, 32),
                                                  show_progress=False, device="cpu").result
                assert res["mask"].shape == vol.shape and res["vec"].shape == (2,) + vol.shape
        leaked = sorted(n for n in sys.modules if sys.modules[n] is not None and
                        any(n == b or n.startswith(b + ".") for b in BLOCKED))
        assert not leaked, leaked
        print("OK")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("OK"), out.stdout
