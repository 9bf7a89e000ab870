"""The port's multi-head 3D prediction on ``MultiOutputUnet3D``
(``PredictMultiOutput3D``), held against the JAX package on the same
reference ``.pt`` and the same inputs: the model (both decoder styles), the
weight mapping of its ``up<i>_conv`` blocks, the BN-folded forward, the
linear-blend tiling, K5v (the blend stitch) and ``PredictMultiOutput3D`` on
both paths.

Tolerances: models and folded forwards float32 atol 2e-4; blend weights,
factors and K5v bit-equal; ``PredictMultiOutput3D`` port vs JAX, and the
port's fused vs host-staged path, within atol 2e-3 + rtol 1e-3 on every head
and voxel (the heads are rounded to float16, whose ulp is 1e-3 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bio_image_unet_tpu.models import MultiOutputUnet3D as JMultiOutputUnet3D
from bio_image_unet_tpu.ops import stitch as jstitch
from bio_image_unet_tpu.predict import PredictMultiOutput3D as JPredictMultiOutput3D
from bio_image_unet_tpu.predict import tiling as jtiling
from bio_image_unet_tpu.predict.fastpath import build_fast_apply
from bio_image_unet_tpu_torch import checkpoint, multi_output_unet3d
from bio_image_unet_tpu_torch.data import tiff
from bio_image_unet_tpu_torch.interop import state_dict_from_jax
from bio_image_unet_tpu_torch.models import MultiOutputUnet3D, get_model
from bio_image_unet_tpu_torch.ops.stitch import blend_stitch_3d
from bio_image_unet_tpu_torch.predict import PredictMultiOutput3D, tiling
from bio_image_unet_tpu_torch.predict.fastpath import folded_forward
from bio_image_unet_tpu_torch.predict.predictor import _Engine
from torch_parity import write_seeded_checkpoint

# the heads of tests/test_quant_families.py:26-27
HEADS = {"mask": {"channels": 1, "activation": "sigmoid"},
         "vec": {"channels": 2, "activation": None}}
MODELS = {"nearest": {"use_interpolation": True}, "tconv": {"use_interpolation": False}}


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """``{name: (path, JAX model, JAX variables)}`` of seeded
    ``MultiOutputUnet3D`` checkpoints, n_filter 4, both decoder styles."""
    root = tmp_path_factory.mktemp("heads3d")
    out = {}
    for seed, (name, extra) in enumerate(MODELS.items()):
        path, variables = write_seeded_checkpoint(root, name, "MultiOutputUnet3D", seed + 10,
                                              output_heads=HEADS, **extra)
        out[name] = (path, JMultiOutputUnet3D(n_filter=4, output_heads=HEADS, **extra), variables)
    return out


def _ncdhw(x):
    return torch.from_numpy(np.moveaxis(x, -1, 1).copy())


def _port_model(path):
    state = checkpoint.load(path)
    net = get_model(state["hyperparams"]["model_name"], **state["hyperparams"])
    net.load_state_dict(state["state_dict"], strict=True)
    return net.eval()


@pytest.mark.parametrize("name", list(MODELS))
def test_model_and_folded_forward_match_jax(ckpts, rng, name):
    path, model, variables = ckpts[name]
    x = rng.random((2, 8, 16, 16, 1)).astype(np.float32)
    apply = jax.jit(lambda v, a: model.apply(v, a, train=False))
    ref = apply(variables, jnp.asarray(x))
    apply_fn, packed = build_fast_apply(model, variables, None)
    fast = apply_fn(packed, jnp.asarray(x))
    net = _port_model(path)
    with torch.no_grad():
        ours = net(_ncdhw(x))
        folded = folded_forward(net)(_ncdhw(x))
    assert set(ours) == set(folded) == set(ref) == set(HEADS)
    for head in HEADS:
        assert ours[head].dtype == folded[head].dtype == torch.float32
        np.testing.assert_allclose(ours[head].numpy(), np.moveaxis(np.asarray(ref[head]), -1, 1),
                                   atol=2e-4, rtol=0, err_msg=head)
        np.testing.assert_allclose(folded[head].numpy(),
                                   np.moveaxis(np.asarray(fast[head]), -1, 1),
                                   atol=2e-4, rtol=0, err_msg=head)


@pytest.mark.parametrize("name", list(MODELS))
def test_state_dict_from_jax_equals_exported_pt(ckpts, name):
    path, _, variables = ckpts[name]
    ours = state_dict_from_jax(variables)
    loaded = checkpoint.load(path)["state_dict"]
    hyper = checkpoint.peek(path)["hyperparams"]
    assert hyper["output_heads"] == HEADS
    assert hyper["use_interpolation"] == MODELS[name]["use_interpolation"]
    assert set(ours) == set(loaded)
    assert ("up1_conv.0.weight" in ours) == MODELS[name]["use_interpolation"]
    for k, v in loaded.items():
        assert ours[k].dtype == v.dtype and torch.equal(ours[k], v), k
    missing, unexpected = _port_model(path).load_state_dict(ours, strict=True)
    assert not missing and not unexpected


def test_default_head_and_bf16_model():
    net = MultiOutputUnet3D(n_filter=4)
    assert net.heads == {"default": {"channels": 1, "activation": "sigmoid"}}
    assert net.use_interpolation and hasattr(net, "up1_conv") and not hasattr(net, "up1")
    bf16 = MultiOutputUnet3D(n_filter=4, output_heads=HEADS, dtype=torch.bfloat16).eval()
    with torch.no_grad():
        out = bf16(torch.rand((1, 1, 8, 16, 16)))
    assert out["mask"].dtype == out["vec"].dtype == torch.float32
    assert out["vec"].shape == (1, 2, 8, 16, 16)


# --- blend tiling and K5v ------------------------------------------------------------

GRIDS = [((2, 3, 2), (8, 32, 24), 4), ((1, 2, 2), (6, 16, 16), 8), ((3, 1, 2), (8, 8, 16), 16),
         ((2, 2, 2), (4, 4, 4), 0)]


@pytest.mark.parametrize("grid,tile,margin", GRIDS)
def test_blend_weights_and_factors_equal_jax(grid, tile, margin):
    np.testing.assert_array_equal(tiling._blend_weights(grid, tile, margin),
                                  jtiling._blend_weights(grid, tile, margin))
    factors = tiling._blend_factors(grid, tile, margin)
    for a, b in zip(factors, jtiling._blend_factors(grid, tile, margin)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    # the outer MIN of the factors is the dense weight of every tile
    dense = tiling._blend_weights(grid, tile, margin)
    for n, idx in enumerate(np.ndindex(*grid)):
        w = np.minimum(np.minimum(factors[0][idx[0]][:, None, None], factors[1][idx[1]][None, :, None]),
                       factors[2][idx[2]][None, None, :])
        np.testing.assert_array_equal(w, dense[n][..., 0])


@pytest.mark.parametrize("shape,tile,overlap,margin", [((12, 40, 36), (8, 32, 32), 0.1, 4),
                                                       ((8, 33, 33), (8, 16, 16), 0.0, 5)])
def test_stitch_blend3d_equals_jax(rng, shape, tile, overlap, margin):
    starts = [jtiling.overlap_starts(e, t, overlap) for e, t in zip(shape, tile)]
    n = int(np.prod([len(s) for s in starts]))
    patches = rng.random((n,) + tile + (2,)).astype(np.float16)
    ours = tiling.stitch_blend3d(patches, starts, shape, margin)
    ref = jtiling.stitch_blend3d(patches, starts, shape, margin)
    np.testing.assert_array_equal(ours.view(np.uint32), ref.view(np.uint32))


K5V_CASES = [
    # name, (V, d, h, w), max tile, overlap, margin, channels
    ("two-volumes-2ch", (2, 12, 40, 36), (8, 32, 32), 0.1, 4, 2),
    ("margin-over-tile", (1, 10, 24, 40), (6, 16, 16), 0.25, 8, 1),
    ("uncovered-seams", (1, 8, 33, 33), (8, 16, 16), 0.0, 5, 1),
    ("one-tile", (2, 6, 16, 16), (8, 32, 32), 0.1, 4, 2),
    # PredictMultiOutput3D's in-plane grid on the card: 512^2 planes in 256^2
    # tiles, overlap 0.1 (starts 0, 230, 256), margin 16; depth cut to 4
    ("main-path-inplane", (1, 4, 512, 512), (4, 256, 256), 0.1, 16, 2),
]


@pytest.mark.parametrize("case", K5V_CASES, ids=[c[0] for c in K5V_CASES])
def test_blend_stitch_3d_bit_equal_to_jax(rng, case):
    """K5v's plain version against JAX's factored stitch with the fused
    epilogue (``predictor.py:1354-1365``, float16 out) and the dense weighted
    stitch of the host path (``ops/stitch.py:204`` with ``fill_mean=False``,
    float32 out), on the same float16 tiles: bit-equal, uncovered voxels 0.
    (XLA fuses the scan's ``block + patch * w`` into one multiply-add, and so
    does K5v.)"""
    name, (n_vols, d, h, w), max_tile, overlap, margin, c = case
    tile = tuple(min(e, m) for e, m in zip((d, h, w), max_tile))
    starts = [jtiling.overlap_starts(e, t, overlap) for e, t in zip((d, h, w), tile)]
    grid = [len(s) for s in starts]
    per = int(np.prod(grid))
    factors = tiling._blend_factors(grid, tile, margin)
    plan = tiling.TilePlan3D(d, h, w, tile, *starts, "cpu", factors)
    tiles = (rng.standard_normal((n_vols * per, c) + tile) * 2).astype(np.float16)

    hp = jnp.asarray(np.moveaxis(tiles, 1, -1)).astype(jnp.float32)
    gs = np.meshgrid(*[np.asarray(s) for s in starts], indexing="ij")
    st = jnp.asarray(np.stack([g.ravel() for g in gs], 1).astype(np.int32))
    gi = np.meshgrid(*[np.arange(n) for n in grid], indexing="ij")
    gidx = jnp.asarray(np.stack([g.ravel() for g in gi], 1).astype(np.int32))
    facs = tuple(jnp.asarray(f) for f in factors)

    def one(vol_patches):
        s, wsum = jstitch._stitch_factored_xla(vol_patches, facs, gidx, st, (d, h, w))
        return jnp.where(wsum > 0, s / jnp.maximum(wsum, 1e-12), 0.0)

    fused = np.asarray(jax.jit(jax.vmap(one))(hp.reshape((n_vols, per) + hp.shape[1:]))
                       .astype(jnp.float16))
    host = np.asarray(jstitch.stitch_weighted_frames_device(
        np.moveaxis(tiles, 1, -1), jtiling._blend_weights(grid, tile, margin), starts, n_vols,
        (d, h, w), fill_mean=False))
    before = blend_stitch_3d.launches
    for out_dtype, ref, bits in ((torch.float16, fused, np.uint16),
                                 (torch.float32, host, np.uint32)):
        ours = blend_stitch_3d(torch.from_numpy(tiles), n_vols, plan, out_dtype).numpy()
        want = np.moveaxis(ref, -1, 1)
        assert ours.shape == want.shape == (n_vols, c, d, h, w) and ours.dtype == want.dtype
        np.testing.assert_array_equal(ours.view(bits), want.view(bits), err_msg=f"{name} {out_dtype}")
    assert blend_stitch_3d.launches == before
    if name == "uncovered-seams":
        assert (ours == 0).any()


def test_blend_stitch_3d_rejects_bad_arguments():
    tile = (4, 16, 16)
    factors = tiling._blend_factors((2, 2, 2), tile, 2)
    plan = tiling.TilePlan3D(8, 32, 32, tile, [0, 4], [0, 16], [0, 16], "cpu", factors)
    bare = tiling.TilePlan3D(8, 32, 32, tile, [0, 4], [0, 16], [0, 16], "cpu")
    good = torch.zeros((8, 1) + tile, dtype=torch.float16)
    with pytest.raises(ValueError, match="float16"):
        blend_stitch_3d(good.float(), 1, plan)
    with pytest.raises(ValueError, match="tiles for"):
        blend_stitch_3d(good[:7], 1, plan)
    with pytest.raises(ValueError, match="factor tables"):
        blend_stitch_3d(good, 1, bare)
    with pytest.raises(ValueError):
        blend_stitch_3d(good[:, :, :2], 1, plan)
    with pytest.raises(ValueError, match="writes"):
        blend_stitch_3d(good, 1, plan, torch.bfloat16)
    with pytest.raises(ValueError, match="do not match"):
        tiling.TilePlan3D(8, 32, 32, tile, [0, 4], [0, 16], [0, 16], "cpu", factors[:2] + [
            factors[2][:1]])


# --- PredictMultiOutput3D ----------------------------------------------------------

def _volumes(rng, dtype, shape):
    if dtype == np.float32:
        return (rng.standard_normal(shape) * 30 - 10).astype(np.float32)
    top = np.iinfo(dtype).max
    base = rng.integers(0, top // 2, shape, endpoint=True)
    zz, yy, xx = np.mgrid[: shape[1], : shape[2], : shape[3]]
    blob = (((zz - shape[1] / 2) * 3) ** 2 + (yy - shape[2] / 2) ** 2
            + (xx - shape[3] / 3) ** 2) < (min(shape[2:]) / 4) ** 2
    return (base + blob[None] * (top // 2)).astype(dtype)


PREDICT_CASES = [
    # name, model, dtype, (V, d, h, w), normalization_mode
    ("u8-single-nearest", "nearest", np.uint8, (2, 12, 40, 36), "single"),
    ("u16-first-tconv", "tconv", np.uint16, (2, 12, 40, 36), "first"),
    ("f32-all-nearest", "nearest", np.float32, (2, 10, 36, 40), "all"),
]


@pytest.fixture(scope="module")
def predictions(ckpts):
    """Every case through JAX and the port (CPU), fused and host-staged."""
    rng = np.random.default_rng(6)
    out = {}
    for name, model, dtype, shape, mode in PREDICT_CASES:
        vols = _volumes(rng, dtype, shape)
        kw = dict(max_patch_size=(8, 32, 32), normalization_mode=mode, blend_margin=4,
                  show_progress=False, batch_size=2)
        path = ckpts[model][0]
        out[name] = {dp: (JPredictMultiOutput3D(vols, path, device_pipeline=dp, **kw).result,
                          PredictMultiOutput3D(vols, path, device="cpu", device_pipeline=dp,
                                               **kw).result)
                     for dp in (None, False)}
    return out


def _close(ours, ref, what):
    assert set(ours) == set(ref) == set(HEADS), what
    for head in HEADS:
        a, b = ours[head], ref[head]
        assert a.shape == b.shape and a.dtype == b.dtype == np.float32, (what, head)
        np.testing.assert_allclose(a, b, atol=2e-3, rtol=1e-3, err_msg=f"{what} {head}")


@pytest.mark.parametrize("case", PREDICT_CASES, ids=[c[0] for c in PREDICT_CASES])
def test_predict_multi_output_3d_matches_jax(predictions, case):
    name, _, _, shape, _ = case
    for dp, (ref, ours) in predictions[name].items():
        _close(ours, ref, f"{name} device_pipeline={dp}")
        assert ours["mask"].shape == shape
        assert ours["vec"].shape == (shape[0], 2) + shape[1:]
    fused, host = predictions[name][None][1], predictions[name][False][1]
    _close(fused, host, f"{name} fused vs host")
    for head in HEADS:
        # the fused path rounds each stitched head to float16, the host path does not
        assert np.array_equal(fused[head], fused[head].astype(np.float16))


def test_predict_multi_output_3d_saves_heads_and_squeezes(ckpts, rng, tmp_path):
    vol = _volumes(rng, np.uint8, (1, 8, 24, 40))[0]
    src = str(tmp_path / "vol.tif")
    tiff.imwrite(src, vol)
    p = multi_output_unet3d.Predict(src, ckpts["nearest"][0], result_path=str(tmp_path / "out"),
                                    max_patch_size=(8, 32, 32), compress_tif=True,
                                    show_progress=False, device="cpu")
    assert isinstance(p, PredictMultiOutput3D) and p.patch_size == (8, 24, 32)
    assert p.target_keys == list(HEADS)
    assert p.result["mask"].shape == (8, 24, 40) and p.result["vec"].shape == (2, 8, 24, 40)
    for head in HEADS:  # the codec writes a 4-D head as pages
        back = tiff.imread(str(tmp_path / "out" / f"{head}.tif"))
        np.testing.assert_array_equal(back.reshape(p.result[head].shape), p.result[head])
    # 3D training is ported: the facade's DataProcess and Trainer are the real ones
    from bio_image_unet_tpu_torch.data.pipelines import DataProcessMultiOutput3D
    from bio_image_unet_tpu_torch.train import Trainer

    assert multi_output_unet3d.DataProcess is DataProcessMultiOutput3D
    assert issubclass(multi_output_unet3d.Trainer, Trainer)


def test_predict_multi_output_3d_blockers_batch_policy_and_refusals(ckpts, rng, monkeypatch):
    path = ckpts["tconv"][0]
    kw = dict(max_patch_size=(8, 32, 32), blend_margin=4, show_progress=False, device="cpu")
    vols = _volumes(rng, np.uint16, (2, 8, 32, 32))
    with pytest.warns(UserWarning, match="device_pipeline=True cannot"):
        forced = PredictMultiOutput3D(vols.astype(np.int32), path, device_pipeline=True,
                                      **kw).result
    host = PredictMultiOutput3D(vols, path, device_pipeline=False, **kw).result
    for head in HEADS:
        np.testing.assert_array_equal(forced[head], host[head])
    with pytest.warns(UserWarning, match="NaN"):
        nan = vols.astype(np.float32)
        nan[0, 0, 0, 0] = np.nan
        PredictMultiOutput3D(nan, path, device_pipeline=True, **kw)
    monkeypatch.setattr(_Engine, "FUSED_HEADS_MAX_PX", 1000)
    with pytest.warns(UserWarning, match="budget"):
        PredictMultiOutput3D(vols, path, device_pipeline=True, **kw)
    monkeypatch.undo()
    # 2^23 tile voxels a step (predictor.py:1297-1298); batch_size is not the floor
    engine = _Engine(path, batch_size=8, device="cpu")
    factors = tiling._blend_factors((1, 3, 3), (64, 256, 256), 16)
    _, plan, bs = engine.heads_3d_runner(2, 64, 512, 512, [0], [0, 230, 256], [0, 230, 256],
                                         (64, 256, 256), (0.0, 99.98), factors)
    assert plan.per_volume == 9 and bs == 2
    # the OOM back-off halves the forward batch and runs the program again
    small = _volumes(rng, np.uint8, (2, 8, 32, 32))
    runner, real_run, batches = engine.heads_3d_runner, engine._run_once, []

    def spy(*args, **kwargs):
        out = runner(*args, **kwargs)
        batches.append(out[2])
        return out

    def flaky(host, fn):
        if len(batches) == 1:
            raise torch.cuda.OutOfMemoryError("out of memory")
        return real_run(host, fn)

    monkeypatch.setattr(engine, "heads_3d_runner", spy)
    monkeypatch.setattr(engine, "_run_once", flaky)
    with pytest.warns(UserWarning, match="retrying with batch 1"):
        res = engine.fused_predict_heads_3d(small, [0], [0], [0], (8, 32, 32), (0.0, 99.98),
                                            tiling._blend_factors((1, 1, 1), (8, 32, 32), 4))
    assert batches == [2, 1] and res["vec"].shape == (2, 2, 8, 32, 32)
    if torch.cuda.is_available():
        assert PredictMultiOutput3D(vols, path, **{**kw, "device": None}).engine.device.type \
            == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PredictMultiOutput3D(vols, path, **{**kw, "device": None})
    with pytest.raises(NotImplementedError, match="mesh"):
        PredictMultiOutput3D(vols, path, mesh=object(), **kw)
    # MultiOutputUnet3D's int8 graph is experimental in the JAX package: a warning and
    # the float path, as there; opted in, the fused path calibrates and runs int8
    monkeypatch.delenv("BIU_INT8_EXPERIMENTAL", raising=False)
    with pytest.warns(UserWarning, match="BIU_INT8_EXPERIMENTAL"):
        assert not PredictMultiOutput3D(vols, path, quantized=True, **kw).engine._quant_ready
    monkeypatch.setenv("BIU_INT8_EXPERIMENTAL", "1")
    q = PredictMultiOutput3D(vols, path, quantized=True, **kw)
    assert q.engine._quant_ready and q.result["vec"].shape == (2, 2, 8, 32, 32)
    with pytest.raises(ValueError, match="not valid"):
        PredictMultiOutput3D(vols, path, normalization_mode="median", **kw)
