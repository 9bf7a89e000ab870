"""The five Predict classes with ``mesh=`` and the whole-frame sharded
predictors, at a world of 2 gloo ranks on the CPU (``tests/torch_mesh.py``),
held against the port's world-1 result and the JAX package's mesh result.

Every rank makes the same call and returns the whole result.  Against the
port's own single-process call the float paths meet the cross-layout
contract (``testing.assert_mesh_parity``: one level on at most 0.1% of
pixels, 2e-3 for float heads) and int8 is bitwise equal; against JAX's
``mesh=get_mesh(n_data=2)`` call each class meets its existing contract
(uint8 masks within one level on at most 0.1% of pixels; 2D heads within
1e-3 + 1e-3·|JAX|, 3D heads 2e-3 + 1e-3·|JAX|).  JAX's fused 2D program on an
overlapping grid does not trace under ``shard_map`` with this JAX
(``ops/stitch.py:49``: the scan's carry loses its varying-axis type), so that
case is held against JAX's single-device call, which JAX's mesh contract
says it equals.  The sharded predictors
(2 spatial ranks, halo 16 and 8) match JAX's within
one level on at most 0.1% of pixels; with ``halo`` past the receptive field's
half-width (128 for the 2D ``Unet``, 64 for ``UNet3D``) they equal the port's
unsharded forward on the input zero-padded by ``halo`` rows (the halo
contract), and their interior rows equal the unsharded forward of the input
itself.  Only rank 0 writes files."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from bio_image_unet_tpu import predict as jpredict
from bio_image_unet_tpu.data import tiff as jtiff
from bio_image_unet_tpu.parallel import get_mesh as jget_mesh
from bio_image_unet_tpu_torch import predict
from bio_image_unet_tpu_torch.data import tiff
from bio_image_unet_tpu_torch.predict.sharded import _quantize, _resolve_forward
from bio_image_unet_tpu_torch.testing import assert_mesh_parity
from torch_mesh import leg, run_world
from torch_parity import assert_u8_contract, write_seeded_checkpoint

HEADS = {"mask": {"channels": 1, "activation": "sigmoid"},
         "orientation": {"channels": 2, "activation": None}}
PORT_ONLY = {"device": "cpu"}


def _movie(rng, dtype, shape):
    """Noise with a bright blob that moves a pixel a frame."""
    top = np.iinfo(dtype).max
    base = rng.integers(0, top // 2, shape, endpoint=True)
    yy, xx = np.mgrid[: shape[-2], : shape[-1]]
    blob = np.stack([((yy - shape[-2] / 2) ** 2 + (xx - shape[-1] / 3 - i) ** 2)
                     < (min(shape[-2:]) / 4) ** 2 for i in range(shape[-3])])
    return (base + blob * (top // 2)).astype(dtype)


# name: (class, checkpoint, movie, keywords); every call at batch_size 2
CASES = {
    "fused_u8": ("Predict", "unet", "u8_exact", {"resize_dim": (32, 32)}),
    "fused_u16": ("Predict", "unet", "u16", {"resize_dim": (32, 32), "add_tile": 1}),
    "host_u8": ("Predict", "unet", "u8", {"resize_dim": (32, 32), "device_pipeline": False}),
    "heads": ("PredictMultiOutput", "mo", "u8", {"max_patch_size": (32, 32), "add_tile": 1,
                                                  "safe_margin": 3}),
    "siam": ("PredictSiam", "siam", "siam.tif", {"resize_dim": (32, 32),
                                                 "frames_per_chunk": 3}),
    "3d": ("Predict3D", "unet3d", "vol", {"resize_dim": (8, 32, 32)}),
    "heads3d": ("PredictMultiOutput3D", "mo3d", "vols", {"max_patch_size": (8, 32, 32)}),
}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_predict")
    ck = {"unet": write_seeded_checkpoint(root, "unet", "Unet", 1)[0],
          "warm": write_seeded_checkpoint(root, "warm", "Unet", 2, warm=True)[0],
          "mo": write_seeded_checkpoint(root, "mo", "MultiOutputUnet", 3,
                                        output_heads=HEADS)[0],
          "siam": write_seeded_checkpoint(root, "siam", "Siam_UNet", 4, mode="max")[0],
          "unet3d": write_seeded_checkpoint(root, "unet3d", "UNet3D", 5)[0],
          "mo3d": write_seeded_checkpoint(root, "mo3d", "MultiOutputUnet3D", 6,
                                          output_heads=HEADS)[0]}
    rng = np.random.default_rng(0)
    inputs = {"u8": _movie(rng, np.uint8, (5, 48, 40)),
              "u8_exact": _movie(rng, np.uint8, (5, 64, 64)),
              "u16": _movie(rng, np.uint16, (3, 40, 40)),
              "vol": _movie(rng, np.uint8, (16, 40, 32)),
              "vols": _movie(rng, np.uint8, (2, 8, 40, 32)),
              "frames": _movie(rng, np.uint8, (2, 64, 32)),
              "volume": _movie(rng, np.uint8, (8, 32, 16)),
              "frames_wide": _movie(rng, np.uint8, (1, 256, 32)),
              "volume_wide": _movie(rng, np.uint8, (8, 128, 16))}
    siam_src = str(root / "siam.tif")
    tiff.imwrite(siam_src, _movie(rng, np.uint8, (5, 32, 48)))
    legs = []
    for name, (cls, ckpt, movie, kw) in CASES.items():
        result = str(root / f"{name}_out.tif") if cls in ("Predict", "PredictSiam") else None
        legs.append({"leg": "predict", "name": name, "cls": cls, "ckpt": ck[ckpt],
                     "movie": siam_src if cls == "PredictSiam" else movie, "result": result,
                     "batch_size": 2, **kw})
    legs += [{"leg": "predict", "name": "int8", "cls": "Predict", "ckpt": ck["warm"],
              "movie": "u8", "batch_size": 2, "resize_dim": (32, 32), "quantized": True},
             {"leg": "frames_sharded", "name": "frames", "ckpt": ck["unet"], "movie": "frames",
              "n_data": 1, "n_spatial": 2, "halo": 16},
             {"leg": "volume_sharded", "name": "volume", "ckpt": ck["unet3d"],
              "movie": "volume", "n_data": 1, "n_spatial": 2, "halo": 8},
             {"leg": "frames_sharded", "name": "frames_wide", "ckpt": ck["unet"],
              "movie": "frames_wide", "n_data": 1, "n_spatial": 2, "halo": 128},
             {"leg": "volume_sharded", "name": "volume_wide", "ckpt": ck["unet3d"],
              "movie": "volume_wide", "n_data": 1, "n_spatial": 2, "halo": 64},
             {"leg": "predict", "name": "odd_batch", "cls": "Predict", "ckpt": ck["unet"],
              "movie": "u8", "batch_size": 3, "resize_dim": (32, 32)}]
    ranks = run_world(2, legs, root / "world2", inputs)
    return root, ck, inputs, siam_src, ranks


def _call(pkg, cls, ckpt, movie, out, **kw):
    """One world-1 call of ``pkg``'s class; its result (Siam: read back)."""
    kw = dict(kw, show_progress=False, batch_size=2)
    C = getattr(pkg, cls)
    if cls == "PredictSiam":
        C(movie, out, ckpt, **kw)
        return (tiff if pkg is predict else jtiff).imread(out)
    if cls in ("Predict", "Predict3D"):
        return C(movie, None, ckpt, **kw).result
    return C(movie, ckpt, **kw).result


def _both_ranks(ranks, name):
    res = leg(ranks, name)
    assert "error" not in res[0], str(res[0].get("error"))
    return res


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_predict_matches_world_one_and_jax(name, setup):
    root, ck, inputs, siam_src, ranks = setup
    cls, ckpt, movie, kw = CASES[name]
    movie = siam_src if cls == "PredictSiam" else inputs[movie]
    res = _both_ranks(ranks, name)
    one = _call(predict, cls, ck[ckpt], movie, str(root / f"{name}_one.tif"), **kw,
                **PORT_ONLY)
    jmesh = None if name == "fused_u16" else jget_mesh(n_data=2, devices=jax.devices()[:2])
    ref = _call(jpredict, cls, ck[ckpt], movie, str(root / f"{name}_jax.tif"), mesh=jmesh, **kw)
    if isinstance(one, dict):
        tol = 2e-3 if cls == "PredictMultiOutput3D" else 1e-3
        for head in HEADS:
            for r in res:
                np.testing.assert_array_equal(r[head], res[0][head])
            assert_mesh_parity(res[0][head], one[head])
            bad = np.abs(res[0][head] - ref[head]) > tol + 1e-3 * np.abs(ref[head])
            assert not bad.any(), (name, head, int(bad.sum()))
        return
    if cls == "PredictSiam":  # the TIFF: rank 0 wrote it, rank 1 nothing
        assert res[1]["result"].size == 0
        got = res[0]["result"]
    else:
        np.testing.assert_array_equal(res[1]["result"], res[0]["result"])
        got = res[0]["result"]
    assert got.dtype == np.uint8 and got.shape == one.shape
    assert_mesh_parity(got, one)
    assert_u8_contract(got, ref)


def test_only_rank_zero_writes(setup):
    root = setup[0]
    assert (root / "fused_u8_out_r0.tif").exists() and not (root / "fused_u8_out_r1.tif").exists()
    assert (root / "siam_out_r0.tif").exists() and not (root / "siam_out_r1.tif").exists()
    np.testing.assert_array_equal(tiff.imread(str(root / "fused_u8_out_r0.tif")).astype(np.uint8),
                                  leg(setup[4], "fused_u8")[0]["result"])


def test_int8_is_bitwise_equal_across_layouts(setup):
    """Every rank calibrates on the same sampled frames of the whole movie,
    and integer math has no rounding freedom: world 2 equals world 1."""
    _, ck, inputs, _, ranks = setup
    res = _both_ranks(ranks, "int8")
    one = predict.Predict(inputs["u8"], None, ck["warm"], resize_dim=(32, 32), batch_size=2,
                          quantized=True, show_progress=False, device="cpu")
    assert one.engine._quant_ready
    for r in res:
        assert np.array_equal(r["result"], one.result)


def test_batch_size_must_divide_the_data_axis(setup):
    _, ck, inputs, _, ranks = setup
    with pytest.raises(ValueError) as ref:
        jpredict.Predict(inputs["u8"], None, ck["unet"], resize_dim=(32, 32), batch_size=3,
                         show_progress=False, mesh=jget_mesh(n_data=2, devices=jax.devices()[:2]))
    for r in leg(ranks, "odd_batch"):
        assert str(r["error"]) == f"ValueError: {ref.value}"


def _unsharded(ckpt, x, what, pad):
    """The port's single-device forward of the sharded predictors' input (the
    same host normalization and uint8 step), on the frames (volume) zero-padded
    by ``pad`` rows and cropped back."""
    from bio_image_unet_tpu_torch.predict.normalize import _normalize_stack

    _, forward = _resolve_forward(ckpt, None, False, torch.device("cpu"))
    if what == "frames":
        norm = _normalize_stack(x, "single", (0.0, 99.8)).astype(np.uint8)[:, None]
    else:
        norm = _normalize_stack(x[None], "all", (0.0, 99.8))[0].astype(np.uint8)[None, None]
    t = torch.from_numpy(norm.astype(np.float32) / 255.0)
    t = torch.nn.functional.pad(t, (0, 0, pad, pad) if what == "frames" else (0, 0, pad, pad, 0, 0))
    out = _quantize(forward(t))
    out = out[..., pad:out.shape[-2] - pad, :]
    return out[:, 0] if what == "frames" else out[0, 0]


@pytest.mark.parametrize("what", ["frames", "volume"])
def test_spatial_sharded_predict_matches_jax(what, setup):
    _, ck, inputs, _, ranks = setup
    ckpt, x, halo = ((ck["unet"], inputs["frames"], 16) if what == "frames"
                     else (ck["unet3d"], inputs["volume"], 8))
    jmesh = jget_mesh(n_data=1, n_spatial=2, devices=jax.devices()[:2])
    fn = (jpredict.predict_frames_spatial_sharded if what == "frames"
          else jpredict.predict_volume_spatial_sharded)
    ref = fn(x, ckpt, jmesh, halo=halo)
    res = _both_ranks(ranks, what)
    np.testing.assert_array_equal(res[1]["result"], res[0]["result"])
    got = res[0]["result"]
    assert got.shape == x.shape and got.dtype == np.uint8
    assert_u8_contract(got, ref)


@pytest.mark.parametrize("what", ["frames", "volume"])
def test_spatial_sharded_interior_equals_unsharded(what, setup):
    """With ``halo`` past the receptive field the result is the unsharded
    forward on the input zero-padded by ``halo`` rows, cropped back; rows
    farther than ``halo`` from the border equal the single-device forward of
    the input itself."""
    _, ck, inputs, _, ranks = setup
    ckpt, halo = (ck["unet"], 128) if what == "frames" else (ck["unet3d"], 64)
    x = inputs[f"{what}_wide"]
    got = _both_ranks(ranks, f"{what}_wide")[0]["result"]
    assert got.shape == x.shape
    np.testing.assert_array_equal(got, _unsharded(ckpt, x, what, halo))
    whole = _unsharded(ckpt, x, what, 0)
    np.testing.assert_array_equal(got[:, halo:-halo], whole[:, halo:-halo])
