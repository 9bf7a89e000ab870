"""The port's ``quantized=True`` 3D prediction (``Predict3D`` on ``UNet3D``,
``PredictMultiOutput3D`` on ``MultiOutputUnet3D``) end to end, held against
the JAX package's on the same ``.pt`` (the port on the CPU, K7v/K8v/K10v and
K9 through their plain versions).

Each side calibrates itself on the volumes and folds BatchNorm itself: the
calibrated per-site maxes agree within 2e-2 relative, and the two may
quantize a few activations one code apart, so the masks are held to the
contract the JAX package holds between its 2D int8 and bf16 paths (at most 4
uint8 levels, a mean under 0.5, more than one level on under 1% of voxels)
and the heads to JAX's 3D bounds of int8 against bf16
(``tests/test_quant_families.py:231-247``: max under 15%, mean under 3% of
the head's range).  The transposed-conv ``UNet3D`` quantizes on
``quantized=True``; the trilinear ``UNet3D`` and ``MultiOutputUnet3D`` only
under ``BIU_INT8_EXPERIMENTAL`` and otherwise warn and run bf16, as in JAX;
the host-staged path warns and runs float.  Models are BN-warmed as in the
JAX package's 3D int8 tests.
"""

import warnings

import numpy as np
import pytest
import torch

from bio_image_unet_tpu.predict import Predict3D as JPredict3D
from bio_image_unet_tpu.predict import PredictMultiOutput3D as JPredictMultiOutput3D
from bio_image_unet_tpu.predict import predictor as jpredictor
from bio_image_unet_tpu_torch.predict import Predict3D, PredictMultiOutput3D
from bio_image_unet_tpu_torch.predict import predictor
from bio_image_unet_tpu_torch.predict.tiling import grid_starts
from torch_parity import write_seeded_checkpoint

HEADS = {"mask": {"channels": 1, "activation": "sigmoid"},
         "vec": {"channels": 2, "activation": None}}
TILE = (16, 32, 32)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("predict_quant3d_pt")
    specs = {"tconv": ("UNet3D", 80, {}),
             "trilinear": ("UNet3D", 81, {"use_interpolation": True}),
             "mo": ("MultiOutputUnet3D", 82, {"output_heads": HEADS}),
             "mo_tconv": ("MultiOutputUnet3D", 83, {"output_heads": HEADS,
                                                    "use_interpolation": False})}
    return {name: write_seeded_checkpoint(root, name, reg, seed, n_filter=8, warm=True,
                                          **extra)[0]
            for name, (reg, seed, extra) in specs.items()}


@pytest.fixture
def maxes(monkeypatch):
    """The raw per-site maxes each package calibrates, call by call."""
    seen = {"port": [], "jax": []}
    for key, engine in (("port", predictor._Engine), ("jax", jpredictor._Engine)):
        finish = engine._finish_int8_calibration

        def spy(self, raw, _finish=finish, _key=key):
            seen[_key].append(np.asarray(raw, np.float32))
            return _finish(self, raw)

        monkeypatch.setattr(engine, "_finish_int8_calibration", spy)
    return seen


def assert_same_calibration(maxes):
    assert len(maxes["port"]) == len(maxes["jax"]) == 1, maxes
    np.testing.assert_allclose(maxes["port"][0], maxes["jax"][0], rtol=2e-2)


def assert_int8_contract(ours, ref):
    assert ours.shape == ref.shape and ours.dtype == ref.dtype == np.uint8
    d = np.abs(ours.astype(int) - ref.astype(int))
    assert d.max() <= 4, d.max()
    assert d.mean() < 0.5, d.mean()
    assert (d > 1).mean() < 0.01, (d > 1).mean()


def _blob_volume(seed, dtype=np.uint8, d=24, h=48, w=48):
    """A bright blob on a noisy background (``tests/test_quant_families.py``)."""
    rng = np.random.default_rng(seed)
    zz, yy, xx = np.mgrid[0:d, 0:h, 0:w]
    vol = (30 + 180 * np.exp(-((zz - d / 2) ** 2 * 4 + (yy - h / 2 - seed % 7) ** 2
                               + (xx - w / 2) ** 2) / 200.0) + 10 * rng.random((d, h, w)))
    top = 255 if dtype == np.uint8 else 257
    return np.clip(vol * (1 if dtype == np.uint8 else top), 0, np.iinfo(dtype).max).astype(dtype)


def _warned(call):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        result = call()
    return result, [(w.category, str(w.message)) for w in caught
                    if "int8" in str(w.message) or "quantized" in str(w.message)]


@pytest.mark.parametrize("name,dtype,add,env", [("tconv", np.uint8, 0, None),
                                               ("trilinear", np.uint16, 1, "1")])
def test_predict3d_quantized_matches_jax(ckpts, maxes, monkeypatch, name, dtype, add, env):
    if env is None:
        monkeypatch.delenv("BIU_INT8_EXPERIMENTAL", raising=False)
    else:
        monkeypatch.setenv("BIU_INT8_EXPERIMENTAL", env)
    vol = _blob_volume(1, dtype)
    kw = dict(resize_dim=TILE, add_patch=add, show_progress=False, quantized=True)
    ref, jax_warned = _warned(lambda: JPredict3D(vol, None, ckpts[name], **kw))
    ours, warned = _warned(lambda: Predict3D(vol, None, ckpts[name], device="cpu", **kw))
    assert warned == jax_warned == []  # int8 runs: no fallback warning on either side
    assert ours.engine._quant_ready
    assert_same_calibration(maxes)
    assert_int8_contract(ours.result, ref.result)
    # the int8 path really ran: it is not the float path's result
    flt = Predict3D(vol, None, ckpts[name], device="cpu", **{**kw, "quantized": False}).result
    assert not np.array_equal(ours.result, flt)


@pytest.mark.parametrize("name,mode", [("mo", "single"), ("mo_tconv", "all")])
def test_predict_multi_output_3d_quantized_matches_jax(ckpts, maxes, monkeypatch, name, mode):
    monkeypatch.setenv("BIU_INT8_EXPERIMENTAL", "1")
    vols = np.stack([_blob_volume(2), _blob_volume(3) // 2])
    kw = dict(max_patch_size=TILE, normalization_mode=mode, show_progress=False, quantized=True)
    ref = JPredictMultiOutput3D(vols, ckpts[name], **kw).result
    p = PredictMultiOutput3D(vols, ckpts[name], device="cpu", **kw)
    assert p.engine._quant_ready and set(p.result) == set(ref)
    assert_same_calibration(maxes)
    for head in ref:
        rg = max(float(ref[head].max() - ref[head].min()), 0.5)
        d = np.abs(p.result[head] - ref[head].astype(np.float32))
        assert d.max() / rg < 0.15, (head, d.max(), rg)
        assert d.mean() / rg < 0.03, (head, d.mean(), rg)


@pytest.mark.parametrize("family,mode,invert", [("tconv", "single", True), ("mo", "first", False)])
def test_quantized_3d_calibration_on_the_card_path(ckpts, maxes, monkeypatch, family, mode,
                                                    invert):
    """The 3D calibration cuts its tiles with the fused path's kernels (K1
    per volume or the stack-global bounds, K2v in float mode; on the CPU
    their plain versions) from the call's own upload, never through the
    host normalization; its maxes stay within 2e-2 of JAX's."""
    monkeypatch.setenv("BIU_INT8_EXPERIMENTAL", "1")

    def host_normalization(*args, **kwargs):
        raise AssertionError("the int8 calibration normalized volumes on the host")

    if family == "tconv":
        vol = _blob_volume(6, np.uint16)
        kw = dict(resize_dim=TILE, invert=invert, show_progress=False, quantized=True)
        JPredict3D(vol, None, ckpts[family], **kw)
        monkeypatch.setattr(predictor, "_normalize_stack", host_normalization)
        p = Predict3D(vol, None, ckpts[family], device="cpu", **kw)
    else:
        vols = np.stack([_blob_volume(7), _blob_volume(8) // 3])
        kw = dict(max_patch_size=TILE, normalization_mode=mode, show_progress=False,
                  quantized=True)
        JPredictMultiOutput3D(vols, ckpts[family], **kw)
        monkeypatch.setattr(predictor, "_normalize_stack", host_normalization)
        p = PredictMultiOutput3D(vols, ckpts[family], device="cpu", **kw)
    assert p.engine._quant_ready and p.engine.calibration_seconds > 0
    assert_same_calibration(maxes)


def test_quantized_3d_gate_warnings_match_jax(ckpts, monkeypatch):
    """Without BIU_INT8_EXPERIMENTAL the trilinear ``UNet3D`` and
    ``MultiOutputUnet3D`` warn and run bf16 (equal to a bf16 call); the
    host-staged path warns and runs float, naming why — in both packages."""
    monkeypatch.delenv("BIU_INT8_EXPERIMENTAL", raising=False)
    vol = _blob_volume(4)
    v3 = dict(resize_dim=TILE, show_progress=False)
    h3 = dict(max_patch_size=TILE, show_progress=False)
    cases = [
        (lambda q: Predict3D(vol, None, ckpts["trilinear"], device="cpu", quantized=q, **v3),
         lambda: JPredict3D(vol, None, ckpts["trilinear"], quantized=True, **v3),
         "BIU_INT8_EXPERIMENTAL"),
        (lambda q: PredictMultiOutput3D(vol, ckpts["mo"], device="cpu", quantized=q, **h3),
         lambda: JPredictMultiOutput3D(vol, ckpts["mo"], quantized=True, **h3),
         "BIU_INT8_EXPERIMENTAL"),
        (lambda q: Predict3D(vol, None, ckpts["tconv"], device="cpu", quantized=q,
                             device_pipeline=False, **v3),
         lambda: JPredict3D(vol, None, ckpts["tconv"], quantized=True, device_pipeline=False,
                            **v3), "device_pipeline=False was forced"),
    ]
    for ours, ref, cause in cases:
        p, got = _warned(lambda: ours(True))
        _, want = _warned(ref)
        assert [c for c, _ in got] == [c for c, _ in want] == [UserWarning], (got, want)
        assert cause in got[0][1] and cause in want[0][1], (got, want)
        assert not p.engine._quant_ready
        flt = ours(False).result
        if isinstance(flt, dict):
            for head in flt:
                np.testing.assert_array_equal(p.result[head], flt[head])
        else:
            np.testing.assert_array_equal(p.result, flt)


def test_quantized_3d_runners_calibrate_once_on_their_sample(ckpts, maxes, monkeypatch):
    """``volume_runner`` / ``heads_3d_runner`` of a quantized engine
    calibrate on the ``sample`` they are given, once; without one they
    raise."""
    monkeypatch.setenv("BIU_INT8_EXPERIMENTAL", "1")
    vol = _blob_volume(5)
    starts = [grid_starts(e, t, 0) for e, t in zip(vol.shape, TILE)]
    engine = predictor._Engine(ckpts["tconv"], None, 4, False, "cpu", quantized=True)
    with pytest.raises(ValueError, match="calibrates"):
        engine.volume_runner(*vol.shape, *starts, TILE, (0.0, 99.8))
    fn, _, _ = engine.volume_runner(*vol.shape, *starts, TILE, (0.0, 99.8), sample=vol)
    fn2, _, _ = engine.volume_runner(*vol.shape, *starts, TILE, (0.0, 99.8), sample=vol)
    assert engine._quant_ready and len(maxes["port"]) == 1
    out = fn(torch.from_numpy(vol))
    assert out.shape == vol.shape and out.dtype == torch.uint8
    assert np.array_equal(out.numpy(), fn2(torch.from_numpy(vol)).numpy())
    assert np.array_equal(out.numpy(), Predict3D(vol, None, ckpts["tconv"], device="cpu",
                                                 resize_dim=TILE, show_progress=False,
                                                 batch_size=4, quantized=True).result)
    heads = predictor._Engine(ckpts["mo_tconv"], None, 2, False, "cpu", quantized=True)
    with pytest.raises(ValueError, match="calibrates"):
        heads.heads_3d_runner(1, *vol.shape, *starts, TILE, (0.0, 99.98), None)
