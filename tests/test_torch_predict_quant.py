"""The port's ``quantized=True`` prediction (w8a8 int8 trunk) end to end,
held against the JAX package's on the same ``.pt`` (the port on the CPU, K7–K10
through their plain versions).

Each side calibrates itself on the movie and folds BatchNorm itself: the
calibrated per-site maxes agree within 2e-2 relative, and the two may
quantize a few activations one code apart, so the results are held to the
contract the JAX package holds between its int8 and bf16 paths
(``tests/test_quant.py``): at most 4 uint8 levels, a mean under 0.5, more
than one level on under 1% of pixels; continuous heads within 6% of their
range (mean 1%).  The Siam models are BN-warmed as in the JAX package's own
Siam int8 tests: with random BatchNorm statistics the twin trunk amplifies
quantization noise so much that the JAX package's int8 result is itself
outside this contract of its bf16 one.  The warnings of the int8 gate match
JAX's in category and cause.
"""

import os
import warnings

import numpy as np
import pytest

from bio_image_unet_tpu.data import tiff as jtiff
from bio_image_unet_tpu.predict import Predict as JPredict
from bio_image_unet_tpu.predict import PredictMultiOutput as JPredictMultiOutput
from bio_image_unet_tpu.predict import PredictSiam as JPredictSiam
from bio_image_unet_tpu.predict import predictor as jpredictor
from bio_image_unet_tpu_torch.data import tiff
from bio_image_unet_tpu_torch.predict import Predict, PredictMultiOutput, PredictSiam
from bio_image_unet_tpu_torch.predict import predictor
from torch_parity import write_seeded_checkpoint

HEADS = {"mask": {"channels": 1, "activation": "sigmoid"},
         "orientation": {"channels": 2, "activation": None}}


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("predict_quant_pt")
    specs = {"unet": ("Unet", 50, {}), "mo": ("MultiOutputUnet", 51, {"output_heads": HEADS}),
             "nested": ("MultiOutputNestedUNet", 52, {"output_heads": HEADS}),
             **{f"siam_{m}": ("Siam_UNet", 53 + i, {"mode": m, "warm": True})
                for i, m in enumerate(("max", "control", "concat", "corr"))}}
    return {name: write_seeded_checkpoint(root, name, reg, seed, **extra)[0]
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


def _movie(seed, dtype, shape):
    rng = np.random.default_rng(seed)
    top = 255 if dtype == np.uint8 else 50000
    yy, xx = np.mgrid[: shape[1], : shape[2]]
    frames = [top * 0.1 + top * 0.6 * np.exp(-((yy - shape[1] / 3 - 4 * i) ** 2
                                                + (xx - shape[2] / 2) ** 2) / 150.0)
              + top * 0.2 * rng.random(shape[1:]) for i in range(shape[0])]
    return np.clip(np.stack(frames), 0, top).astype(dtype)


def assert_int8_contract(ours, ref):
    assert ours.shape == ref.shape and ours.dtype == ref.dtype == np.uint8
    d = np.abs(ours.astype(int) - ref.astype(int))
    assert d.max() <= 4, d.max()
    assert d.mean() < 0.5, d.mean()
    assert (d > 1).mean() < 0.01, (d > 1).mean()


@pytest.mark.parametrize("dtype,mode", [(np.uint8, "single"), (np.uint16, "all")])
def test_predict_quantized_matches_jax(ckpts, maxes, dtype, mode):
    movie = _movie(1, dtype, (3, 80, 72))
    kw = dict(resize_dim=(32, 32), normalization_mode=mode, show_progress=False, batch_size=8,
              quantized=True)
    ref = JPredict(movie, None, ckpts["unet"], **kw)
    ours = Predict(movie, None, ckpts["unet"], device="cpu", **kw)
    assert ours.engine._quant_ready
    assert_same_calibration(maxes)
    assert_int8_contract(ours.result, ref.result)
    # the int8 path really ran: it is not the float path's result
    flt = Predict(movie, None, ckpts["unet"], device="cpu",
                  **{**kw, "quantized": False}).result
    assert not np.array_equal(ours.result, flt)


def test_predict_multi_output_quantized_matches_jax(ckpts, maxes):
    movie = _movie(2, np.uint8, (2, 48, 48))
    kw = dict(max_patch_size=(32, 32), show_progress=False, batch_size=8, safe_margin=4,
              quantized=True)
    ref = JPredictMultiOutput(movie, ckpts["mo"], **kw).result
    p = PredictMultiOutput(movie, ckpts["mo"], device="cpu", **kw)
    assert p.engine._quant_ready and set(p.result) == set(ref)
    assert_same_calibration(maxes)
    for k in ref:
        d = np.abs(p.result[k] - ref[k].astype(np.float32))
        out_range = float(ref[k].max() - ref[k].min()) + 1e-9
        assert d.max() / out_range < 0.06, (k, d.max() / out_range)
        assert d.mean() / out_range < 0.01, (k, d.mean() / out_range)


@pytest.mark.parametrize("join,mode", [("max", "single"), ("control", "first"),
                                       ("concat", "all")])
def test_predict_siam_quantized_matches_jax(tmp_path, ckpts, maxes, join, mode):
    src = str(tmp_path / "movie.tif")
    tiff.imwrite(src, _movie(3, np.uint8, (5, 40, 48)))
    kw = dict(resize_dim=(32, 32), normalization_mode=mode, show_progress=False,
              batch_size=4, frames_per_chunk=2, quantized=True)
    ours, ref = str(tmp_path / "port.tif"), str(tmp_path / "jax.tif")
    p = PredictSiam(src, ours, ckpts[f"siam_{join}"], device="cpu", **kw)
    JPredictSiam(src, ref, ckpts[f"siam_{join}"], **kw)
    assert p.engine._quant_ready
    assert_same_calibration(maxes)
    assert_int8_contract(tiff.imread(ours), jtiff.imread(ref))


@pytest.mark.parametrize("dtype,mode,invert", [(np.uint8, "first", False),
                                               (np.float32, "single", True),
                                               (np.uint16, "all", True)])
def test_predict_quantized_calibration_on_the_card_path(ckpts, maxes, monkeypatch, dtype, mode,
                                                        invert):
    """The calibration cuts its tiles with the fused path's kernels (K1 or
    the stack-global bounds, K2h in float32; on the CPU their plain
    versions), never through the host normalization, and its maxes stay
    within 2e-2 of JAX's host calibration: 'first' and 'all' bounds, a
    float32 movie, ``invert``."""
    movie = _movie(8, dtype, (3, 80, 72))
    kw = dict(resize_dim=(32, 32), normalization_mode=mode, invert=invert, show_progress=False,
              batch_size=8, quantized=True)
    ref = JPredict(movie, None, ckpts["unet"], **kw)

    def host_normalization(*args, **kwargs):
        raise AssertionError("the int8 calibration normalized frames on the host")

    monkeypatch.setattr(predictor, "_normalize_stack", host_normalization)
    ours = Predict(movie, None, ckpts["unet"], device="cpu", **kw)
    assert ours.engine._quant_ready and ours.engine.calibration_seconds > 0
    assert_same_calibration(maxes)
    assert_int8_contract(ours.result, ref.result)


@pytest.mark.parametrize("join,mode,dtype,size", [("max", "all", np.uint16, (40, 48)),
                                                  ("control", "single", np.uint8, (40, 44)),
                                                  ("concat", "first", np.uint16, (40, 48))])
def test_predict_siam_quantized_calibration_on_the_card_path(tmp_path, ckpts, maxes, monkeypatch,
                                                             join, mode, dtype, size):
    """The Siam pairs calibrate on tiles cut by K2h with the pair program's
    bounds (K1 per frame, per prev plane, or K1's pair rows over one
    uploaded block), never through the host normalization: maxes within
    2e-2 of JAX's, on uint16 pages, inverted, and on frames narrower than
    the tile (48² tiles of 40×44 frames: reflect-padded calibration tiles,
    as JAX's)."""
    src = str(tmp_path / "movie.tif")
    tiff.imwrite(src, _movie(9, dtype, (5,) + size))
    tile = (32, 32) if size[1] == 48 else (48, 48)
    kw = dict(resize_dim=tile, normalization_mode=mode, invert=dtype == np.uint16,
              show_progress=False, batch_size=4, frames_per_chunk=2, quantized=True)
    ours, ref = str(tmp_path / "port.tif"), str(tmp_path / "jax.tif")
    JPredictSiam(src, ref, ckpts[f"siam_{join}"], **kw)

    def host_normalization(*args, **kwargs):
        raise AssertionError("the int8 calibration normalized frames on the host")

    monkeypatch.setattr(predictor, "_normalize_stack", host_normalization)
    p = PredictSiam(src, ours, ckpts[f"siam_{join}"], device="cpu", **kw)
    assert p.engine._quant_ready
    assert_same_calibration(maxes)
    assert_int8_contract(tiff.imread(ours), jtiff.imread(ref))


def _warned(call):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        result = call()
    return result, [(w.category, str(w.message)) for w in caught
                    if "int8" in str(w.message) or "quantized" in str(w.message)]


def test_quantized_gate_warnings_match_jax(tmp_path, ckpts, monkeypatch):
    monkeypatch.delenv("BIU_INT8_EXPERIMENTAL", raising=False)
    movie = _movie(4, np.uint8, (2, 32, 32))
    src = str(tmp_path / "movie.tif")
    tiff.imwrite(src, movie)
    kw = dict(show_progress=False, quantized=True)
    cases = [
        # the 'corr' join has no int8 formulation: declined, bf16
        (lambda: PredictSiam(src, str(tmp_path / "a.tif"), ckpts["siam_corr"], device="cpu",
                             resize_dim=(32, 32), **kw),
         lambda: JPredictSiam(src, str(tmp_path / "b.tif"), ckpts["siam_corr"],
                              resize_dim=(32, 32), **kw), "declined"),
        # UNet++ is experimental: warned, bf16
        (lambda: PredictMultiOutput(movie, ckpts["nested"], max_patch_size=(32, 32),
                                    device="cpu", **kw),
         lambda: JPredictMultiOutput(movie, ckpts["nested"], max_patch_size=(32, 32), **kw),
         "BIU_INT8_EXPERIMENTAL"),
        # the host-staged path runs float, naming why
        (lambda: Predict(movie, None, ckpts["unet"], resize_dim=(32, 32),
                         device_pipeline=False, device="cpu", **kw),
         lambda: JPredict(movie, None, ckpts["unet"], resize_dim=(32, 32),
                          device_pipeline=False, **kw), "device_pipeline=False was forced"),
    ]
    for ours, ref, cause in cases:
        p, got = _warned(ours)
        _, want = _warned(ref)
        assert [c for c, _ in got] == [c for c, _ in want] == [UserWarning], (got, want)
        assert cause in got[0][1] and cause in want[0][1], (got, want)
        assert not p.engine._quant_ready


def test_quantized_unported_int8_graphs_raise(ckpts, monkeypatch):
    """UNet++'s int8 graph is ported: under BIU_INT8_EXPERIMENTAL the fused
    path runs it (no warning; the engine's forward is the int8 grid), without
    the variable the request warns and runs bf16, equal to a bf16 call, and
    the host-staged path warns and runs float, as in JAX.  (The name is
    kept from when this path raised.)"""
    from bio_image_unet_tpu_torch.predict.quant_nested import Int8NestedUNet

    movie = _movie(5, np.uint8, (1, 32, 32))
    kw = dict(max_patch_size=(32, 32), show_progress=False, quantized=True, device="cpu")
    monkeypatch.setenv("BIU_INT8_EXPERIMENTAL", "1")
    p, warned = _warned(lambda: PredictMultiOutput(movie, ckpts["nested"], **kw))
    assert not warned and p.engine._quant_ready
    assert isinstance(p.engine.forward, Int8NestedUNet)
    assert p.result["mask"].shape == (32, 32)
    with pytest.warns(UserWarning, match="host-staged path"):
        p = PredictMultiOutput(movie, ckpts["nested"], device_pipeline=False, **kw)
    assert p.result["mask"].shape == (32, 32) and not p.engine._quant_ready
    monkeypatch.delenv("BIU_INT8_EXPERIMENTAL")
    with pytest.warns(UserWarning, match="BIU_INT8_EXPERIMENTAL"):
        p = PredictMultiOutput(movie, ckpts["nested"], **kw)
    assert not p.engine._quant_ready
    ref = PredictMultiOutput(movie, ckpts["nested"], **{**kw, "quantized": False}).result
    for head in ref:
        np.testing.assert_array_equal(p.result[head], ref[head])


def test_siam_calibration_prepass_refuses_nan_pages_before_writing(tmp_path, ckpts):
    movie = _movie(6, np.uint8, (4, 32, 32)).astype(np.float32)
    movie[-1, 3, 5] = np.nan  # the last page is a sampled calibration page
    src, out = str(tmp_path / "nan.tif"), str(tmp_path / "out.tif")
    tiff.imwrite(src, movie)
    with pytest.raises(ValueError, match="calibration page"):
        PredictSiam(src, out, ckpts["siam_max"], resize_dim=(32, 32), show_progress=False,
                    device_pipeline=True, quantized=True, device="cpu")
    assert not os.path.exists(out)


def test_siam_calibration_prepass_spans_the_movie(tmp_path, ckpts, maxes):
    """The sampled pairs span the movie: a movie that opens dark and turns
    bright calibrates what JAX's pre-pass calibrates, and not what its
    opening chunk alone would."""
    movie = _movie(7, np.uint8, (6, 32, 32))
    movie[:3] //= 8
    src, first = str(tmp_path / "drift.tif"), str(tmp_path / "first.tif")
    tiff.imwrite(src, movie)
    tiff.imwrite(first, movie[:2])
    kw = dict(resize_dim=(32, 32), show_progress=False, frames_per_chunk=2, quantized=True,
              normalization_mode="first")
    PredictSiam(src, str(tmp_path / "p.tif"), ckpts["siam_max"], device="cpu", **kw)
    JPredictSiam(src, str(tmp_path / "j.tif"), ckpts["siam_max"], **kw)
    assert_same_calibration(maxes)
    PredictSiam(first, str(tmp_path / "f.tif"), ckpts["siam_max"], device="cpu", **kw)
    assert not np.allclose(maxes["port"][1], maxes["port"][0], rtol=2e-2)
    assert_int8_contract(tiff.imread(str(tmp_path / "p.tif")),
                         jtiff.imread(str(tmp_path / "j.tif")))
