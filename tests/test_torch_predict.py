"""The port's tiled 2D ``Predict``, held against the JAX ``Predict`` on the
same reference ``.pt`` (float32 on both sides, the port on the CPU).

Contract port vs JAX: at most one uint8 level on at most 0.1% of pixels (the
cross-layout contract of ``bio_image_unet_tpu.testing``).  Port fused vs port
host-staged: the looser contract the JAX package holds between its own two
paths (``tests/test_predict.py``), since the host path normalizes with float64
percentiles and can move a clip bound by a code point.
"""

import warnings

import numpy as np
import pytest
import torch

from bio_image_unet_tpu.data import tiff as jtiff
from bio_image_unet_tpu.predict import Predict as JPredict
from bio_image_unet_tpu_torch.predict import Predict
from bio_image_unet_tpu_torch.predict.predictor import _Engine
from bio_image_unet_tpu_torch.utils import save_as_tif
from torch_parity import assert_u8_contract, write_seeded_checkpoint, write_unet_checkpoint


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return write_unet_checkpoint(tmp_path_factory.mktemp("ckpt") / "unet.pt")[0]


def _movie(rng, dtype, shape):
    if dtype == np.float32:
        return (rng.standard_normal(shape) * 30 - 10).astype(np.float32)
    top = np.iinfo(dtype).max
    base = rng.integers(0, top // 2, shape, endpoint=True)
    # a bright blob so the network sees structure, not only noise
    yy, xx = np.mgrid[: shape[1], : shape[2]]
    blob = ((yy - shape[1] / 2) ** 2 + (xx - shape[2] / 3) ** 2) < (min(shape[1:]) / 4) ** 2
    return (base + blob[None] * (top // 2)).astype(dtype)


def _both(ckpt, movie, **kw):
    kw = dict(show_progress=False, batch_size=4, **kw)
    return JPredict(movie, None, ckpt, **kw).result, Predict(movie, None, ckpt, device="cpu", **kw).result


CASES = [
    # name, dtype, movie shape, tile, add_tile, normalization_mode, invert
    ("u8-single-exact", np.uint8, (3, 128, 128), 64, 0, "single", False),
    ("u8-single-overlap", np.uint8, (3, 96, 96), 64, 0, "single", False),
    ("u16-single-overlap", np.uint16, (2, 96, 80), 64, 1, "single", False),
    ("f32-single-exact", np.float32, (2, 128, 128), 64, 0, "single", False),
    ("u8-first-overlap", np.uint8, (3, 96, 96), 64, 0, "first", False),
    ("u16-all-exact", np.uint16, (2, 128, 128), 64, 0, "all", False),
    ("f32-all-overlap", np.float32, (2, 96, 96), 64, 0, "all", False),
    ("u8-single-invert", np.uint8, (2, 96, 96), 64, 0, "single", True),
    ("u8-single-reflect-pad", np.uint8, (2, 48, 80), 64, 0, "single", False),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_predict_matches_jax(ckpt, rng, case):
    name, dtype, shape, tile, add, mode, invert = case
    movie = _movie(rng, dtype, shape)
    kw = dict(resize_dim=(tile, tile), add_tile=add, normalization_mode=mode, invert=invert)
    j_fused, t_fused = _both(ckpt, movie, **kw)
    j_host, t_host = _both(ckpt, movie, device_pipeline=False, **kw)
    assert t_fused.shape == shape and t_fused.dtype == np.uint8
    assert_u8_contract(t_fused, j_fused)
    assert_u8_contract(t_host, j_host)
    # the port's two paths, as the JAX package holds its own two
    diff = np.abs(t_fused.astype(int) - t_host.astype(int))
    assert np.mean(diff > 1) < 0.01 and diff.max() <= 16, (name, diff.max())


def test_predict_dilated_trunk_matches_jax(tmp_path, rng):
    """A ``Unet(dilation=2)`` ``.pt`` (the encoder and middle convs dilated,
    the decoder not: ``unet2d.py:91``) through both packages' float
    ``Predict``, fused and host-staged."""
    path, _ = write_seeded_checkpoint(tmp_path, "unet_d2", "Unet", 33, n_filter=4, warm=True,
                                      dilation=2)
    movie = _movie(rng, np.uint8, (3, 96, 96))
    for pipeline in (None, False):
        ref, ours = _both(path, movie, resize_dim=(64, 64), device_pipeline=pipeline)
        assert_u8_contract(ours, ref)


def test_predict_tail_chunk_matches_jax(ckpt, rng):
    """More frames than one 16-frame chunk: the tail chunk is padded with its
    last frame and cropped after the stitch."""
    movie = _movie(rng, np.uint8, (_Engine.FUSED_CHUNK_FRAMES + 3, 40, 40))
    j, t = _both(ckpt, movie, resize_dim=(32, 32))
    assert t.shape == movie.shape
    assert_u8_contract(t, j)


def test_predict_blocked_fused_paths_take_host_path(ckpt, rng):
    """NaN floats and tiles more than twice the frame block the fused
    program; the host path then runs, as in the JAX package."""
    nan_movie = _movie(rng, np.float32, (2, 96, 96))
    nan_movie[0, 3, 5] = np.nan
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        j, t = _both(ckpt, nan_movie, resize_dim=(64, 64), device_pipeline=True)
    assert any("NaN" in str(w.message) for w in caught)
    assert_u8_contract(t, j)
    small = _movie(rng, np.uint8, (2, 24, 24))
    j, t = _both(ckpt, small, resize_dim=(64, 64))
    assert t.shape == (2, 24, 24)
    assert_u8_contract(t, j)


def test_predict_single_frame_and_tif_io(ckpt, rng, tmp_path):
    frame = _movie(rng, np.uint16, (1, 96, 96))[0] // 4  # within float16's range
    src = str(tmp_path / "frame.tif")
    save_as_tif(frame.astype(np.float32), src)
    out = str(tmp_path / "mask.tif")
    t = Predict(src, out, ckpt, resize_dim=(64, 64), show_progress=False, device="cpu")
    j = JPredict(src, None, ckpt, resize_dim=(64, 64), show_progress=False)
    assert t.result.shape == (96, 96)
    assert_u8_contract(t.result, j.result)
    np.testing.assert_array_equal(jtiff.imread(out), t.result.astype(np.float16))


def test_predict_without_device_never_runs_silently_on_cpu(ckpt, rng):
    movie = _movie(rng, np.uint8, (1, 32, 32))
    if torch.cuda.is_available():
        assert Predict(movie, None, ckpt, resize_dim=(32, 32),
                       show_progress=False).engine.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Predict(movie, None, ckpt, resize_dim=(32, 32), show_progress=False)


def test_predict_later_slice_options_raise(ckpt, rng):
    movie = _movie(rng, np.uint8, (1, 32, 32))
    kw = dict(resize_dim=(32, 32), show_progress=False, device="cpu")
    # mesh= is ported: what is not a mesh is refused by name, and the mesh of
    # one (no process group) predicts what no mesh does
    from bio_image_unet_tpu_torch.parallel import get_mesh

    with pytest.raises(TypeError, match="mesh"):
        Predict(movie, None, ckpt, mesh=object(), **kw)
    np.testing.assert_array_equal(Predict(movie, None, ckpt, mesh=get_mesh(), **kw).result,
                                  Predict(movie, None, ckpt, **kw).result)
    # int8 prediction is ported: quantized=True calibrates and runs the int8 trunk
    assert Predict(movie, None, ckpt, quantized=True, **kw).engine._quant_ready
    with pytest.raises(ValueError, match="not valid"):
        Predict(movie, None, ckpt, normalization_mode="median", **kw)
