"""The port's streaming Siam predictor (``bio_image_unet_tpu_torch.siam_unet
.Predict``) held against the JAX ``PredictSiam`` on the same reference
``.pt`` (float32 on both sides, the port on the CPU).

The checkpoints are drawn in the port with random BatchNorm statistics, read
by the JAX package's ``.pt`` reader and written back by its
``export_torch_checkpoint`` (``torch_parity.write_seeded_checkpoint``).

Contract port vs JAX, path for path: at most one uint8 level on at most 0.1%
of pixels.  Port fused vs port host-staged: the contract the JAX package
holds between its own two paths (< 1% of pixels beyond one level, max 16).
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from bio_image_unet_tpu.data import tiff as jtiff
from bio_image_unet_tpu.predict import PredictSiam as JPredictSiam
from bio_image_unet_tpu_torch import siam_unet
from bio_image_unet_tpu_torch.data import tiff
from bio_image_unet_tpu_torch.predict import predictor
from torch_parity import assert_u8_contract, write_seeded_checkpoint

REPO = Path(__file__).resolve().parent.parent
MODES = ("max", "concat", "corr", "control")


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("siam_pt")
    return {mode: write_seeded_checkpoint(root, mode, "Siam_UNet", 10 + seed, n_filter=4,
                                          mode=mode)[0]
            for seed, mode in enumerate(MODES)}


def _movie(rng, dtype, shape):
    if dtype == np.float32:
        return (rng.random(shape) * 600 - 100).astype(np.float32)
    top = 255 if dtype == np.uint8 else 50000
    base = rng.integers(0, top // 2, shape, endpoint=True)
    # a bright blob that moves, so the twin encoder sees structure and motion
    yy, xx = np.mgrid[: shape[1], : shape[2]]
    blob = np.stack([((yy - shape[1] / 2) ** 2 + (xx - shape[2] / 3 - i) ** 2)
                     < (min(shape[1:]) / 4) ** 2 for i in range(shape[0])])
    return (base + blob * (top // 2)).astype(dtype)


def _write(tmp_path, movie, name="movie.tif"):
    path = str(tmp_path / name)
    tiff.imwrite(path, movie)
    return path


def _both(tmp_path, src, ckpt, tag, **kw):
    """(port, JAX) results of one call each, read back from their TIFFs."""
    kw = dict(show_progress=False, batch_size=4, **kw)
    ours, ref = str(tmp_path / f"{tag}_port.tif"), str(tmp_path / f"{tag}_jax.tif")
    siam_unet.Predict(src, ours, ckpt, device="cpu", **kw)
    JPredictSiam(src, ref, ckpt, **kw)
    return tiff.imread(ours), jtiff.imread(ref)


def _fused_and_host(tmp_path, src, ckpt, shape, fused_kw=None, **kw):
    t_fused, j_fused = _both(tmp_path, src, ckpt, "fused", **(fused_kw or {}), **kw)
    t_host, j_host = _both(tmp_path, src, ckpt, "host", device_pipeline=False, **kw)
    want = shape if shape[0] > 1 else shape[1:]
    assert t_fused.shape == want and t_fused.dtype == np.uint8
    assert_u8_contract(t_fused, j_fused)
    assert_u8_contract(t_host, j_host)
    # the port's two paths, as the JAX package holds its own two
    diff = np.abs(t_fused.astype(int) - t_host.astype(int))
    assert np.mean(diff > 1) < 0.01 and diff.max() <= 16, diff.max()
    return t_fused, t_host


@pytest.mark.parametrize("mode", MODES)
def test_each_join_matches_jax(tmp_path, ckpts, mode):
    """Every join, fused and host-staged: 7 frames of 48² in 32² tiles
    (overlapping grid), chunks of 3 (a tail chunk of 1)."""
    movie = _movie(np.random.default_rng(1), np.uint8, (7, 48, 48))
    _fused_and_host(tmp_path, _write(tmp_path, movie), ckpts[mode], movie.shape,
                    resize_dim=(32, 32), frames_per_chunk=3)


CASES = [
    # name, dtype, movie shape, tile, add_tile, normalization_mode, invert, frames_per_chunk
    ("u16-first-overlap", np.uint16, (5, 48, 40), 32, 1, "first", False, 2),
    ("f32-all-exact", np.float32, (4, 64, 64), 32, 0, "all", False, 3),
    ("u8-all-invert", np.uint8, (5, 64, 64), 32, 0, "all", True, 8),
    ("u16-single-zero-pad", np.uint16, (7, 20, 40), 32, 0, "single", False, 3),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_dtypes_modes_and_grids_match_jax(tmp_path, ckpts, case):
    name, dtype, shape, tile, add, mode, invert, fpc = case
    movie = _movie(np.random.default_rng(len(name)), dtype, shape)
    # float pages are fused only on request, as in JAX
    fused_kw = {"device_pipeline": True} if dtype == np.float32 else {}
    _fused_and_host(tmp_path, _write(tmp_path, movie), ckpts["max"], shape, fused_kw,
                    resize_dim=(tile, tile), add_tile=add, normalization_mode=mode,
                    invert=invert, frames_per_chunk=fpc)


def test_one_frame_movie_whole_frame_tiles_and_chunks_of_one(tmp_path, ckpts, monkeypatch):
    """A 1-frame movie pairs frame 0 with itself; ``resize_dim=None`` tiles
    the whole frame; ``frames_per_chunk=1`` decodes page 1 once (it is frame
    0's prev and then frame 1), on both paths."""
    rng = np.random.default_rng(5)
    single = _write(tmp_path, _movie(rng, np.uint8, (1, 32, 32)), "single.tif")
    _fused_and_host(tmp_path, single, ckpts["concat"], (1, 32, 32), resize_dim=None)

    movie = _movie(rng, np.uint8, (4, 32, 32))
    src = _write(tmp_path, movie)
    decoded = []
    read_page = tiff.TiffReader.read_page

    def counting(self, index):
        decoded.append(index)
        return read_page(self, index)

    monkeypatch.setattr(tiff.TiffReader, "read_page", counting)
    for pipeline in (None, False):
        decoded.clear()
        out = str(tmp_path / f"fpc1_{pipeline}.tif")
        siam_unet.Predict(src, out, ckpts["max"], resize_dim=(32, 32), frames_per_chunk=1,
                          device_pipeline=pipeline, show_progress=False, device="cpu")
        assert sorted(decoded) == [0, 1, 2, 3], (pipeline, decoded)
        ref = str(tmp_path / f"fpc1_jax_{pipeline}.tif")
        JPredictSiam(src, ref, ckpts["max"], resize_dim=(32, 32), frames_per_chunk=1,
                     device_pipeline=pipeline, show_progress=False)
        assert_u8_contract(tiff.imread(out), jtiff.imread(ref))


def test_nan_page_flushes_finished_chunks_and_raises(tmp_path, ckpts):
    """The opt-in fused float path: a NaN page met mid-stream leaves the
    finished chunks in the output and names the page; page 1 is named when
    it served as frame 0's prev."""
    rng = np.random.default_rng(6)
    movie = _movie(rng, np.float32, (7, 32, 32))
    clean = str(tmp_path / "clean.tif")
    kw = dict(resize_dim=(32, 32), device_pipeline=True, show_progress=False, device="cpu")
    siam_unet.Predict(_write(tmp_path, movie, "clean_in.tif"), clean, ckpts["max"],
                      frames_per_chunk=3, **kw)
    movie[4, 5, 6] = np.nan
    out = str(tmp_path / "nan.tif")
    with pytest.raises(ValueError, match=r"NaN in page\(s\) 4: .*the first 3 result pages"):
        siam_unet.Predict(_write(tmp_path, movie), out, ckpts["max"], frames_per_chunk=3, **kw)
    np.testing.assert_array_equal(tiff.imread(out), tiff.imread(clean)[:3])

    movie = _movie(rng, np.float32, (3, 32, 32))
    movie[1, 0, 0] = np.nan
    with pytest.raises(ValueError, match=r"NaN in page\(s\) 1: .*the first 0 result pages"):
        siam_unet.Predict(_write(tmp_path, movie, "nan1.tif"), str(tmp_path / "nan1_out.tif"),
                          ckpts["max"], frames_per_chunk=1, **kw)
    # NaN in page 0: the fused path is declined with the reason, the host path runs
    movie[0, 0, 0] = np.nan
    with pytest.warns(UserWarning, match="page 0 contains NaNs"):
        siam_unet.Predict(_write(tmp_path, movie, "nan0.tif"), str(tmp_path / "nan0_out.tif"),
                          ckpts["max"], frames_per_chunk=1, **kw)
    assert tiff.imread(str(tmp_path / "nan0_out.tif")).shape == (3, 32, 32)


def test_bigtiff_switch(tmp_path, ckpts, monkeypatch):
    """Past classic TIFF's 4 GiB the output is a BigTIFF (the limit lowered
    here): the same pages, read back by both packages' readers."""
    movie = _movie(np.random.default_rng(7), np.uint8, (3, 32, 32))
    src = _write(tmp_path, movie)
    kw = dict(resize_dim=(32, 32), show_progress=False, device="cpu")
    classic, big = str(tmp_path / "classic.tif"), str(tmp_path / "big.tif")
    siam_unet.Predict(src, classic, ckpts["corr"], **kw)
    monkeypatch.setattr(predictor, "_CLASSIC_TIFF_BYTES", 3 * (32 * 32 + 256) - 1)
    siam_unet.Predict(src, big, ckpts["corr"], **kw)
    with open(classic, "rb") as fh:
        assert fh.read(4) == b"II*\x00"
    with open(big, "rb") as fh:
        assert fh.read(4) == b"II+\x00"
    np.testing.assert_array_equal(tiff.imread(big), tiff.imread(classic))
    np.testing.assert_array_equal(jtiff.imread(big), tiff.imread(classic))


def test_narrow_movie_writes_one_page_per_frame(tmp_path, ckpts):
    """Frames at most 8 pixels wide: each chunk goes out as one page per
    frame, not as one multi-channel page, on both paths."""
    movie = _movie(np.random.default_rng(9), np.uint8, (5, 24, 8))
    src = str(tmp_path / "narrow.tif")
    with tiff.TiffWriter(src) as writer:
        for frame in movie:
            writer.write(frame)
    kw = dict(resize_dim=(16, 16), frames_per_chunk=3, show_progress=False, device="cpu")
    res = {}
    for pipeline in (None, False):
        out = str(tmp_path / f"narrow_{pipeline}.tif")
        siam_unet.Predict(src, out, ckpts["max"], device_pipeline=pipeline, **kw)
        with tiff.TiffReader(out) as reader:
            assert reader.n_pages == 5 and reader.page_shape(0)[:2] == (24, 8)
        res[pipeline] = tiff.imread(out)
        assert res[pipeline].shape == (5, 24, 8) and res[pipeline].dtype == np.uint8
    diff = np.abs(res[None].astype(int) - res[False].astype(int))
    assert np.mean(diff > 1) < 0.01 and diff.max() <= 16, diff.max()


def test_device_rule_and_refusals(tmp_path, ckpts):
    src = _write(tmp_path, _movie(np.random.default_rng(8), np.uint8, (2, 32, 32)))
    out = str(tmp_path / "out.tif")
    kw = dict(resize_dim=(32, 32), show_progress=False)
    if torch.cuda.is_available():
        assert siam_unet.Predict(src, out, ckpts["max"], **kw).engine.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            siam_unet.Predict(src, out, ckpts["max"], **kw)
    from bio_image_unet_tpu_torch.parallel import get_mesh

    with pytest.raises(TypeError, match="mesh"):
        siam_unet.Predict(src, out, ckpts["max"], mesh=object(), device="cpu", **kw)
    siam_unet.Predict(src, out, ckpts["max"], device="cpu", **kw)
    plain = tiff.imread(out)
    siam_unet.Predict(src, out, ckpts["max"], mesh=get_mesh(), device="cpu", **kw)
    np.testing.assert_array_equal(tiff.imread(out), plain)
    # int8 prediction of the max join is ported
    assert siam_unet.Predict(src, out, ckpts["max"], quantized=True, device="cpu",
                             **kw).engine._quant_ready
    with pytest.raises(ValueError, match="not valid"):
        siam_unet.Predict(src, out, ckpts["max"], normalization_mode="median", device="cpu", **kw)
    # Siam training is ported: the facade's DataProcess and Trainer are the
    # pair pipeline and the generic Trainer with a join
    from bio_image_unet_tpu_torch.data.pipelines import DataProcessSiam
    from bio_image_unet_tpu_torch.train import Trainer

    assert siam_unet.DataProcess is DataProcessSiam
    assert issubclass(siam_unet.Trainer, Trainer)


def test_siam_modules_import_and_predict_without_jax(tmp_path):
    """``bio_image_unet_tpu_torch.siam_unet`` imports, and a CPU
    ``Predict`` runs, with JAX, flax, optax, ml_dtypes and the JAX package
    made unimportable (names matched exactly or followed by '.')."""
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
        from bio_image_unet_tpu_torch import siam_unet
        from bio_image_unet_tpu_torch.data import tiff
        from bio_image_unet_tpu_torch.ops.blocks import init_weights_
        net = init_weights_(siam_unet.Siam_UNet(n_filter=4, mode="corr"),
                            torch.Generator().manual_seed(0), True)
        ckpt = {str(tmp_path)!r} + "/siam.pt"
        torch.save({{"state_dict": net.state_dict(), "model_name": "Siam_UNet",
                    "n_filter": 4, "mode": "corr"}}, ckpt)
        src, out = {str(tmp_path)!r} + "/movie.tif", {str(tmp_path)!r} + "/out.tif"
        tiff.imwrite(src, np.random.default_rng(0).integers(0, 255, (3, 40, 36), np.uint8))
        siam_unet.Predict(src, out, ckpt, resize_dim=(32, 32), show_progress=False,
                          device="cpu")
        res = tiff.imread(out)
        assert res.shape == (3, 40, 36) and res.dtype == np.uint8
        leaked = sorted(n for n in sys.modules if sys.modules[n] is not None and
                        any(n == b or n.startswith(b + ".") for b in BLOCKED))
        assert not leaked, leaked
        print("OK")
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("OK"), proc.stderr[-3000:]
