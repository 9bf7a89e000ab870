"""The port's host surface held against the JAX package on the same seeded
inputs: ``tools`` (sysinfo, frame search, image operations, movie export,
the annotator's gate), ``utils`` (metrics, ``png_to_grayscale_tiff``), the
256-bin histogram oracle of ``ops.histogram`` (B3), the ``ops`` and
``interop`` names that complete the package surface, and the two packages'
``__all__`` per subpackage."""

from __future__ import annotations

import importlib
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bio_image_unet_tpu import tools as jtools
from bio_image_unet_tpu import utils as jutils
from bio_image_unet_tpu.interop import torch_export as jexport
from bio_image_unet_tpu.ops import functional as jfunctional
from bio_image_unet_tpu.ops import histogram as jhist
from bio_image_unet_tpu.ops import stitch as jstitch
from bio_image_unet_tpu_torch import tools, utils
from bio_image_unet_tpu_torch.data import tiff
from bio_image_unet_tpu_torch.ops import functional, histogram
from bio_image_unet_tpu_torch.ops import stitch as tstitch
from bio_image_unet_tpu_torch.utils.kernel_ab_times import microscopy_frames
from torch_parity import write_seeded_checkpoint  # noqa: F401  (one torch thread)

# names of the JAX package that the port does not have (yet), by subpackage:
# JAX-only helpers, the flax modules of ops that have no torch counterpart,
# and the multi-device surface that the multi-device slice ports
# (predict.sharded here; parallel and testing are not compared until then)
JAX_ONLY = {
    "models": {"UNet2DBase"},
    "ops": {"FirstVGGBlock", "TorchBatchNorm"},
    "predict": {"predict_frames_spatial_sharded", "predict_volume_spatial_sharded"},
    "utils": {"enable_compilation_cache", "init_weights"},
}
SUBPACKAGES = ["", "checkpoint", "data", "interop", "losses", "models", "ops", "predict",
               "progress", "train", "tools", "utils", "unet", "siam_unet", "unet3d",
               "multi_output_unet", "multi_output_unet3d"]


@pytest.mark.parametrize("sub", SUBPACKAGES, ids=[s or "top" for s in SUBPACKAGES])
def test_port_exports_every_name_of_the_jax_package(sub):
    suffix = f".{sub}" if sub else ""
    ref = importlib.import_module("bio_image_unet_tpu" + suffix)
    ours = importlib.import_module("bio_image_unet_tpu_torch" + suffix)
    missing = set(ref.__all__) - set(ours.__all__) - JAX_ONLY.get(sub, set())
    assert not missing, sorted(missing)
    for name in ours.__all__:
        assert hasattr(ours, name), name


# --- tools.sysinfo ---------------------------------------------------------------

def _tree(root):
    (root / "a" / "empty").mkdir(parents=True)
    (root / "a" / "x.bin").write_bytes(bytes(range(256)) * 9)
    (root / "b.txt").write_text("provenance\n")
    os.symlink("b.txt", root / "link")
    os.symlink("nowhere", root / "dangling")


def test_sysinfo_matches_jax(tmp_path, monkeypatch, capsys):
    _tree(tmp_path / "t")
    assert tools.cpu_count() == jtools.cpu_count()
    f = str(tmp_path / "t" / "a" / "x.bin")
    assert tools.md5sum(f) == jtools.md5sum(f) == tools.md5sum(f, chunk_size=7)
    assert tools.md5sum_folder(tmp_path / "t") == jtools.md5sum_folder(tmp_path / "t")
    monkeypatch.setenv("SLURM_JOB_ID", "4242")
    for mod in (sys.modules[tools.sysinfo.__name__], sys.modules[jtools.sysinfo.__name__]):
        monkeypatch.setattr(mod.time, "strftime", lambda fmt: "2026-01-02 03:04:05")
    assert tools.get_info_file_header("job") == jtools.get_info_file_header("job")
    tools.write_info_file(tmp_path / "ours.txt", "job", extra="note")
    jtools.write_info_file(tmp_path / "ref.txt", "job", extra="note")
    assert (tmp_path / "ours.txt").read_bytes() == (tmp_path / "ref.txt").read_bytes()
    assert b"SLURM_JOB_ID: 4242" in (tmp_path / "ours.txt").read_bytes()

    capsys.readouterr()
    found = tools.device_test(verbose=True)
    out = capsys.readouterr().out
    if torch.cuda.is_available():
        assert [d["name"] for d in found] == [torch.cuda.get_device_name(i)
                                            for i in range(torch.cuda.device_count())]
    else:  # no card: nothing listed, the CPU included
        assert found == [] and "no CUDA device" in out


# --- utils ---------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["prob", "u8", "u16", "tensor", "bf16"])
def test_metrics_match_jax(kind):
    rng = np.random.default_rng(3)
    pred, target = rng.random((2, 37, 41)), rng.random((2, 37, 41)) > 0.6
    if kind == "u8":
        pred, target = (pred * 255).astype(np.uint8), target.astype(np.uint8) * 255
    elif kind == "u16":
        pred = (pred * 65535).astype(np.uint16)
    ref = [f(pred, target) for f in (jutils.iou, jutils.dice_coefficient, jutils.pixel_accuracy)]
    if kind in ("tensor", "bf16"):
        pred = torch.from_numpy(pred.astype(np.float32))
        target = torch.from_numpy(target)
        if kind == "bf16":
            pred = pred.to(torch.bfloat16)
            ref = [f(pred.float().numpy(), target.numpy())
                   for f in (jutils.iou, jutils.dice_coefficient, jutils.pixel_accuracy)]
    ours = [f(pred, target) for f in (utils.iou, utils.dice_coefficient, utils.pixel_accuracy)]
    assert all(type(v) is float for v in ours)
    assert ours == ref


def test_png_to_grayscale_tiff_matches_jax(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(4)
    Image.fromarray(rng.integers(0, 200, (20, 30, 3), dtype=np.uint8)).save(tmp_path / "c.png")
    utils.png_to_grayscale_tiff(str(tmp_path / "c.png"), str(tmp_path / "ours.tif"))
    jutils.png_to_grayscale_tiff(str(tmp_path / "c.png"), str(tmp_path / "ref.tif"))
    assert (tmp_path / "ours.tif").read_bytes() == (tmp_path / "ref.tif").read_bytes()
    assert tiff.imread(str(tmp_path / "ours.tif")).max() == 255


# --- tools: frame search, image operations, movie, annotator --------------------

@pytest.fixture(scope="module")
def movies(tmp_path_factory):
    root = tmp_path_factory.mktemp("movies")
    rng = np.random.default_rng(5)
    frames = rng.integers(0, 255, (6, 24, 28), dtype=np.uint8)
    tiff.imwrite(str(root / "a.tif"), frames)
    tiff.imwrite(str(root / "b.tif"), (frames // 2 + 3).astype(np.uint8))
    tiff.imwrite(str(root / "small.tif"), frames[:, :10])
    tiff.imwrite(str(root / "3.tif"), frames[3])  # a label drawn on frame 3
    noisy = np.clip(frames[2].astype(int) + rng.integers(-4, 5, frames[2].shape), 0, 255)
    tiff.imwrite(str(root / "2.tif"), noisy.astype(np.uint8))
    return root, frames


def test_frame_search_matches_jax(movies, tmp_path, capsys):
    root, frames = movies
    assert tools.mse(frames[0], frames[1]) == jtools.mse(frames[0], frames[1])
    space = [str(root / n) for n in ("a.tif", "b.tif", "small.tif")]
    for query in ("3.tif", "2.tif"):
        out = {}
        for who, fn in (("ours", tools.find_frame_of_image), ("ref", jtools.find_frame_of_image)):
            capsys.readouterr()
            out[who] = (fn(str(root / query), space,
                           machine_readable_output_filename=str(tmp_path / f"{who}.txt")),
                        capsys.readouterr().out)
        assert out["ours"] == out["ref"]
        assert (tmp_path / "ours.txt").read_bytes() == (tmp_path / "ref.txt").read_bytes()
    src = str(root / "a.tif")
    for gen_ours, gen_ref in ((tools.frame_generator(src), jtools.frame_generator(src)),
                              (tools.fetch_frame(src), jtools.fetch_frame(src))):
        np.testing.assert_array_equal(np.stack(list(gen_ours)), np.stack(list(gen_ref)))
    for i, f in enumerate(frames[:3]):
        tiff.imwrite(str(tmp_path / f"{i}.tif"), f)
    np.testing.assert_array_equal(np.stack(list(tools.individual_tif_generator(tmp_path, 3))),
                                  np.stack(list(jtools.individual_tif_generator(tmp_path, 3))))
    assert tools.stream_write(tmp_path / "s1.tif", iter(frames)) == \
        jtools.stream_write(tmp_path / "s2.tif", iter(frames)) == len(frames)
    assert (tmp_path / "s1.tif").read_bytes() == (tmp_path / "s2.tif").read_bytes()


def test_imageops_match_jax(movies, tmp_path):
    root, frames = movies
    inputs = [str(root / "a.tif"), str(root / "b.tif")]
    tools.average_tifs(inputs, tmp_path / "avg1.tif")
    jtools.average_tifs(inputs, tmp_path / "avg2.tif")
    assert (tmp_path / "avg1.tif").read_bytes() == (tmp_path / "avg2.tif").read_bytes()
    for invert in (False, True):
        assert tools.threshold_images(root, tmp_path / f"t1{invert}", 100, invert) == \
            jtools.threshold_images(root, tmp_path / f"t2{invert}", 100, invert)
        names = sorted(os.listdir(tmp_path / f"t2{invert}"))
        assert sorted(os.listdir(tmp_path / f"t1{invert}")) == names
        for n in names:
            assert (tmp_path / f"t1{invert}" / n).read_bytes() == \
                (tmp_path / f"t2{invert}" / n).read_bytes()
    np.testing.assert_array_equal(tools.generate_plain_image((5, 7), 9, tmp_path / "p1.tif"),
                                  jtools.generate_plain_image((5, 7), 9, tmp_path / "p2.tif"))
    assert (tmp_path / "p1.tif").read_bytes() == (tmp_path / "p2.tif").read_bytes()
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError):
            tools.create_pixel_value_histogram(root / "a.tif", tmp_path / "h1")
        return
    ours = tools.create_pixel_value_histogram(root / "a.tif", tmp_path / "h1", frames_per_plot=4)
    ref = jtools.create_pixel_value_histogram(root / "a.tif", tmp_path / "h2", frames_per_plot=4)
    assert [os.path.basename(p) for p in ours] == [os.path.basename(p) for p in ref] != []
    for a, b in zip(ours, ref):
        assert open(a, "rb").read() == open(b, "rb").read()


def test_movie_commands_match_jax(movies, tmp_path, monkeypatch):
    """ffmpeg is not installed here: both packages' argv are captured, the
    private temporary directories named alike, and the frames handed to
    cv2 compared."""
    from bio_image_unet_tpu.tools import movie as jmovie
    from bio_image_unet_tpu_torch.tools import movie as tmovie

    root, frames = movies
    runs = {"ours": [], "ref": []}
    current = []  # whose calls are being made (both modules share subprocess and cv2)
    for mod in (tmovie, jmovie):
        monkeypatch.setattr(mod, "_require_ffmpeg", lambda: "ffmpeg")
    monkeypatch.setattr(tmovie.subprocess, "run",
                        lambda cmd, **kw: runs[current[-1]].append(("run", list(cmd))))
    cv2 = pytest.importorskip("cv2")
    monkeypatch.setattr(cv2, "imwrite",
                        lambda path, arr: runs[current[-1]].append(
                            ("png", os.path.basename(path), arr.copy())) or True)
    for who, mod in (("ours", tmovie), ("ref", jmovie)):
        current.append(who)
        mod.tif_to_mp4(root / "a.tif", tmp_path / "a.mp4", threshold=120, invert=True,
                       opening=True)
        mod.crop_zoom("a.mp4", "z.mp4", "100", "80")
        mod.crop_zoom("a.mp4", "z.mp4", "100", "80", "5", "7")
        for n in (2, 4, 6):
            mod.compare_videos_vstack([f"{i}.mp4" for i in range(n)], "out.mp4")
        mod.create_zoomed_in_comparison("a.mp4", "b.mp4", "64", "64",
                                        output=str(tmp_path / "cmp.mp4"))
        with pytest.raises(ValueError):
            mod.compare_videos_vstack(["a.mp4"], "out.mp4")
        written = mod.extract_frames(root / "a.tif", [1, 4], tmp_path / who)
        assert [os.path.basename(p) for p in written] == ["frame_1.tif", "frame_4.tif"]

    def normalized(calls):
        """Temporary paths (``tif2mp4_*``, ``tmp*``) replaced by their role."""
        out = []
        for call in calls:
            if call[0] == "png":
                out.append(call[:2])
                continue
            out.append(("run", [os.path.basename(a) if os.path.isabs(a) else a
                                for a in call[1]]))
        return out

    assert normalized(runs["ours"]) == normalized(runs["ref"])
    pngs = [[c[2] for c in runs[w] if c[0] == "png"] for w in ("ours", "ref")]
    assert len(pngs[0]) == len(frames)
    for a, b in zip(*pngs):
        np.testing.assert_array_equal(a, b)
    for n in ("frame_1.tif", "frame_4.tif"):
        assert (tmp_path / "ours" / n).read_bytes() == (tmp_path / "ref" / n).read_bytes()


def test_annotator_without_napari_raises_as_jax():
    errors = []
    for cls in (tools.ImageAnnotator, jtools.ImageAnnotator):
        with pytest.raises(ImportError) as info:
            cls("/nonexistent", "/nonexistent")
        errors.append(str(info.value))
    assert errors[0] == errors[1] and "napari" in errors[0]


# --- B3: the 256-bin histogram oracle ------------------------------------------------

@pytest.mark.parametrize("kind", ["uniform", "skewed", "odd"])
def test_histogram_oracle_bit_equal_to_jax_and_k1(kind):
    rng = np.random.default_rng(6)
    if kind == "uniform":
        frames = rng.integers(0, 256, (3, 64, 64), dtype=np.uint8)
    elif kind == "skewed":
        frames = microscopy_frames(301, 3, 128)[0]
    else:  # 37×53 frames: no 4096-chunk split in JAX's counts
        frames = np.clip(rng.normal(90, 30, (4, 37, 53)), 0, 255).astype(np.uint8)
    x = torch.from_numpy(frames)
    flat = x.reshape(x.shape[0], -1)
    counts = histogram.u8_counts(flat)
    assert counts.dtype == torch.int32
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jhist.u8_counts(
        jnp.asarray(frames.reshape(frames.shape[0], -1)))))
    qs = (0.0, 0.2, 50.0, 99.8, 99.98, 100.0)
    for ours, ref in zip(histogram.u8_percentile(x, qs), jhist.u8_percentile(jnp.asarray(frames),
                                                                             qs)):
        np.testing.assert_array_equal(ours.numpy().view(np.int32),
                                      np.asarray(ref).view(np.int32))
    for q_lo, q_hi in ((0.0, 99.8), (0.2, 99.98), (1.0, 99.0)):
        ours = torch.stack(histogram.u8_clip_bounds(x, q_lo, q_hi))
        ref = np.stack([np.asarray(v) for v in jhist.u8_clip_bounds(jnp.asarray(frames),
                                                                    q_lo, q_hi)])
        np.testing.assert_array_equal(ours.numpy().view(np.int32), ref.view(np.int32))
        k1 = histogram.int_clip_bounds(x, q_lo, q_hi)
        np.testing.assert_array_equal(ours.numpy().view(np.int32), k1.numpy().view(np.int32))


# --- ops and interop names of the package surface --------------------------------------

@pytest.mark.parametrize("shape,out,align", [((1, 2, 5, 7), (9, 12), False),
                                             ((1, 2, 5, 7), (9, 12), True),
                                             ((2, 1, 3, 4, 5), (6, 8, 7), False),
                                             ((2, 1, 3, 4, 5), (6, 8, 7), True)])
def test_resize_linear_matches_jax_where_no_axis_shrinks(shape, out, align):
    x = np.random.default_rng(7).standard_normal(shape).astype(np.float32)
    ours = functional.resize_linear(torch.from_numpy(x), out, align_corners=align).numpy()
    ref = np.moveaxis(np.asarray(jfunctional.resize_linear(jnp.asarray(np.moveaxis(x, 1, -1)),
                                                           out, align)), -1, 1)
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("quantize", [False, True])
def test_stitch_mean_device_matches_jax(quantize):
    rng = np.random.default_rng(8)
    starts = (np.array([0, 10, 20]), np.array([0, 12]))
    patches = (rng.random((6, 16, 20, 2)) * 255).astype(np.float32)
    ours = tstitch.stitch_mean_device(patches, starts, (36, 32), quantize_u8=quantize)
    ref = np.asarray(jstitch.stitch_mean_device(patches, starts, (36, 32), quantize_u8=quantize))
    assert ours.dtype == (torch.uint8 if quantize else torch.float32)
    np.testing.assert_array_equal(ours.numpy(), ref)


@pytest.mark.parametrize("registry", ["Unet", "UNet3D"])
def test_variables_to_torch_state_dict_and_final_sequential(tmp_path, registry):
    from bio_image_unet_tpu_torch import checkpoint
    from bio_image_unet_tpu_torch.interop import (export_torch_checkpoint,
                                                  variables_to_torch_state_dict)

    path, variables = write_seeded_checkpoint(tmp_path, registry, registry, 9)
    for flag in (True, False):
        ours, ref = (variables_to_torch_state_dict(variables, flag),
                     jexport.variables_to_torch_state_dict(variables, flag))
        assert sorted(ours) == sorted(ref)
        for key, value in ref.items():
            assert isinstance(ours[key], np.ndarray)
            np.testing.assert_array_equal(ours[key], value, err_msg=key)
        export_torch_checkpoint(str(tmp_path / f"{flag}.pt"), variables, epoch=1,
                                final_sequential=flag)
        assert sorted(checkpoint.load(str(tmp_path / f"{flag}.pt"))["state_dict"]) == sorted(ref)
    bare = registry == "UNet3D"  # None: the bare 3D final by its kernel's rank
    assert sorted(variables_to_torch_state_dict(variables)) == \
        sorted(jexport.variables_to_torch_state_dict(variables, not bare))
