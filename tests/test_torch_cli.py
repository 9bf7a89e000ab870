"""The port's command line (``python -m bio_image_unet_tpu_torch``) held
against the JAX package's (``bio_image_unet_tpu/__main__.py``).

One argv a family trains a tiny model on the CPU (``--device cpu``, n_filter
4, 32² tiles or 8×16² volumes, one epoch).  The ``BIUTPU01`` file it leaves
at ``<workdir>/model/model.ckpt`` is read by the JAX package; for ``unet``
its hyperparams equal those the JAX CLI's Trainer records for the same argv.
``predict`` with the family read from the checkpoint writes what the JAX
CLI's ``predict`` writes on the same checkpoint and input (the same files,
shapes and dtypes; for ``unet`` masks within one level on ≤ 0.1% of pixels).
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

from bio_image_unet_tpu import checkpoint as jcheckpoint
from bio_image_unet_tpu.__main__ import main as jmain
from bio_image_unet_tpu_torch import checkpoint
from bio_image_unet_tpu_torch.__main__ import _detect_family, main
from bio_image_unet_tpu_torch.data import tiff
from bio_image_unet_tpu_torch.interop import torch_state_dict_to_variables
from bio_image_unet_tpu_torch.models import get_model
from bio_image_unet_tpu_torch.utils.synth import blob_sample
from torch_parity import assert_u8_contract, jit_init

REPO = Path(__file__).resolve().parents[1]
COMMON = ["--epochs", "1", "--n-filter", "4", "--batch-size", "2", "--aug-factor", "2"]
# family → (train argv, predict input, predict argv)
FAMILIES = {
    "unet": (["--image-dir", "u/image", "--label-dir", "u/label", "--dim", "32", "32"],
             "movie.tif", ["--resize-dim", "32", "32"]),
    "siam_unet": (["--image-dir", "s/image", "--label-dir", "s/label", "--dim", "32", "32"],
                  "movie.tif", ["--resize-dim", "32", "32"]),
    "unet3d": (["--image-dir", "v/vol", "--label-dir", "v/label", "--dim", "8", "16", "16"],
               "vol.tif", ["--resize-dim", "8", "16", "16"]),
    "multi_output_unet": (["--image-dir", "m/image", "--target-dir", "m/mask",
                           "--dim", "32", "32"], "img.tif", []),
    "multi_output_unet3d": (["--image-dir", "w/vol", "--target-dir", "w/mask",
                             "--dim", "8", "16", "16"], "vol.tif", []),
}
MODEL_NAME = {"unet": "Unet", "siam_unet": "Siam_UNet", "unet3d": "UNet3D",
              "multi_output_unet": "MultiOutputNestedUNet",
              "multi_output_unet3d": "MultiOutputUnet3D"}


def _write_data(root: Path) -> None:
    rng = np.random.default_rng(0)

    def put(rel, arr):
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        tiff.imwrite(str(path), arr)

    for i in range(6):
        img, mask = blob_sample(rng, (32, 32))
        put(f"u/image/{i}.tif", img)
        put(f"u/label/{i}.tif", mask)
        put(f"s/image/{i}.tif", rng.integers(0, 255, (32, 64), dtype=np.uint8))  # W-doubled pair
        put(f"s/label/{i}.tif", mask)
        put(f"m/image/{i}.tif", img)
        put(f"m/mask/{i}.tif", (mask > 0).astype(np.float32))
    for i in range(2):
        vol = rng.integers(0, 255, (8, 32, 32), dtype=np.uint8)
        mask = rng.random((8, 32, 32)) > 0.5
        put(f"v/vol/{i}.tif", vol)
        put(f"v/label/{i}.tif", mask.astype(np.uint8) * 255)
        put(f"w/vol/{i}.tif", vol)
        put(f"w/mask/{i}.tif", mask.astype(np.float32))
    put("movie.tif", rng.integers(0, 255, (2, 64, 64), dtype=np.uint8))
    put("vol.tif", rng.integers(0, 255, (8, 32, 32), dtype=np.uint8))
    put("img.tif", rng.integers(0, 255, (64, 64), dtype=np.uint8))


def _output(root: Path, family: str, who: str) -> str:
    return str(root / (f"{who}_{family}" + ("" if family.startswith("multi") else ".tif")))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every family trained and predicted through the port's CLI (the
    family of ``predict`` read from the checkpoint), in one directory; the
    printed lines of each ``train``."""
    root = tmp_path_factory.mktemp("cli")
    _write_data(root)
    cwd = os.getcwd()
    os.chdir(root)
    printed = {}
    try:
        for family, (train_argv, src, predict_argv) in FAMILIES.items():
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert main(["train", "--family", family, "--workdir", f"run_{family}",
                             "--device", "cpu"] + train_argv + COMMON) == 0
                assert main(["predict", "--input", src, "--output",
                             _output(root, family, "port"), "--checkpoint",
                             f"run_{family}/model/model.ckpt", "--device", "cpu"]
                            + predict_argv) == 0
            printed[family] = buf.getvalue().splitlines()
    finally:
        os.chdir(cwd)
    return root, printed


def _leaves(tree, path=()) -> dict:
    if not isinstance(tree, dict):
        return {path: np.asarray(tree)}
    return {k: v for name, sub in tree.items() for k, v in _leaves(sub, path + (name,)).items()}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_train_writes_a_ckpt_the_jax_package_reads(runs, family):
    root, printed = runs
    ckpt = root / f"run_{family}" / "model" / "model.ckpt"
    assert f"checkpoint: run_{family}/model/model.ckpt" in printed[family]
    assert any(line.startswith("best validation loss: ") for line in printed[family])
    with open(ckpt, "rb") as fh:
        assert fh.read(8) == b"BIUTPU01"
    head = jcheckpoint.peek(str(ckpt))
    assert head == checkpoint.peek(str(ckpt))
    state = jcheckpoint.load(str(ckpt))
    hyper = state["hyperparams"]
    assert hyper["model_name"] == MODEL_NAME[family] and hyper["n_filter"] == 4
    assert state["epoch"] == 1 and np.isfinite(state["best_loss"])
    # the JAX tree holds every weight of the port's model, unchanged
    ours = checkpoint.load(str(ckpt))["state_dict"]
    get_model(hyper["model_name"], **hyper).load_state_dict(ours, strict=True)
    mine, theirs = _leaves(torch_state_dict_to_variables(ours)), _leaves(state["variables"])
    assert set(mine) == set(theirs)
    for key, value in mine.items():
        np.testing.assert_array_equal(value, theirs[key], err_msg=str(key))


def test_unet_hyperparams_equal_the_jax_clis(runs, tmp_path, monkeypatch):
    """The JAX CLI with the same argv: its Trainer's recorded hyperparams
    (taken in place of its training run) equal the port's checkpoint's."""
    from bio_image_unet_tpu.train import trainer as jtrainer

    root, _ = runs
    seen = {}

    def record(self, *args, **kw):
        seen.update(json.loads(json.dumps(jcheckpoint._jsonable(self.params_meta))))
        return 0.0

    monkeypatch.setattr(jtrainer.Trainer, "start", record)
    monkeypatch.chdir(root)
    train_argv = FAMILIES["unet"][0]
    with jit_init():
        assert jmain(["train", "--family", "unet", "--workdir", str(tmp_path / "jax")]
                     + train_argv + COMMON) == 0
    ours = checkpoint.peek(str(root / "run_unet" / "model" / "model.ckpt"))["hyperparams"]
    ours.pop("scheduler_state")
    assert ours == seen


@pytest.mark.parametrize("family", list(FAMILIES))
def test_predict_writes_what_the_jax_cli_writes(runs, family, monkeypatch):
    root, _ = runs
    _, src, predict_argv = FAMILIES[family]
    monkeypatch.chdir(root)
    ours, ref = _output(root, family, "port"), _output(root, family, "jax")
    assert jmain(["predict", "--input", src, "--output", ref, "--checkpoint",
                  f"run_{family}/model/model.ckpt"] + predict_argv) == 0
    if family.startswith("multi"):
        assert sorted(os.listdir(ours)) == sorted(os.listdir(ref)) != []
        pairs = [(os.path.join(ours, f), os.path.join(ref, f)) for f in os.listdir(ref)]
    else:
        pairs = [(ours, ref)]
    for a, b in pairs:
        a, b = tiff.imread(a), tiff.imread(b)
        assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, a.dtype, b.shape, b.dtype)
        assert np.isfinite(a.astype(np.float64)).all()
        if family == "unet":
            assert_u8_contract(a.astype(np.uint8), b.astype(np.uint8))
            np.testing.assert_array_equal(a, a.astype(np.uint8))


def test_devices_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    assert main(["devices"]) == 1
    assert "no CUDA device" in capsys.readouterr().out


def test_train_and_predict_need_the_card_unless_asked_for_the_cpu(runs):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    root, _ = runs
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["train", "--workdir", str(root / "nocard")] + FAMILIES["unet"][0] + COMMON)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["predict", "--input", str(root / "movie.tif"), "--output",
              str(root / "nocard.tif"), "--checkpoint",
              str(root / "run_unet" / "model" / "model.ckpt")])
    assert not (root / "nocard").exists() and not (root / "nocard.tif").exists()


def test_quantized_help_quotes_no_speed_ratio(capsys):
    with pytest.raises(SystemExit):
        main(["predict", "--help"])
    text = " ".join(capsys.readouterr().out.split())
    start = text.rindex("--quantized")  # the option's entry, after the usage line
    help_text = text[start:text.index("--device", start)]
    assert "BIU_INT8_EXPERIMENTAL=1" in help_text
    assert not re.search(r"\d(\.\d+)?\s*x\b", help_text), help_text


def test_python_dash_m_entry():
    """The one subprocess: ``python -m bio_image_unet_tpu_torch --help``."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-m", "bio_image_unet_tpu_torch", "--help"],
                          cwd=str(REPO), env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "{train,predict,devices}" in proc.stdout


def _truncate_records(src: str, dst: str) -> None:
    """Copy a zip-format ``.pt`` with every tensor record cut to 4 bytes."""
    with zipfile.ZipFile(src) as zin, zipfile.ZipFile(dst, "w") as zout:
        for info in zin.infolist():
            data = zin.read(info.filename)
            if "/data/" in info.filename and not info.filename.endswith("serialization_id"):
                data = data[:4]
            zout.writestr(info, data)


def test_peek_of_a_pt_reads_no_weight_bytes(tmp_path):
    """``peek`` of a ``.pt`` maps it onto the meta device: on a file whose
    tensor records are truncated it succeeds where ``load`` fails, and the
    CLI's family detection works on it.  A legacy (pre-zip) ``.pt`` raises
    ``ValueError`` in ``peek``, and the detection falls back to ``load``."""
    net = get_model("UNet3D", n_filter=4)
    hyper = {"model_name": "UNet3D", "n_filter": 4}
    full, cut = str(tmp_path / "full.pt"), str(tmp_path / "cut.pt")
    checkpoint.save(full, net.state_dict(), hyper, epoch=2, best_loss=0.25)
    _truncate_records(full, cut)
    assert checkpoint.peek(cut) == checkpoint.peek(full) == {
        "hyperparams": {**hyper, "epoch": 2, "best_loss": 0.25}, "epoch": 2, "best_loss": 0.25}
    with pytest.raises(ValueError):
        checkpoint.load(cut)
    assert _detect_family(cut) == "unet3d"

    legacy = str(tmp_path / "legacy.pt")
    torch.save({"state_dict": net.state_dict(), **hyper}, legacy,
               _use_new_zipfile_serialization=False)
    with pytest.raises(ValueError):
        checkpoint.peek(legacy)
    assert _detect_family(legacy) == "unet3d"
