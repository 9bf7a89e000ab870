"""The port's smoke recipes (``bio_image_unet_tpu_torch.utils.test``) held
against the JAX package's (``bio_image_unet_tpu/utils/test.py``): each
recipe at one epoch, n_filter 4, on the CPU, leaves the files the JAX
recipe leaves, with the facades' default checkpoint ``out/model.ckpt``
that the JAX package loads, and a prediction of the same shape and dtype.

The recipes' names start with ``test_``, so they are imported as a module
and never by name (pytest would collect them).  The JAX recipes compile,
so the five families are spread over this file, ``test_torch_recipes3d.py``
and ``test_torch_recipes_heads.py``."""

from __future__ import annotations

import os
import re

import numpy as np
import pytest

from bio_image_unet_tpu import checkpoint as jcheckpoint
from bio_image_unet_tpu.utils import test as jrecipes
from bio_image_unet_tpu_torch import checkpoint
from bio_image_unet_tpu_torch.data import tiff
from bio_image_unet_tpu_torch.utils import test as recipes
from torch_parity import jit_init

MODEL_NAME = {"unet": "Unet", "siam_unet": "Siam_UNet", "unet3d": "UNet3D",
              "multi_output_unet": "MultiOutputNestedUNet",
              "multi_output_unet3d": "MultiOutputUnet3D"}


def _files(base) -> list:
    """Every file under ``base``, relative; TensorBoard event files named
    without their time stamp and host."""
    out = []
    for root, _, names in os.walk(base):
        for name in names:
            rel = os.path.relpath(os.path.join(root, name), base)
            out.append(re.sub(r"events\.out\.tfevents\..*$", "events.out.tfevents", rel))
    return sorted(out)


def check_recipe(family: str, tmp_path) -> None:
    """The port's recipe and the JAX package's on the same family: the same
    files; ``out/model.ckpt`` read by the JAX package; the predictions alike
    in shape and dtype."""
    ours = recipes.__dict__[f"test_{family}"](base_dir=str(tmp_path / "ours"), num_epochs=1,
                                              n_filter=4, device="cpu")
    with jit_init():
        ref = jrecipes.__dict__[f"test_{family}"](base_dir=str(tmp_path / "ref"), num_epochs=1,
                                                  n_filter=4)
    assert _files(ours) == _files(ref)
    ckpt = os.path.join(ours, "out", "model.ckpt")
    state = jcheckpoint.load(ckpt)
    assert state["hyperparams"]["model_name"] == MODEL_NAME[family]
    assert state["hyperparams"] == checkpoint.peek(ckpt)["hyperparams"]
    preds = [f for f in _files(ref) if f.startswith(("pred", "results"))]
    assert preds
    for rel in preds:
        a, b = tiff.imread(os.path.join(ours, rel)), tiff.imread(os.path.join(ref, rel))
        assert a.shape == b.shape and a.dtype == b.dtype, (rel, a.shape, b.shape)
        assert np.isfinite(a.astype(np.float64)).all()
    recipes.delete_folder_with_retry(ours)
    assert not os.path.exists(ours)


@pytest.mark.parametrize("family", ["unet", "siam_unet"])
def test_recipe_matches_jax(family, tmp_path):
    check_recipe(family, tmp_path)
