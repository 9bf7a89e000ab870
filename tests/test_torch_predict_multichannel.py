"""``Predict`` on a ``Unet`` with ``out_channels != 1``, and K3 over C channels
(K3c), held against the JAX package on the CPU.

- K3c's plain version (``ops.stitch.sigmoid_stitch_plain`` on (n, C, th, tw)
  logits) equals JAX's ``ops/stitch.py:80 stitch_mean_frames_device(...,
  quantize_u8=True)`` bit for bit on the same per-tile uint8 levels, for C = 2
  and 3, on exact and overlapping grids; its one-channel form equals the K3
  plain version the port had before K3c, and each channel of a C-channel
  call equals a one-channel call on that channel alone;
- ``Predict`` of a seeded ``Unet(4, out_channels=2)`` ``.pt`` gives JAX's
  ``Predict`` (host-staged: JAX's fused blocker) masks of shape (N, C, H, W)
  within one uint8 level on at most 0.1% of pixels, the saved float16 TIFF
  reads back as JAX's does, and ``device_pipeline=True`` / ``quantized=True``
  warn with JAX's texts.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bio_image_unet_tpu.data import tiff as jtiff
from bio_image_unet_tpu.interop.torch_export import export_torch_checkpoint
from bio_image_unet_tpu.models import Unet as JUnet
from bio_image_unet_tpu.ops.stitch import stitch_mean_frames_device
from bio_image_unet_tpu.predict import Predict as JPredict
from bio_image_unet_tpu_torch.ops.stitch import sigmoid_stitch, sigmoid_stitch_plain
from bio_image_unet_tpu_torch.predict import Predict
from bio_image_unet_tpu_torch.predict.tiling import TilePlan, grid_starts
from torch_parity import assert_u8_contract

N_FILTER, OUT_CH = 4, 2


def _k3_plain_one_channel(logits, n_frames, plan):
    """K3's plain version as the port had it before K3c (one channel only)."""
    th, tw = plan.th, plan.tw
    tiles = (logits[:, 0] if logits.dim() == 4 else logits)[: n_frames * plan.per_frame]
    u8 = (torch.sigmoid(tiles.float()) * 255.0).to(torch.uint8)
    framed = u8.reshape(n_frames, plan.nx, plan.ny, th, tw)
    if plan.exact:
        out = framed.permute(0, 1, 3, 2, 4).reshape(n_frames, plan.nx * th, plan.ny * tw)
        return out[:, : plan.h, : plan.w].contiguous()
    out_h, out_w = max(th, plan.h), max(tw, plan.w)
    acc = torch.zeros((n_frames, out_h, out_w), dtype=torch.float32)
    cnt = torch.zeros((out_h, out_w), dtype=torch.float32)
    for i, x0 in enumerate(plan.xs.tolist()):
        for j, y0 in enumerate(plan.ys.tolist()):
            acc[:, x0:x0 + th, y0:y0 + tw] += framed[:, i, j].float()
            cnt[x0:x0 + th, y0:y0 + tw] += 1.0
    out = (acc / torch.clamp(cnt, min=1.0)).to(torch.uint8)
    return out[:, : plan.h, : plan.w].contiguous()


GRIDS = [
    # name, (F, h, w), tile, add_tile, extra batch pad, bf16 logits
    ("exact", (2, 128, 128), 64, 0, 1, False),
    ("overlap-add-tile", (2, 96, 80), 64, 1, 0, False),
    ("reflect-pad-bf16", (2, 48, 80), 64, 0, 2, True),
    ("overlap-tile-40", (1, 70, 100), 40, 1, 0, True),
]


def _case(rng, grid, channels):
    _, (n_frames, h, w), t, add, extra, bf16 = grid
    xs, ys = grid_starts(h, t, add), grid_starts(w, t, add)
    plan = TilePlan(h, w, t, t, xs, ys, "cpu")
    n = n_frames * plan.per_frame + extra
    logits = torch.from_numpy((rng.standard_normal((n, channels, t, t)) * 4).astype(np.float32))
    return (logits.to(torch.bfloat16) if bf16 else logits), plan, n_frames, (xs, ys)


@pytest.mark.parametrize("channels", [2, 3])
@pytest.mark.parametrize("grid", GRIDS, ids=[g[0] for g in GRIDS])
def test_k3c_plain_bit_equal_to_jax_stitch(rng, grid, channels):
    logits, plan, n_frames, starts = _case(rng, grid, channels)
    before = sigmoid_stitch.launches
    ours = sigmoid_stitch(logits, n_frames, plan).numpy()
    assert sigmoid_stitch.launches == before  # a CPU tensor takes the plain version
    np.testing.assert_array_equal(ours, sigmoid_stitch_plain(logits, n_frames, plan).numpy())
    assert ours.shape == (n_frames, channels, plan.h, plan.w) and ours.dtype == np.uint8
    # JAX's stitch of the same per-tile levels: (n, th, tw, C) patches, frame-major
    real = logits[: n_frames * plan.per_frame]
    levels = (torch.sigmoid(real.float()) * 255.0).to(torch.uint8).numpy()
    out = (max(plan.th, plan.h), max(plan.tw, plan.w))
    ref = np.asarray(stitch_mean_frames_device(
        jnp.asarray(np.moveaxis(levels, 1, -1)), n_frames, starts, out, quantize_u8=True))
    ref = np.moveaxis(ref[:, : plan.h, : plan.w], -1, 1)
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("grid", GRIDS, ids=[g[0] for g in GRIDS])
def test_k3c_one_channel_form_is_k3(rng, grid):
    """One channel: the K3 plain version the port had, in both input forms;
    a channel of a 3-channel call: the one-channel call on that channel."""
    logits, plan, n_frames, _ = _case(rng, grid, 3)
    one = logits[:, 1:2].contiguous()
    want = _k3_plain_one_channel(one, n_frames, plan)
    for form in (one, one[:, 0]):
        got = sigmoid_stitch_plain(form, n_frames, plan)
        assert got.shape == (n_frames, plan.h, plan.w)
        assert torch.equal(got, want)
    assert torch.equal(sigmoid_stitch_plain(logits, n_frames, plan)[:, 1], want)


def test_k3c_refuses_tiles_of_another_size():
    plan = TilePlan(64, 64, 32, 32, [0, 32], [0, 32], "cpu")
    with pytest.raises(ValueError, match="plan's tile"):
        sigmoid_stitch(torch.zeros((4, 2, 16, 32)), 1, plan)
    with pytest.raises(ValueError, match="tiles for"):
        sigmoid_stitch(torch.zeros((3, 2, 32, 32)), 1, plan)


@pytest.fixture(scope="module")
def two_channel_pt(tmp_path_factory):
    """A JAX ``Unet(4, out_channels=2)`` with seeded weights and BatchNorm
    statistics warmed by three train-mode applies, as a reference-schema
    ``.pt``."""
    model = JUnet(n_filter=N_FILTER, out_channels=OUT_CH)
    variables = jax.jit(model.init)(jax.random.PRNGKey(3), jnp.zeros((1, 32, 32, 1)))

    @jax.jit
    def warm(variables, x):
        _, mutated = model.apply(variables, x, train=True, mutable=["batch_stats"])
        return {"params": variables["params"], "batch_stats": mutated["batch_stats"]}

    for i in range(3):
        x = jax.random.uniform(jax.random.PRNGKey(40 + i), (2, 32, 32, 1))
        variables = warm(variables, x)
    path = str(tmp_path_factory.mktemp("multichannel") / "unet_c2.pt")
    export_torch_checkpoint(path, jax.tree_util.tree_map(np.asarray, variables),
                            {"model_name": "Unet", "n_filter": N_FILTER, "in_channels": 1,
                             "out_channels": OUT_CH}, epoch=1, best_loss=0.5)
    return path


@pytest.mark.parametrize("dtype,shape,add", [(np.uint8, (3, 96, 80), 0),
                                             (np.uint16, (2, 100, 90), 1),
                                             (np.float32, (1, 64, 64), 0)])
def test_predict_multichannel_matches_jax(two_channel_pt, tmp_path, dtype, shape, add):
    rng = np.random.default_rng(11)
    movie = (rng.random(shape) * 3000).astype(dtype) if dtype == np.float32 else \
        rng.integers(0, np.iinfo(dtype).max, shape, endpoint=True).astype(dtype)
    kw = dict(resize_dim=(64, 64), add_tile=add, show_progress=False, batch_size=4)
    ours = Predict(movie, str(tmp_path / "ours.tif"), two_channel_pt, device="cpu", **kw)
    ref = JPredict(movie, str(tmp_path / "ref.tif"), two_channel_pt, **kw)
    want = (shape[0], OUT_CH) + shape[1:] if shape[0] > 1 else (OUT_CH,) + shape[1:]
    assert ours.result.shape == ref.result.shape == want
    assert_u8_contract(ours.result, ref.result)
    # the TIFF as JAX writes it: the squeezed result's (H, W) planes as float16 pages
    a, b = jtiff.imread(str(tmp_path / "ours.tif")), jtiff.imread(str(tmp_path / "ref.tif"))
    assert a.shape == b.shape and a.dtype == b.dtype == np.float16
    np.testing.assert_array_equal(a, ours.result.astype(np.float16).reshape(a.shape))


def test_predict_multichannel_warnings_are_jax_texts(two_channel_pt):
    movie = np.random.default_rng(12).integers(0, 255, (2, 64, 64), dtype=np.uint8)
    kw = dict(resize_dim=(64, 64), show_progress=False, device_pipeline=True,
              quantized=True)
    texts = {}
    for name, cls, extra in (("ours", Predict, {"device": "cpu"}), ("jax", JPredict, {})):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            res = cls(movie, None, two_channel_pt, **kw, **extra).result
        texts[name] = [str(w.message) for w in caught if "device_pipeline" in str(w.message)
                       or "quantized" in str(w.message)]
        assert res.shape == (2, OUT_CH, 64, 64)
    assert texts["ours"] == texts["jax"] and len(texts["ours"]) == 2
    assert "cannot be honored: multi-channel output (out_channels != 1)" in texts["ours"][0]
    assert "took the host-staged path (multi-channel output" in texts["ours"][1]
