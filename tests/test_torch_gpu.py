"""The port's CUDA kernels held against their plain PyTorch versions on the
card, and ``Predict``, ``PredictMultiOutput``, ``PredictSiam``, ``Predict3D``,
``PredictMultiOutput3D`` and the ``Trainer`` (2D and 3D) on the card held
against the same on the CPU; the int8 kernels K7–K10 and K7v, K8v, K10v
bit-equal to theirs (K7, K9, K10 and K11 on channel ranges of the UNet++
grid's row buffers too), K11 and K11v likewise, and ``quantized=True``
prediction (2D, UNet++, AttentionUnet and 3D) on the card within the int8
contract of the CPU's.  K6b (the two gradients of K6) is bit-equal to its
plain versions, and Siam training on the card matches the CPU's.  K6 and K10
(redesigned with register tiles and
16-byte vectors) are bit-equal to their plain versions at every shape and
vector width tested, and so are K5 and K5v (runs of 8 outputs from aligned
16-byte loads) on tiles at an odd float16 offset, on column starts off 8,
past K5_STAGED column tiles and K5_ITEMS row covers, and past 65535 plane
groups.  K3c (K3 over C channels) is held to its plain version, the legacy
``Unet_v0`` / ``BabyUnet`` and the multi-channel ``Predict`` on the card to
the CPU's, and an ``AttentionUnet`` training step in bf16 and float32 on the
card to the CPU's.

Every test here needs an NVIDIA GPU with the CUDA toolkit (the kernels are
built with nvcc on first use and have no CPU mode); without one they skip.
The file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -p no:cacheprovider
"""

import csv
import itertools
import os

import numpy as np
import pytest
import torch

from bio_image_unet_tpu_torch.data.augment_device import (HeadLayout, augment_apply,
                                                          augment_apply_plain,
                                                          augment_heads_apply,
                                                          augment_heads_apply_plain,
                                                          augment_heads_volume_apply,
                                                          augment_volume_apply, draw)
from bio_image_unet_tpu_torch import siam_unet
from bio_image_unet_tpu_torch.data import tiff
from bio_image_unet_tpu_torch.models import (MultiOutputNestedUNet, MultiOutputUnet,
                                             MultiOutputUnet3D, Siam_UNet, UNet3D, Unet)
from bio_image_unet_tpu_torch.ops import histogram as hist
from bio_image_unet_tpu_torch.ops.blocks import init_weights_
from bio_image_unet_tpu_torch.ops import int8 as k8
from bio_image_unet_tpu_torch.ops.functional import (depthwise_xcorr, depthwise_xcorr_grad_input,
                                                     depthwise_xcorr_grad_input_plain,
                                                     depthwise_xcorr_grad_kernel,
                                                     depthwise_xcorr_grad_kernel_plain,
                                                     depthwise_xcorr_plain)
from bio_image_unet_tpu_torch.ops.stitch import (blend_stitch_3d, blend_stitch_3d_plain,
                                                  margin_stitch, margin_stitch_plain,
                                                  sigmoid_stitch, sigmoid_stitch_3d,
                                                  sigmoid_stitch_3d_plain, sigmoid_stitch_plain,
                                                  tile_sum, tile_sum_plain)
from bio_image_unet_tpu_torch.predict import (Predict, Predict3D, PredictMultiOutput,
                                              PredictMultiOutput3D)
from bio_image_unet_tpu_torch.predict.normalize import (normalize_tile, normalize_tile_3d,
                                                        normalize_tile_3d_plain,
                                                        normalize_tile_float,
                                                        normalize_tile_pairs,
                                                        normalize_tile_pairs_plain,
                                                        normalize_tile_plain)
from bio_image_unet_tpu_torch.predict.tiling import (TilePlan, TilePlan3D, _blend_factors,
                                                     _margin_factors, grid_starts,
                                                     overlap_starts)
from bio_image_unet_tpu_torch.train import Trainer
from bio_image_unet_tpu_torch.utils.kernel_ab_times import offset_view
from bio_image_unet_tpu_torch.utils.synth import blob_sample
from chip_smoke import write_warm_checkpoint

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    # float32 legs compare in full float32 (cuDNN would use TF32 by default)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def gen():
    return np.random.default_rng(0)


def _bits(t):
    return t.cpu().numpy().view(np.uint32)


def _frames(gen, dtype, shape):
    if dtype == np.float32:
        return (gen.standard_normal(shape) * 40 + 5).astype(np.float32)
    return gen.integers(0, np.iinfo(dtype).max, shape, endpoint=True).astype(dtype)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
@pytest.mark.parametrize("shape", [(3, 37, 53), (2, 256, 256), (1, 7, 5)])
def test_clip_bounds_kernel_bit_equal_to_plain(cuda, gen, dtype, shape):
    frames = _frames(gen, dtype, shape)
    frames[0, :2] = frames[0, 0, 0]  # ties
    x = torch.from_numpy(frames).to(cuda)
    wrapper = hist.float_clip_bounds if dtype == np.float32 else hist.int_clip_bounds
    before = wrapper.launches
    for qs in ((0.0, 99.8), (0.3, 99.7), (50.0, 100.0)):
        ours = hist.clip_bounds(x, *qs)
        torch.cuda.synchronize()
        ref = hist.clip_bounds_plain(x, *qs)
        np.testing.assert_array_equal(_bits(ours), _bits(ref), err_msg=str(qs))
    assert wrapper.launches > before


def test_clip_bounds_kernel_constant_frames(cuda):
    for dtype in (torch.uint8, torch.uint16, torch.float32):
        x = torch.full((2, 64, 48), 7, dtype=dtype, device=cuda)
        np.testing.assert_array_equal(_bits(hist.clip_bounds(x, 0.0, 99.8)),
                                      _bits(hist.clip_bounds_plain(x, 0.0, 99.8)))


K2_CASES = [
    ("exact", np.uint8, (2, 128, 128), 64, 0, False, False),
    ("gather", np.uint16, (2, 100, 90), 32, 1, False, False),
    ("reflect-pad", np.float32, (2, 48, 80), 64, 0, True, False),
    ("fixed-bounds", np.uint8, (3, 96, 96), 64, 0, False, True),
    ("odd-tile", np.uint8, (2, 40, 40), 30, 0, False, False),
]


@pytest.mark.parametrize("case", K2_CASES, ids=[c[0] for c in K2_CASES])
def test_normalize_tile_kernel_equals_plain(cuda, gen, case):
    _, dtype, (n_frames, h, w), t, add, invert, fixed = case
    x = torch.from_numpy(_frames(gen, dtype, (n_frames, h, w))).to(cuda)
    bounds = hist.clip_bounds(x, 0.5, 99.5)
    if fixed:
        bounds = torch.stack([bounds[0, :1], bounds[1, :1], bounds[0, :1], bounds[1, :1]])
    plan = TilePlan(h, w, t, t, grid_starts(h, t, add), grid_starts(w, t, add), cuda)
    n_total = n_frames * plan.per_frame + 3
    before = normalize_tile.launches
    ours = normalize_tile(x, bounds.contiguous(), plan, n_total, invert)
    torch.cuda.synchronize()
    assert normalize_tile.launches == before + 1
    ref = normalize_tile_plain(x, bounds, plan, n_total, invert)
    assert torch.equal(ours, ref)


K3_CASES = [
    ("exact", (2, 128, 128), 64, 0, torch.float32),
    ("overlap", (2, 100, 90), 32, 1, torch.bfloat16),
    ("reflect-pad", (2, 48, 80), 64, 0, torch.float32),
    # the other dtype of each grid, tile widths 24 and 40 (runs across tile
    # edges, pixel by pixel), a frame narrower than one run, a 1000-pixel row
    # (8-byte aligned rows) and two 1024^2 frames of the main path's grid
    ("exact-bf16", (2, 128, 128), 64, 0, torch.bfloat16),
    ("overlap-f32", (2, 100, 90), 32, 1, torch.float32),
    ("reflect-pad-bf16", (2, 48, 80), 64, 0, torch.bfloat16),
    ("tile-24", (2, 48, 72), 24, 0, torch.float32),
    ("tile-40-bf16", (2, 80, 120), 40, 0, torch.bfloat16),
    ("tile-40-overlap", (2, 70, 100), 40, 1, torch.float32),
    ("narrow-bf16", (3, 9, 7), 16, 0, torch.bfloat16),
    ("narrow-f32", (3, 9, 7), 16, 0, torch.float32),
    ("rows-1000", (2, 1000, 1000), 256, 1, torch.bfloat16),
    ("exact-1024", (2, 1024, 1024), 256, 0, torch.bfloat16),
    ("exact-1024-f32", (2, 1024, 1024), 512, 0, torch.float32),
    # up to four covers an axis (the loops, a mean by a count of 3)
    ("heavy-overlap", (2, 64, 70), 32, 4, torch.float32),
]


@pytest.mark.parametrize("case", K3_CASES, ids=[c[0] for c in K3_CASES])
def test_sigmoid_stitch_kernel_equals_plain(cuda, gen, case):
    _, (n_frames, h, w), t, add, dtype = case
    plan = TilePlan(h, w, t, t, grid_starts(h, t, add), grid_starts(w, t, add), cuda)
    n = n_frames * plan.per_frame + 2
    logits = torch.from_numpy((gen.standard_normal((n, 1, t, t)) * 4).astype(np.float32))
    logits = logits.to(cuda, dtype)
    before = sigmoid_stitch.launches
    ours = sigmoid_stitch(logits, n_frames, plan)
    torch.cuda.synchronize()
    assert sigmoid_stitch.launches == before + 1
    ref = sigmoid_stitch_plain(logits, n_frames, plan)
    assert (ours.int() - ref.int()).abs().max().item() <= 1


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.zeros((2, 32, 64), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        hist.int_clip_bounds(x[:, :, ::2], 0.0, 99.8)
    plan = TilePlan(32, 32, 32, 32, [0], [0], cuda)
    with pytest.raises(ValueError, match="float32/bfloat16"):
        sigmoid_stitch(torch.zeros((2, 1, 32, 32), dtype=torch.float16, device=cuda), 2, plan)


@pytest.mark.parametrize("mode,dtype,add", [("single", np.uint8, 0), ("single", np.uint16, 1),
                                            ("first", np.uint8, 1), ("all", np.float32, 0)])
def test_predict_on_card_matches_cpu(cuda, gen, tmp_path, mode, dtype, add):
    net = init_weights_(Unet(n_filter=8), torch.Generator().manual_seed(0), random_bn_stats=True)
    path = str(tmp_path / "unet.pt")
    torch.save({"state_dict": net.state_dict(), "model_name": "Unet", "n_filter": 8}, path)
    movie = _frames(gen, dtype, (18, 96, 96))
    kw = dict(resize_dim=(64, 64), add_tile=add, normalization_mode=mode,
              show_progress=False, batch_size=4)
    counts = (hist.int_clip_bounds.launches + hist.float_clip_bounds.launches,
              normalize_tile.launches, sigmoid_stitch.launches)
    card = Predict(movie, None, path, **kw).result
    after = (hist.int_clip_bounds.launches + hist.float_clip_bounds.launches,
             normalize_tile.launches, sigmoid_stitch.launches)
    assert after[1] > counts[1] and after[2] > counts[2]
    assert (after[0] > counts[0]) == (mode == "single")
    cpu = Predict(movie, None, path, device="cpu", **kw).result
    diff = np.abs(card.astype(int) - cpu.astype(int))
    assert diff.max() <= 1 and np.mean(diff > 0) <= 1e-3, (diff.max(), np.mean(diff > 0))
    host = Predict(movie, None, path, device_pipeline=False, **kw).result
    diff = np.abs(card.astype(int) - host.astype(int))
    assert np.mean(diff > 1) < 0.01 and diff.max() <= 16


K4_CASES = [
    # (id, tiles in the set, batch, image channels, mask channels, tile, pair, gauss)
    ("train-shape", 120, 12, 1, 1, 256, False, None),
    ("pair-gauss", 20, 6, 1, 1, 64, True, 0.04),
    ("channels-odd-tile", 9, 5, 2, 3, 30, False, 0.1),
]


def _ulps(a, b):
    ai = a.cpu().numpy().view(np.int32).astype(np.int64)
    bi = b.cpu().numpy().view(np.int32).astype(np.int64)
    return int(np.abs(ai - bi).max())


@pytest.mark.parametrize("case", K4_CASES, ids=[c[0] for c in K4_CASES])
def test_augment_kernel_equals_plain(cuda, case):
    """K4 against its plain version on the same draws, gathering a
    non-trivial index (repeats, out of order) from a resident tile set:
    masks bit-equal, images within one float32 ulp."""
    _, n, b, ci, co, s, pair, sigma = case
    g = torch.Generator(device=cuda).manual_seed(0)
    image = torch.rand((n, ci, s, s), generator=g, device=cuda)
    mask = (torch.rand((n, co, s, s), generator=g, device=cuda) > 0.5).float()
    prev = torch.rand((n, ci, s, s), generator=g, device=cuda) if pair else None
    index = torch.randint(0, n, (b,), generator=g, device=cuda)
    index[-1] = index[0]
    d = draw(g, b, (b, ci, s, s), prev=pair, gauss_sigma=sigma)
    before = augment_apply.launches
    ours = augment_apply(image, mask, d, index=index, prev=prev)
    torch.cuda.synchronize()
    assert augment_apply.launches == before + 1
    ref = augment_apply_plain(image, mask, d, index=index, prev=prev)
    assert len(ours) == len(ref) == (3 if pair else 2)
    assert torch.equal(ours[1], ref[1])
    assert _ulps(ours[0], ref[0]) <= 1
    if pair:
        assert _ulps(ours[2], ref[2]) <= 1
    # without an index the batch itself is augmented
    whole = augment_apply(image[:b].contiguous(), mask[:b].contiguous(), d,
                          prev=None if prev is None else prev[:b].contiguous())
    assert torch.equal(whole[1], augment_apply_plain(image[:b], mask[:b], d)[1])


def test_augment_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x = torch.zeros((4, 1, 16, 16), device=cuda)
    d = draw(torch.Generator(device=cuda), 4, (4, 1, 16, 16))
    with pytest.raises(ValueError, match="float32"):
        augment_apply(x.double(), x, d)
    with pytest.raises(ValueError, match="int64"):
        augment_apply(x, x, d, index=torch.zeros(4, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="field"):
        augment_apply(x, x, d, index=torch.zeros(2, dtype=torch.int64, device=cuda))


class _Tiles:
    def __init__(self, n=15, size=64):
        rng = np.random.default_rng(0)
        self.items = []
        for _ in range(n):
            img, m = blob_sample(rng, (size, size))
            self.items.append({"image": (img / 255.0).astype(np.float32)[None],
                               "mask": (m / 255.0).astype(np.float32)[None]})

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


@pytest.mark.parametrize("cache", [False, True], ids=["loader", "device_cache"])
def test_trainer_on_card_matches_cpu(cuda, tmp_path, cache):
    """3 steps (12 training tiles, batch 4) and a validation pass on the card
    against the same on the CPU, float32 with TF32 off."""
    rows = {}
    for dev in ("cuda", "cpu"):
        out = tmp_path / dev
        t = Trainer(_Tiles(), 1, n_filter=8, batch_size=4, lr=1e-4, save_dir=str(out),
                    seed=0, device=dev, device_cache=cache)
        t.start()
        with open(os.path.join(out, "metrics.csv")) as fh:
            rows[dev] = np.array([[float(v) for v in r[1:3]] for r in list(csv.reader(fh))[1:]])
    np.testing.assert_allclose(rows["cuda"], rows["cpu"], rtol=1e-3)


def test_trainer_on_card_with_augment_and_bf16(cuda, tmp_path):
    """The slice's configuration at a small width: bf16, resident tiles, K4
    once per step; the checkpoint it writes predicts on the card."""
    before = augment_apply.launches
    t = Trainer(_Tiles(n=30), 2, n_filter=8, batch_size=4, lr=1e-3, save_dir=str(tmp_path),
                seed=0, device_cache=True, device_augment=True, half_precision=True)
    t.start()
    assert augment_apply.launches - before == 2 * (24 // 4)
    assert all(np.isfinite(h["train_loss"]) for h in t.history)
    res = Predict(np.random.default_rng(1).integers(0, 255, (2, 96, 96), dtype=np.uint8),
                  None, str(tmp_path / "model.pt"), resize_dim=(64, 64), show_progress=False)
    assert res.result.shape == (2, 96, 96)


# --- the multi-head path: K2h, K5, K5s ------------------------------------------

K2H_CASES = [
    ("exact-bf16", np.uint8, (2, 128, 128), 64, 0, False, torch.bfloat16),
    ("overlap-f32", np.uint16, (2, 100, 90), 32, 1, False, torch.float32),
    ("reflect-pad-bf16", np.float32, (2, 48, 80), 64, 0, False, torch.bfloat16),
    ("fixed-bounds-f32", np.uint16, (3, 96, 96), 64, 0, True, torch.float32),
    ("odd-tile-bf16", np.uint8, (2, 40, 40), 30, 0, False, torch.bfloat16),
]


@pytest.mark.parametrize("case", K2H_CASES, ids=[c[0] for c in K2H_CASES])
def test_normalize_tile_float_kernel_equals_plain(cuda, gen, case):
    _, dtype, (n_frames, h, w), t, add, fixed, out_dtype = case
    x = torch.from_numpy(_frames(gen, dtype, (n_frames, h, w))).to(cuda)
    bounds = hist.clip_bounds(x, 0.5, 99.5)
    if fixed:
        bounds = torch.stack([bounds[0, :1], bounds[1, :1], bounds[0, :1], bounds[1, :1]])
    xs, ys = grid_starts(max(h, t), t, add), grid_starts(max(w, t), t, add)
    plan = TilePlan(h, w, t, t, xs, ys, cuda)
    n_total = n_frames * plan.per_frame + 3
    before = normalize_tile_float.launches
    ours = normalize_tile_float(x, bounds.contiguous(), plan, n_total, out_dtype)
    torch.cuda.synchronize()
    assert normalize_tile_float.launches == before + 1
    ref = normalize_tile_plain(x, bounds, plan, n_total, False, out_dtype)
    assert ours.dtype == ref.dtype == out_dtype
    assert torch.equal(ours.float().view(torch.int32), ref.float().view(torch.int32))


K5_CASES = [
    # id, (frames, h, w), tile, add_tile, margin, channels, batch padding,
    # float16 offset of the tiles' view
    ("exact", (3, 128, 128), 64, 0, 8, 1, 0, 0),
    ("overlap-2ch", (2, 100, 90), 32, 1, 4, 2, 3, 0),
    ("reflect-pad", (2, 48, 80), 64, 0, 5, 2, 0, 0),
    ("margin0-odd-tile", (2, 70, 70), 30, 1, 0, 1, 1, 0),
    # column starts 0 and 491 (3 mod 8) and rows of 1003 values: unaligned
    # tile reads and output rows
    ("starts-off-8-1000x1003", (2, 1000, 1003), 512, 0, 20, 1, 0, 0),
    ("odd-offset-view", (2, 100, 90), 32, 1, 4, 2, 1, 1),
    # 8 column tiles over one 256-column strip: fy read from device memory
    ("eight-column-tiles", (2, 40, 200), 32, 1, 4, 1, 0, 0),
    # seven tiles cover each row: the rows' covers read from device memory
    ("seven-row-covers", (2, 40, 70), 32, 5, 4, 1, 0, 0),
    # 131100 frames x 2 channels: 65550 groups of 4 planes, two launches
    ("plane-groups-over-65535", (131100, 8, 8), 8, 0, 2, 2, 0, 0),
]


def _offset_view(t: torch.Tensor, offset: int) -> torch.Tensor:
    view = offset_view(torch, t, offset)
    assert view.is_contiguous() and view.data_ptr() % 16 == (offset * t.element_size()) % 16
    return view


@pytest.mark.parametrize("case", K5_CASES, ids=[c[0] for c in K5_CASES])
def test_margin_stitch_and_tile_sum_kernels_equal_plain(cuda, gen, case):
    """K5 bit-equal to its plain version in float16 and float32 (the same
    additions in the same order); K5s's float64 sum of float16 values is
    exact, so it equals the plain sum, and so does the fill."""
    _, (n_frames, h, w), t, add, margin, c, extra, offset = case
    xs, ys = grid_starts(max(h, t), t, add), grid_starts(max(w, t), t, add)
    plan = TilePlan(h, w, t, t, xs, ys, cuda, _margin_factors((len(xs), len(ys)), (t, t), margin))
    n = n_frames * plan.per_frame
    tiles = _offset_view(torch.from_numpy((gen.standard_normal((n + extra, c, t, t)) * 2)
                                          .astype(np.float16)).to(cuda), offset)
    for out_dtype in (torch.float16, torch.float32):
        before = margin_stitch.launches
        ours = margin_stitch(tiles, n_frames, plan, out_dtype)
        torch.cuda.synchronize()
        assert margin_stitch.launches == before + 1
        ref = margin_stitch_plain(tiles, n_frames, plan, out_dtype)
        assert ours.shape == (n_frames, c, h, w) and ours.dtype == out_dtype
        view = torch.int16 if out_dtype == torch.float16 else torch.int32
        assert torch.equal(ours.view(view), ref.view(view)), out_dtype
    before = tile_sum.launches
    total = tile_sum(tiles, n)
    torch.cuda.synchronize()
    assert tile_sum.launches == before + 1
    ref_total = tile_sum_plain(tiles, n)
    assert total.item() == ref_total.item()
    count = n * c * t * t
    assert np.float32(total.item() / count).astype(np.float16) == \
        np.float32(ref_total.item() / count).astype(np.float16)


@pytest.mark.parametrize("offset,size", [(0, 5), (1, 5), (1, 4), (1, 1)])
def test_tile_sum_kernel_takes_any_float16_offset(cuda, gen, offset, size):
    """K5s reads pairs of float16 values; a contiguous view that starts at an
    odd float16 offset (not 4-byte aligned) sums its first value on its own."""
    n_tiles = 3
    flat = torch.from_numpy((gen.standard_normal(offset + n_tiles * size * size) * 2)
                            .astype(np.float16)).to(cuda)
    tiles = flat[offset:].view(n_tiles, 1, size, size)
    assert tiles.is_contiguous() and tiles.data_ptr() % 4 == 2 * offset
    total = tile_sum(tiles, n_tiles)
    torch.cuda.synchronize()
    assert total.item() == tile_sum_plain(tiles, n_tiles).item()


def test_heads_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    factors = _margin_factors((2, 2), (16, 16), 2)
    plan = TilePlan(32, 32, 16, 16, [0, 16], [0, 16], cuda, factors)
    cpu_plan = TilePlan(32, 32, 16, 16, [0, 16], [0, 16], "cpu", factors)
    tiles = torch.zeros((8, 2, 16, 16), dtype=torch.float16, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        margin_stitch(tiles.to(memory_format=torch.channels_last), 2, plan)
    with pytest.raises(ValueError, match="plan"):
        margin_stitch(tiles, 2, cpu_plan)
    with pytest.raises(ValueError, match="float16"):
        margin_stitch(tiles.float(), 2, plan)
    with pytest.raises(ValueError, match="contiguous"):
        tile_sum(tiles[:, :1], 8)
    x = torch.zeros((2, 32, 32), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="float32/bfloat16"):
        normalize_tile_float(x, torch.zeros((4, 2), device=cuda), plan, 8, torch.float16)


@pytest.mark.parametrize("model,mode,dtype,add", [
    ("nested", "single", np.uint8, 0), ("nested", "first", np.uint16, 1),
    ("unet", "all", np.float32, 1)])
def test_predict_multi_output_on_card_matches_cpu(cuda, gen, tmp_path, model, mode, dtype, add):
    """``PredictMultiOutput`` on the card (K1 → K2h → forward → K5 + K5s)
    against the CPU (plain versions, CPU convolutions), float32 with TF32
    off: within 1e-3 + 1e-3·|CPU| on every head and pixel; the card's fused
    path against its host-staged path within the JAX package's atol 2e-3."""
    heads = {"mask": {"channels": 1, "activation": "sigmoid"},
             "orientation": {"channels": 2, "activation": None}}
    cls, name = ((MultiOutputNestedUNet, "MultiOutputNestedUNet") if model == "nested"
                 else (MultiOutputUnet, "MultiOutputUnet"))
    net = init_weights_(cls(n_filter=4, output_heads=heads), torch.Generator().manual_seed(0),
                        random_bn_stats=True)
    path = str(tmp_path / "heads.pt")
    torch.save({"state_dict": net.state_dict(), "model_name": name, "n_filter": 4,
                "output_heads": heads}, path)
    movie = _frames(gen, dtype, (18, 64, 96))
    kw = dict(max_patch_size=(32, 32), add_tile=add, normalization_mode=mode, safe_margin=4,
              show_progress=False, batch_size=4)
    counters = (hist.int_clip_bounds, hist.float_clip_bounds, normalize_tile_float,
                margin_stitch, tile_sum)
    before = [c.launches for c in counters]
    card = PredictMultiOutput(movie, path, **kw).result
    ran = [c.launches - b for c, b in zip(counters, before)]
    assert ran[2] > 0 and ran[3] > 0, ran
    assert (ran[0] + ran[1] > 0) == (mode == "single")
    # K5s runs where the grid leaves pixels no tile weighs: the seams of the
    # exact grid, not the overlapping one (its margins are covered)
    assert (ran[4] > 0) == (add == 0), ran
    cpu = PredictMultiOutput(movie, path, device="cpu", **kw).result
    host = PredictMultiOutput(movie, path, device_pipeline=False, **kw).result
    for head in heads:
        assert card[head].shape == cpu[head].shape
        bad = np.abs(card[head] - cpu[head]) > 1e-3 + 1e-3 * np.abs(cpu[head])
        assert not bad.any(), (head, int(bad.sum()))
        np.testing.assert_allclose(card[head], host[head], atol=2e-3, rtol=0, err_msg=head)


# --- the multi-head training path: K4h -------------------------------------------

K4H_CASES = [
    # name, resident tiles, batch, tile size, heads {name: channels}
    ("slice-shapes", 64, 4, 256, {"mask": 1, "orientation": 2}),
    ("all-cases-gather", 20, 16, 32, {"mask": 1, "orientation": 2, "distance": 1}),
    ("odd-tile-scalar-stores", 20, 16, 30, {"orientation": 2, "mask": 1}),
    ("two-orientation-heads", 6, 5, 12, {"orientation": 2, "orientation_b": 2}),
]


@pytest.mark.parametrize("case", K4H_CASES, ids=[c[0] for c in K4H_CASES])
def test_augment_heads_kernel_equals_plain(cuda, case):
    """K4h against its plain version on the same draws, gathering a
    non-trivial index (repeats, out of order), with every (k, flip_h,
    flip_v) case forced on where the batch allows it and one sample gated
    off: targets equal (zeros by value), image within one float32 ulp."""
    _, n, b, s, channels = case
    g = torch.Generator(device=cuda).manual_seed(0)
    layout = HeadLayout.of(channels, [k for k in channels if "orientation" in k], cuda)
    image = torch.rand((n, 1, s, s), generator=g, device=cuda)
    parts = []
    for name, c in channels.items():
        if "orientation" in name:
            theta = torch.rand((n, 1, s, s), generator=g, device=cuda) * 6.2832
            parts.append(torch.cat([theta.cos(), theta.sin()], 1))
        else:
            parts.append((torch.rand((n, c, s, s), generator=g, device=cuda) > 0.5).float())
    target = torch.cat(parts, 1).contiguous()
    index = torch.randint(0, n, (b,), generator=g, device=cuda)
    index[-1] = index[0]
    d = draw(g, b, (b, 1, s, s), gauss_sigma=0.04)
    for i, (k, fh, fv) in enumerate(itertools.product(range(4), (0, 1), (0, 1))):
        if i < b - 1:
            d.flags[i, :4] = torch.tensor([1, k, fh, fv], dtype=torch.int32, device=cuda)
    d.flags[b - 1, 0] = 0
    before = augment_heads_apply.launches
    ours = augment_heads_apply(image, target, layout.codes, d, index=index)
    torch.cuda.synchronize()
    assert augment_heads_apply.launches == before + 1
    ref = augment_heads_apply_plain(image, target, layout.codes, d, index=index)
    assert torch.equal(ours[1], ref[1])
    assert _ulps(ours[0], ref[0]) <= 1
    assert torch.equal(ours[1][b - 1], target[index[b - 1]])  # gated off: untouched
    # without an index the batch itself is augmented
    whole = augment_heads_apply(image[:b].contiguous(), target[:b].contiguous(), layout.codes, d)
    assert torch.equal(whole[1], augment_heads_apply_plain(image[:b], target[:b],
                                                           layout.codes, d)[1])


def test_augment_heads_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x = torch.zeros((4, 1, 16, 16), device=cuda)
    t = torch.zeros((4, 3, 16, 16), device=cuda)
    layout = HeadLayout.of({"mask": 1, "orientation": 2}, ("orientation",), cuda)
    d = draw(torch.Generator(device=cuda), 4, (4, 1, 16, 16))
    with pytest.raises(ValueError, match="CUDA tensor"):  # a CPU/CUDA mix
        augment_heads_apply(x, t.cpu(), layout.codes, d)
    with pytest.raises(ValueError, match="CUDA tensor"):
        augment_heads_apply(x, t, layout.codes.cpu(), d)
    with pytest.raises(ValueError, match="float32"):
        augment_heads_apply(x, t.double(), layout.codes, d)
    with pytest.raises(ValueError, match="int32"):
        augment_heads_apply(x, t, layout.codes.long(), d)
    with pytest.raises(ValueError, match="int64"):
        augment_heads_apply(x, t, layout.codes, d,
                            index=torch.zeros(4, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="field"):
        augment_heads_apply(x, t, layout.codes, d,
                            index=torch.zeros(2, dtype=torch.int64, device=cuda))


class _HeadTiles:
    def __init__(self, n=15, size=64):
        rng = np.random.default_rng(0)
        yy, xx = np.mgrid[:size, :size]
        self.items = []
        for _ in range(n):
            img, m = blob_sample(rng, (size, size))
            theta = np.arctan2(yy - rng.uniform(0, size), xx - rng.uniform(0, size))
            self.items.append({"image": (img / 255.0).astype(np.float32)[None],
                               "mask": (m / 255.0).astype(np.float32)[None],
                               "orientation": np.stack([np.cos(theta),
                                                        np.sin(theta)]).astype(np.float32)})

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


HEAD_LOSSES = {"mask": {"channels": 1, "activation": "sigmoid", "loss": "BCEDiceLoss"},
               "orientation": {"channels": 2, "activation": None, "loss": "MSELoss"}}


@pytest.mark.parametrize("network,deep,cache", [
    ("MultiOutputUnet", False, False), ("MultiOutputNestedUNet_3Levels", True, True)])
def test_multi_output_trainer_on_card_matches_cpu(cuda, tmp_path, network, deep, cache):
    """3 steps and a validation pass of the multi-output Trainer on the card
    against the CPU, float32 with TF32 off: ``metrics.csv`` within rtol 1e-3
    (the bilinear upsample's backward accumulates with atomics on the card)."""
    rows = {}
    for dev in ("cuda", "cpu"):
        out = tmp_path / dev
        t = Trainer(_HeadTiles(), 1, network=network, n_filter=8, output_heads=HEAD_LOSSES,
                    deep_supervision=deep, batch_size=4, lr=1e-4, grad_clip=1.0,
                    save_dir=str(out), seed=0, device=dev, device_cache=cache)
        t.start()
        with open(os.path.join(out, "metrics.csv")) as fh:
            rows[dev] = np.array([[float(v) for v in r[1:3]] for r in list(csv.reader(fh))[1:]])
    np.testing.assert_allclose(rows["cuda"], rows["cpu"], rtol=1e-3)


def test_multi_output_trainer_on_card_with_augment_and_bf16(cuda, tmp_path):
    """bf16, resident tiles, K4h once per step and K4 never; the checkpoint it
    writes predicts on the card."""
    before = (augment_heads_apply.launches, augment_apply.launches)
    t = Trainer(_HeadTiles(n=30), 2, network="MultiOutputNestedUNet", n_filter=8,
                output_heads=HEAD_LOSSES, batch_size=4, lr=1e-3, save_dir=str(tmp_path),
                seed=0, device_cache=True, device_augment=True, half_precision=True)
    t.start()
    assert augment_heads_apply.launches - before[0] == 2 * (24 // 4)
    assert augment_apply.launches == before[1]
    assert all(np.isfinite(h["train_loss"]) for h in t.history)
    res = PredictMultiOutput(np.random.default_rng(1).integers(0, 255, (2, 96, 96),
                                                               dtype=np.uint8),
                             str(tmp_path / "model.pt"), max_patch_size=(64, 64),
                             show_progress=False).result
    assert res["mask"].shape == (2, 96, 96) and res["orientation"].shape == (2, 2, 96, 96)


# --- 3D prediction: K2v, K3v, K5v ---------------------------------------------------

K2V_CASES = [
    # name, dtype, (V, d, h, w), tile, add_patch, invert, fixed bounds, out dtype, batch pad
    ("exact-u8", np.uint8, (1, 16, 64, 64), (8, 32, 32), 0, False, False, torch.uint8, 0),
    ("overlap-u16-invert", np.uint16, (1, 12, 40, 36), (8, 32, 32), 1, True, False,
     torch.uint8, 3),
    ("reflect-pad-f32", np.float32, (1, 6, 40, 20), (8, 32, 32), 0, False, False, torch.uint8, 1),
    ("two-volumes-bf16", np.uint8, (2, 12, 40, 36), (8, 32, 32), 0, False, False,
     torch.bfloat16, 0),
    ("fixed-bounds-f32-odd", np.uint16, (2, 9, 21, 23), (5, 15, 15), 0, False, True,
     torch.float32, 2),
    ("main-path", np.uint8, (1, 64, 512, 512), (32, 128, 128), 0, False, False, torch.uint8, 0),
]


@pytest.mark.parametrize("case", K2V_CASES, ids=[c[0] for c in K2V_CASES])
def test_normalize_tile_3d_kernel_equals_plain(cuda, gen, case):
    _, dtype, (n_vols, d, h, w), tile, add, invert, fixed, out_dtype, extra = case
    x = torch.from_numpy(_frames(gen, dtype, (n_vols, d, h, w))).to(cuda)
    bounds = hist.clip_bounds(x, 0.5, 99.5)
    if fixed:
        bounds = torch.stack([bounds[0, :1], bounds[1, :1], bounds[0, :1], bounds[1, :1]])
    starts = [grid_starts(e, t, add) for e, t in zip((d, h, w), tile)]
    plan = TilePlan3D(d, h, w, tile, *starts, cuda)
    n_total = n_vols * plan.per_volume + extra
    before = normalize_tile_3d.launches
    ours = normalize_tile_3d(x, bounds.contiguous(), plan, n_total, invert, out_dtype)
    torch.cuda.synchronize()
    assert normalize_tile_3d.launches == before + 1
    ref = normalize_tile_3d_plain(x, bounds, plan, n_total, invert, out_dtype)
    assert ours.shape == ref.shape == (n_total,) + tuple(tile) and ours.dtype == out_dtype
    assert torch.equal(ours.float().view(torch.int32), ref.float().view(torch.int32))


K3V_CASES = [
    # name, (d, h, w), tile, add_patch, logits dtype
    ("exact-bf16", (16, 64, 64), (8, 32, 32), 0, torch.bfloat16),
    ("overlap-f32", (12, 40, 36), (8, 32, 32), 1, torch.float32),
    ("shallow-bf16", (6, 40, 40), (8, 32, 32), 0, torch.bfloat16),
    ("odd-tile-f32", (9, 21, 23), (5, 15, 15), 1, torch.float32),
    ("main-path-bf16", (64, 512, 512), (32, 128, 128), 0, torch.bfloat16),
]


@pytest.mark.parametrize("case", K3V_CASES, ids=[c[0] for c in K3V_CASES])
def test_sigmoid_stitch_3d_kernel_equals_plain(cuda, gen, case):
    """K3v within one uint8 level of its plain version: both take the same
    float32 steps; ``expf`` and torch's sigmoid may differ by an ulp."""
    _, (d, h, w), tile, add, dtype = case
    starts = [grid_starts(e, t, add) for e, t in zip((d, h, w), tile)]
    plan = TilePlan3D(d, h, w, tile, *starts, cuda)
    logits = (torch.randn((plan.per_volume + 2, 1) + tuple(tile), device=cuda) * 4).to(dtype)
    before = sigmoid_stitch_3d.launches
    ours = sigmoid_stitch_3d(logits, plan)
    torch.cuda.synchronize()
    assert sigmoid_stitch_3d.launches == before + 1
    ref = sigmoid_stitch_3d_plain(logits, plan)
    assert ours.shape == (d, h, w) and ours.dtype == torch.uint8
    diff = (ours.int() - ref.int()).abs()
    assert diff.max().item() <= 1 and diff.float().mean().item() < 1e-3


K5V_CASES = [
    # name, (V, d, h, w), max tile, overlap, margin, channels, batch pad,
    # float16 offset of the tiles' view
    ("two-volumes-2ch", (2, 12, 40, 36), (8, 32, 32), 0.1, 4, 2, 0, 0),
    ("margin-over-tile", (1, 10, 24, 40), (6, 16, 16), 0.25, 8, 1, 3, 0),
    ("uncovered-seams", (1, 8, 33, 33), (8, 16, 16), 0.0, 5, 1, 0, 0),
    ("main-path", (2, 64, 512, 512), (64, 256, 256), 0.1, 16, 2, 0, 0),
    ("main-path-odd-offset-view", (1, 16, 512, 512), (16, 256, 256), 0.1, 16, 1, 0, 1),
    # 13 column tiles over one 256-column strip: fy read from device memory
    ("thirteen-column-tiles", (1, 4, 24, 150), (4, 16, 16), 0.25, 4, 1, 0, 0),
    # 2 z covers x 4 row covers: the rows' covers read from device memory
    ("eight-covers-a-row", (1, 12, 40, 36), (8, 16, 16), 0.75, 4, 1, 0, 0),
    # 150 one-tile volumes x 2 channels x 880 planes: 66000 groups of 4 planes
    # of one z, two launches
    ("plane-groups-over-65535", (150, 880, 8, 8), (880, 8, 8), 0.1, 16, 2, 0, 0),
]


@pytest.mark.parametrize("case", K5V_CASES, ids=[c[0] for c in K5V_CASES])
def test_blend_stitch_3d_kernel_equals_plain(cuda, gen, case):
    """K5v bit-equal to its plain version in float16 and float32: the same
    fused multiply-adds in the same order, the same division."""
    _, (n_vols, d, h, w), max_tile, overlap, margin, c, extra, offset = case
    tile = tuple(min(e, m) for e, m in zip((d, h, w), max_tile))
    starts = [overlap_starts(e, t, overlap) for e, t in zip((d, h, w), tile)]
    plan = TilePlan3D(d, h, w, tile, *starts, cuda,
                      _blend_factors([len(s) for s in starts], tile, margin))
    n = n_vols * plan.per_volume
    tiles = _offset_view((torch.randn((n + extra, c) + tile, device=cuda) * 2).half(), offset)
    for out_dtype in (torch.float16, torch.float32):
        before = blend_stitch_3d.launches
        ours = blend_stitch_3d(tiles, n_vols, plan, out_dtype)
        torch.cuda.synchronize()
        assert blend_stitch_3d.launches == before + 1
        ref = blend_stitch_3d_plain(tiles, n_vols, plan, out_dtype)
        assert ours.shape == (n_vols, c, d, h, w) and ours.dtype == out_dtype
        view = torch.int16 if out_dtype == torch.float16 else torch.int32
        assert torch.equal(ours.view(view), ref.view(view)), out_dtype


def test_3d_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    tile = (4, 16, 16)
    plan = TilePlan3D(8, 32, 32, tile, [0, 4], [0, 16], [0, 16], cuda,
                      _blend_factors((2, 2, 2), tile, 2))
    cpu_plan = TilePlan3D(8, 32, 32, tile, [0, 4], [0, 16], [0, 16], "cpu",
                          _blend_factors((2, 2, 2), tile, 2))
    tiles = torch.zeros((8, 2) + tile, dtype=torch.float16, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        blend_stitch_3d(tiles.to(memory_format=torch.channels_last_3d), 1, plan)
    with pytest.raises(ValueError, match="plan"):
        blend_stitch_3d(tiles, 1, cpu_plan)
    with pytest.raises(ValueError, match="float32/bfloat16"):
        sigmoid_stitch_3d(tiles[:, :1].contiguous(), plan)
    vol = torch.zeros((1, 8, 32, 32), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="plan"):
        normalize_tile_3d(vol, torch.zeros((4, 1), device=cuda), cpu_plan, 8)
    with pytest.raises(ValueError, match="bounds"):
        normalize_tile_3d(vol, torch.zeros((4, 1), device="cpu"), plan, 8)


def _3d_checkpoint(tmp_path, cls, name, **hyper):
    net = init_weights_(cls(n_filter=4, **hyper), torch.Generator().manual_seed(0),
                        random_bn_stats=True)
    path = str(tmp_path / f"{name}.pt")
    torch.save({"state_dict": net.state_dict(), "model_name": name, "n_filter": 4, **hyper}, path)
    return path


@pytest.mark.parametrize("dtype,shape,add,interp", [
    (np.uint8, (16, 64, 64), 0, False), (np.uint16, (12, 40, 36), 1, True),
    (np.float32, (6, 40, 40), 0, False)])
def test_predict_3d_on_card_matches_cpu(cuda, gen, tmp_path, dtype, shape, add, interp):
    """``Predict3D`` on the card (K1 → K2v → forward → K3v) against the CPU
    (plain versions, CPU convolutions), float32 with TF32 off: within one
    level on at most 0.1% of voxels; fused against host-staged on the card
    within the same contract."""
    path = _3d_checkpoint(tmp_path, UNet3D, "UNet3D", use_interpolation=interp)
    vol = _frames(gen, dtype, shape)
    kw = dict(resize_dim=(8, 32, 32), add_patch=add, show_progress=False)
    counters = (hist.int_clip_bounds, hist.float_clip_bounds, normalize_tile_3d,
                sigmoid_stitch_3d)
    before = [c.launches for c in counters]
    card = Predict3D(vol, None, path, **kw).result
    ran = [c.launches - b for c, b in zip(counters, before)]
    assert ran[0] + ran[1] > 0 and ran[2] == 1 and ran[3] == 1, ran
    cpu = Predict3D(vol, None, path, device="cpu", **kw).result
    host = Predict3D(vol, None, path, device_pipeline=False, **kw).result
    for other in (cpu, host):
        assert card.shape == other.shape == shape and card.dtype == other.dtype == np.uint8
        diff = np.abs(card.astype(int) - other.astype(int))
        assert diff.max() <= 1 and np.mean(diff > 0) <= 1e-3


@pytest.mark.parametrize("mode,dtype,interp", [
    ("single", np.uint8, True), ("first", np.uint16, False), ("all", np.float32, True)])
def test_predict_multi_output_3d_on_card_matches_cpu(cuda, gen, tmp_path, mode, dtype, interp):
    """``PredictMultiOutput3D`` on the card (K1 → K2v → forward → K5v)
    against the CPU, float32 with TF32 off, and the card's fused path against
    its host-staged path: within atol 2e-3 + 1e-3·|CPU| (float16 heads)."""
    heads = {"mask": {"channels": 1, "activation": "sigmoid"},
             "vec": {"channels": 2, "activation": None}}
    path = _3d_checkpoint(tmp_path, MultiOutputUnet3D, "MultiOutputUnet3D", output_heads=heads,
                          use_interpolation=interp)
    vols = _frames(gen, dtype, (2, 12, 40, 36))
    kw = dict(max_patch_size=(8, 32, 32), normalization_mode=mode, blend_margin=4,
              show_progress=False)
    before = blend_stitch_3d.launches, normalize_tile_3d.launches
    card = PredictMultiOutput3D(vols, path, **kw).result
    assert (blend_stitch_3d.launches - before[0], normalize_tile_3d.launches - before[1]) == (2, 1)
    cpu = PredictMultiOutput3D(vols, path, device="cpu", **kw).result
    host = PredictMultiOutput3D(vols, path, device_pipeline=False, **kw).result
    for head, cfg in heads.items():
        want = vols.shape if cfg["channels"] == 1 else (2, 2) + vols.shape[1:]
        assert card[head].shape == cpu[head].shape == host[head].shape == want
        for other in (cpu[head], host[head]):
            np.testing.assert_allclose(card[head], other, atol=2e-3, rtol=1e-3, err_msg=head)


# --- 3D training: K4v, K4hv -----------------------------------------------------------

K4V_CASES = [
    # (id, volumes in the set, batch, image channels, mask channels, z, width, gauss)
    ("main-path", 40, 4, 1, 1, 16, 64, None),
    ("odd-width-gauss", 7, 5, 2, 3, 5, 30, 0.04),
]


def _force_cases(d, b, device):
    """Every (k, flip_h, flip_v) case the batch has room for, gate on, and the
    last sample gated off."""
    for i, (k, fh, fv) in enumerate(itertools.product(range(4), (0, 1), (0, 1))):
        if i < b - 1:
            d.flags[i, :4] = torch.tensor([1, k, fh, fv], dtype=torch.int32, device=device)
    d.flags[b - 1, 0] = 0


@pytest.mark.parametrize("case", K4V_CASES, ids=[c[0] for c in K4V_CASES])
def test_augment_volume_kernel_equals_plain(cuda, case):
    """K4v against its plain version on the same draws, gathering a
    non-trivial index (repeats, out of order) from a resident volume set, one
    sample gated off: masks bit-equal, images within one float32 ulp; without
    an index the batch itself is augmented."""
    _, n, b, ci, co, z, s, sigma = case
    g = torch.Generator(device=cuda).manual_seed(0)
    image = torch.rand((n, ci, z, s, s), generator=g, device=cuda)
    mask = (torch.rand((n, co, z, s, s), generator=g, device=cuda) > 0.5).float()
    index = torch.randint(0, n, (b,), generator=g, device=cuda)
    index[-1] = index[0]
    d = draw(g, b, (b, ci, z, s, s), gauss_sigma=sigma)
    _force_cases(d, b, cuda)
    before = augment_volume_apply.launches, augment_apply.launches
    ours = augment_volume_apply(image, mask, d, index=index)
    torch.cuda.synchronize()
    assert (augment_volume_apply.launches, augment_apply.launches) == (before[0] + 1, before[1])
    ref = augment_apply_plain(image, mask, d, index=index)
    assert torch.equal(ours[1], ref[1])
    assert _ulps(ours[0], ref[0]) <= 1
    assert torch.equal(ours[0][b - 1], image[index[b - 1]])  # gated off: untouched
    whole = augment_volume_apply(image[:b].contiguous(), mask[:b].contiguous(), d)
    plain = augment_apply_plain(image[:b], mask[:b], d)
    assert torch.equal(whole[1], plain[1]) and _ulps(whole[0], plain[0]) <= 1


K4HV_CASES = [
    # (id, volumes in the set, batch, z, width, head channels)
    ("coverage-path", 16, 2, 32, 128, {"mask": 1, "orientation": 2}),
    ("odd-width", 6, 5, 5, 18, {"orientation": 2, "mask": 1}),
    ("two-orientation-heads", 5, 4, 3, 12, {"orientation": 2, "orientation_b": 2}),
]


@pytest.mark.parametrize("case", K4HV_CASES, ids=[c[0] for c in K4HV_CASES])
def test_augment_heads_volume_kernel_equals_plain(cuda, case):
    """K4hv against its plain version on the same draws, with an index, the
    (k, flip) cases forced where the batch allows and one sample gated off:
    targets equal (zeros by value), image within one float32 ulp; the
    orientation pairs' partners are Z planes apart."""
    _, n, b, z, s, channels = case
    g = torch.Generator(device=cuda).manual_seed(1)
    layout = HeadLayout.of(channels, [k for k in channels if "orientation" in k], cuda)
    image = torch.rand((n, 1, z, s, s), generator=g, device=cuda)
    parts = []
    for name, c in channels.items():
        if "orientation" in name:
            theta = torch.rand((n, 1, z, s, s), generator=g, device=cuda) * 6.2832
            parts.append(torch.cat([theta.cos(), theta.sin()], 1))
        else:
            parts.append((torch.rand((n, c, z, s, s), generator=g, device=cuda) > 0.5).float())
    target = torch.cat(parts, 1).contiguous()
    index = torch.randint(0, n, (b,), generator=g, device=cuda)
    index[-1] = index[0]
    d = draw(g, b, (b, 1, z, s, s), gauss_sigma=0.04)
    _force_cases(d, b, cuda)
    before = augment_heads_volume_apply.launches, augment_heads_apply.launches
    ours = augment_heads_volume_apply(image, target, layout.codes, d, index=index)
    torch.cuda.synchronize()
    assert (augment_heads_volume_apply.launches, augment_heads_apply.launches) == (
        before[0] + 1, before[1])
    ref = augment_heads_apply_plain(image, target, layout.codes, d, index=index)
    assert torch.equal(ours[1], ref[1])
    assert _ulps(ours[0], ref[0]) <= 1
    assert torch.equal(ours[1][b - 1], target[index[b - 1]])
    whole = augment_heads_volume_apply(image[:b].contiguous(), target[:b].contiguous(),
                                       layout.codes, d)
    assert torch.equal(whole[1], augment_heads_apply_plain(image[:b], target[:b],
                                                           layout.codes, d)[1])


def test_volume_augment_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.zeros((4, 1, 3, 16, 16), device=cuda)
    t = torch.zeros((4, 3, 3, 16, 16), device=cuda)
    layout = HeadLayout.of({"mask": 1, "orientation": 2}, ("orientation",), cuda)
    d = draw(torch.Generator(device=cuda), 4, (4, 1, 3, 16, 16))
    with pytest.raises(ValueError, match="float32"):
        augment_volume_apply(x.double(), x, d)
    with pytest.raises(ValueError, match="CUDA tensor"):
        augment_volume_apply(x, x.cpu(), d)
    with pytest.raises(ValueError, match="int64"):
        augment_volume_apply(x, x, d, index=torch.zeros(4, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="field"):
        augment_volume_apply(x, x, d, index=torch.zeros(2, dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError, match="pair form"):
        augment_apply(x, x, draw(torch.Generator(device=cuda), 4, (4, 1, 3, 16, 16), prev=True),
                      prev=x)
    with pytest.raises(ValueError, match="int32"):
        augment_heads_volume_apply(x, t, layout.codes.long(), d)
    with pytest.raises(ValueError, match="contiguous"):
        augment_heads_volume_apply(x, t.to(memory_format=torch.channels_last_3d), layout.codes, d)


class _Volumes:
    def __init__(self, n=10, shape=(8, 16, 16), heads=False):
        rng = np.random.default_rng(0)
        xx, yy = np.meshgrid(np.arange(shape[1]), np.arange(shape[2]), indexing="ij")
        self.items = []
        for _ in range(n):
            mask = (rng.random(shape) > 0.7).astype(np.float32)
            item = {"volume": np.clip(0.5 * mask + 0.5 * rng.random(shape), 0, 1)
                    .astype(np.float32)[None], "mask": mask[None]}
            if heads:
                theta = np.broadcast_to(np.arctan2(yy - rng.uniform(0, shape[1]),
                                                   xx - rng.uniform(0, shape[2])), shape)
                item["orientation"] = np.stack([np.cos(theta), np.sin(theta)]).astype(np.float32)
            self.items.append(item)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


@pytest.mark.parametrize("network,cache", [("UNet3D", False), ("MultiOutputUnet3D", True)])
def test_3d_trainer_on_card_matches_cpu(cuda, tmp_path, network, cache):
    """2 steps and a validation pass of a 3D Trainer on the card against the
    CPU, float32 with TF32 off: ``metrics.csv`` within rtol 1e-3."""
    heads = HEAD_LOSSES if network == "MultiOutputUnet3D" else None
    rows = {}
    for dev in ("cuda", "cpu"):
        out = tmp_path / dev
        t = Trainer(_Volumes(heads=heads is not None), 1, network=network, n_filter=4,
                    output_heads=heads, time_loss_weight=None if heads else 0.1, batch_size=4,
                    lr=1e-4, save_dir=str(out), seed=0, device=dev, device_cache=cache)
        t.start()
        with open(os.path.join(out, "metrics.csv")) as fh:
            rows[dev] = np.array([[float(v) for v in r[1:3]] for r in list(csv.reader(fh))[1:]])
    np.testing.assert_allclose(rows["cuda"], rows["cpu"], rtol=1e-3)


@pytest.mark.parametrize("network", ["UNet3D", "MultiOutputUnet3D"])
def test_3d_trainer_on_card_with_augment_and_bf16(cuda, tmp_path, network):
    """bf16, resident volumes, K4v (or K4hv with heads) once per step and no
    2D augmentation kernel; the checkpoint it writes predicts on the card."""
    heads = network == "MultiOutputUnet3D"
    counters = (augment_volume_apply, augment_heads_volume_apply, augment_apply,
                augment_heads_apply)
    before = [c.launches for c in counters]
    t = Trainer(_Volumes(n=20, heads=heads), 2, network=network, n_filter=8,
                output_heads=HEAD_LOSSES if heads else None, batch_size=4, lr=1e-3,
                save_dir=str(tmp_path), seed=0, device_cache=True, device_augment=True,
                half_precision=True)
    t.start()
    steps = 2 * (16 // 4)
    assert [c.launches - b for c, b in zip(counters, before)] == (
        [0, steps, 0, 0] if heads else [steps, 0, 0, 0])
    assert all(np.isfinite(h["train_loss"]) for h in t.history)
    vol = np.random.default_rng(1).integers(0, 255, (12, 40, 36), dtype=np.uint8)
    if heads:
        res = PredictMultiOutput3D(vol, str(tmp_path / "model.pt"), max_patch_size=(8, 16, 16),
                                   show_progress=False).result
        assert res["mask"].shape == vol.shape and res["orientation"].shape == (2,) + vol.shape
    else:
        res = Predict3D(vol, None, str(tmp_path / "model.pt"), resize_dim=(8, 16, 16),
                        show_progress=False).result
        assert res.shape == vol.shape


# --- Siam: K1 pair rows, K2p, K6, PredictSiam ------------------------------------

K2P_CASES = [
    # name, dtype, block (k+1, h, w), tile, add_tile, bounds ('single' per frame,
    # 'pair' per pair), invert
    ("u8-exact-single", np.uint8, (9, 256, 256), 64, 0, "single", False),
    ("u16-gather-pair", np.uint16, (4, 100, 90), 64, 1, "pair", False),
    ("f32-zero-pad-invert", np.float32, (3, 40, 50), 64, 0, "pair", True),
    ("u8-odd-width-zero-pad", np.uint8, (3, 30, 37), 38, 0, "single", True),
]


@pytest.mark.parametrize("case", K2P_CASES, ids=[c[0] for c in K2P_CASES])
def test_pair_bounds_and_normalize_tile_pairs_kernels_equal_plain(cuda, gen, case):
    name, dtype, shape, tile, add, kind, invert = case
    block = torch.from_numpy(_frames(gen, dtype, shape))
    k, h, w = shape[0] - 1, shape[1], shape[2]
    dev = block.to(cuda)
    pair = hist.pair_clip_bounds(dev, 0.5, 99.5)
    torch.cuda.synchronize()
    assert np.array_equal(_bits(pair), _bits(hist.pair_clip_bounds(block, 0.5, 99.5)))
    bounds = hist.clip_bounds(dev, 0.5, 99.5) if kind == "single" else pair
    plan = TilePlan(h, w, tile, tile, grid_starts(h, tile, add), grid_starts(w, tile, add), cuda)
    n_total = k * plan.per_frame + 5
    ours = normalize_tile_pairs(dev, bounds, plan, n_total, invert)
    torch.cuda.synchronize()
    ref = normalize_tile_pairs_plain(dev, bounds, plan, n_total, invert)
    assert ours.shape == (2, n_total, tile, tile)
    assert torch.equal(ours, ref), name


XCORR_CASES = [
    # (B, C, H, W), kernel (kh, kw), dtype, channels_last
    ((4, 64, 16, 16), (16, 16), torch.bfloat16, True),
    ((2, 40, 32, 32), (32, 32), torch.float32, False),
    ((3, 5, 7, 6), (3, 4), torch.float32, True),
    ((1, 3, 100, 100), (100, 100), torch.float32, False),
    # the plane form: above the tiled staging's 112², up to the largest plane
    # and kernel whose float32 values fit a block
    ((1, 2, 128, 128), (128, 128), torch.float32, False),
    ((1, 2, 120, 113), (120, 113), torch.bfloat16, True),
    ((1, 1, 170, 170), (170, 170), torch.float32, False),
]


@pytest.mark.parametrize("case", XCORR_CASES, ids=lambda c: f"{c[0]}-{c[2]}")
def test_depthwise_xcorr_kernel_matches_plain(cuda, case):
    shape, kernel, dtype, cl = case
    g = torch.Generator(device=cuda).manual_seed(1)
    cur = torch.randn(shape, generator=g, device=cuda).to(dtype)
    prev = torch.randn(shape[:2] + kernel, generator=g, device=cuda).to(dtype)
    if cl:
        cur = cur.contiguous(memory_format=torch.channels_last)
        prev = prev.contiguous(memory_format=torch.channels_last)
    ours = depthwise_xcorr(cur, prev)
    torch.cuda.synchronize()
    ref = depthwise_xcorr_plain(cur, prev)
    assert ours.dtype == dtype and ours.stride() == cur.stride()
    if dtype == torch.float32:
        # the same float32 order; any other within 1e-5 of the sum of |a·b|
        bound = depthwise_xcorr_plain(cur.abs(), prev.abs())
        assert ((ours - ref).abs() <= 1e-5 * bound).all()
    else:  # one bf16 ulp
        ulp = torch.finfo(torch.bfloat16).eps * ref.float().abs().clamp_min(1e-30)
        assert ((ours.float() - ref.float()).abs() <= ulp).all()
    assert torch.equal(ours, ref)  # the plain version's order and rounding


# every XCORR_CASES shape and the Siam paths' (the bf16 forward batch at 256²
# tiles, PredictSiam's float32 default at 512² tiles, the wider float32 timing
# shape), each in both memory formats, with even and odd kernels
XCORR_FORMAT_CASES = [(c[0], c[1], c[2]) for c in XCORR_CASES] + [
    ((128, 256, 16, 16), (16, 16), torch.bfloat16), ((32, 256, 32, 32), (32, 32), torch.float32),
    ((16, 1024, 32, 32), (32, 32), torch.float32), ((2, 7, 9, 11), (4, 6), torch.bfloat16),
    ((3, 33, 12, 20), (12, 20), torch.float32), ((1, 2, 1, 5), (1, 5), torch.float32)]


@pytest.mark.parametrize("channels_last", [False, True], ids=["nchw", "channels_last"])
@pytest.mark.parametrize("case", XCORR_FORMAT_CASES, ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}")
def test_depthwise_xcorr_kernel_bit_equal_to_plain_in_both_formats(cuda, case, channels_last):
    shape, kernel, dtype = case
    g = torch.Generator(device=cuda).manual_seed(2)
    cur = torch.randn(shape, generator=g, device=cuda).to(dtype)
    prev = torch.randn(shape[:2] + kernel, generator=g, device=cuda).to(dtype)
    if channels_last:
        cur = cur.contiguous(memory_format=torch.channels_last)
        prev = prev.contiguous(memory_format=torch.channels_last)
    before = depthwise_xcorr.launches
    ours = depthwise_xcorr(cur, prev)
    torch.cuda.synchronize()
    assert depthwise_xcorr.launches == before + 1
    assert ours.dtype == dtype and ours.stride() == cur.stride()
    assert torch.equal(ours, depthwise_xcorr_plain(cur, prev))


def test_depthwise_xcorr_refuses_what_the_kernel_does_not_take(cuda):
    big = torch.zeros((1, 1, 200, 200), device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        depthwise_xcorr(big, big)
    # one row past the plane form's largest plane with a 170² kernel
    with pytest.raises(ValueError, match="shared memory"):
        depthwise_xcorr(torch.zeros((1, 1, 171, 171), device=cuda),
                        torch.zeros((1, 1, 170, 170), device=cuda))
    # with a gradient the forward still launches K6 (its backward is K6b);
    # K6b refuses what its staging does not fit
    x = torch.zeros((1, 2, 8, 8), device=cuda, requires_grad=True)
    before = depthwise_xcorr.launches
    assert depthwise_xcorr(x, x).requires_grad and depthwise_xcorr.launches == before + 1
    g = torch.zeros((1, 1, 171, 171), device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        depthwise_xcorr_grad_kernel(g, g, (3, 3))


# K6b: the Siam trainer's shapes (bf16 (12, 256, 16, 16), the facade's
# float32 batch 4), odd and even kernels, a plane larger than its kernel, a
# kernel larger than its plane, the largest planes the staging takes
XCORR_GRAD_CASES = [
    ((12, 256, 16, 16), (16, 16), torch.bfloat16), ((4, 256, 16, 16), (16, 16), torch.float32),
    ((3, 5, 7, 7), (7, 7), torch.float32), ((2, 7, 9, 11), (4, 6), torch.bfloat16),
    ((2, 6, 24, 20), (5, 3), torch.float32), ((1, 3, 4, 5), (7, 6), torch.bfloat16),
    ((1, 2, 170, 170), (9, 9), torch.float32)]


@pytest.mark.parametrize("channels_last", [False, True], ids=["nchw", "channels_last"])
@pytest.mark.parametrize("case", XCORR_GRAD_CASES, ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}")
def test_depthwise_xcorr_grad_kernels_bit_equal_to_plain(cuda, case, channels_last):
    shape, kernel, dtype = case
    g = torch.Generator(device=cuda).manual_seed(5)
    cur, grad = (torch.randn(shape, generator=g, device=cuda).to(dtype) for _ in range(2))
    prev = torch.randn(shape[:2] + kernel, generator=g, device=cuda).to(dtype)
    if channels_last:
        cur, grad, prev = (t.contiguous(memory_format=torch.channels_last)
                           for t in (cur, grad, prev))
    before = (depthwise_xcorr_grad_input.launches, depthwise_xcorr_grad_kernel.launches)
    d_cur = depthwise_xcorr_grad_input(grad, prev)
    d_prev = depthwise_xcorr_grad_kernel(grad, cur, kernel)
    torch.cuda.synchronize()
    assert (depthwise_xcorr_grad_input.launches,
            depthwise_xcorr_grad_kernel.launches) == (before[0] + 1, before[1] + 1)
    assert d_cur.dtype == d_prev.dtype == dtype and d_prev.shape == shape[:2] + kernel
    assert torch.equal(d_cur, depthwise_xcorr_grad_input_plain(grad, prev))
    assert torch.equal(d_prev, depthwise_xcorr_grad_kernel_plain(grad, cur, kernel))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_depthwise_xcorr_gradient_on_card_equals_cpu(cuda, dtype):
    """The autograd Function on the card (K6 forward, K6b backward) against
    the same on the CPU (the plain versions): bit-equal, channels_last."""
    gen = torch.Generator().manual_seed(9)
    cur, prev, grad = (torch.randn((3, 8, 16, 16), generator=gen).to(dtype) for _ in range(3))
    got = {}
    for dev in ("cuda", "cpu"):
        c, p = (t.to(dev).contiguous(memory_format=torch.channels_last).requires_grad_()
                for t in (cur, prev))
        out = depthwise_xcorr(c, p)
        got[dev] = (out, *torch.autograd.grad(out, (c, p), grad.to(dev)))
    for a, b in zip(got["cuda"], got["cpu"]):
        assert torch.equal(a.detach().cpu(), b.detach())


@pytest.mark.parametrize("mode", ["corr", "max"])
def test_siam_trainer_on_card_matches_cpu(cuda, tmp_path, mode):
    """3 steps of ``Siam_UNet(8)`` in float32 (TF32 off) on the card against
    the CPU; under ``corr`` each step launches K6 once and each K6b form
    once, under ``max`` none."""
    rng = np.random.default_rng(0)
    items = []
    for _ in range(15):
        img, m = blob_sample(rng, (64, 64))
        prev = np.roll(img, 2, 0)
        items.append({k: (v / 255.0).astype(np.float32)[None]
                      for k, v in (("image", img), ("mask", m), ("prev_image", prev))})
    rows = {}
    for dev in ("cuda", "cpu"):
        counts = [depthwise_xcorr.launches, depthwise_xcorr_grad_input.launches,
                  depthwise_xcorr_grad_kernel.launches]
        t = siam_unet.Trainer(items, 1, n_filter=8, mode=mode, batch_size=4, lr=1e-4,
                              save_dir=str(tmp_path / dev), seed=0, device=dev, val_split=0.2)
        t.start()
        counts = [c.launches - n for c, n in zip(
            (depthwise_xcorr, depthwise_xcorr_grad_input, depthwise_xcorr_grad_kernel), counts)]
        if dev == "cuda":
            # 3 training steps and one validation batch of 3
            assert counts == ([4, 3, 3] if mode == "corr" else [0, 0, 0]), counts
        with open(os.path.join(tmp_path / dev, "metrics.csv")) as fh:
            rows[dev] = np.array([[float(v) for v in r[1:3]] for r in list(csv.reader(fh))[1:]])
    np.testing.assert_allclose(rows["cuda"], rows["cpu"], rtol=1e-3)


@pytest.mark.parametrize("mode,dtype,norm,add", [
    ("max", np.uint8, "single", 0), ("corr", np.uint16, "all", 1),
    ("concat", np.float32, "first", 0), ("control", np.uint8, "single", 0)])
def test_predict_siam_on_card_matches_cpu(cuda, gen, tmp_path, mode, dtype, norm, add):
    net = init_weights_(Siam_UNet(n_filter=8, mode=mode), torch.Generator().manual_seed(3),
                        random_bn_stats=True)
    ckpt = str(tmp_path / "siam.pt")
    torch.save({"state_dict": net.state_dict(), "model_name": "Siam_UNet", "n_filter": 8,
                "mode": mode}, ckpt)
    src = str(tmp_path / "movie.tif")
    tiff.imwrite(src, _frames(gen, dtype, (5, 100, 90)))
    kw = dict(resize_dim=(64, 64), add_tile=add, normalization_mode=norm, frames_per_chunk=2,
              show_progress=False, device_pipeline=True if dtype == np.float32 else None)
    for pipeline in (kw.pop("device_pipeline"), False):
        card, cpu = str(tmp_path / "card.tif"), str(tmp_path / "cpu.tif")
        siam_unet.Predict(src, card, ckpt, device_pipeline=pipeline, **kw)
        siam_unet.Predict(src, cpu, ckpt, device_pipeline=pipeline, device="cpu", **kw)
        diff = np.abs(tiff.imread(card).astype(int) - tiff.imread(cpu).astype(int))
        assert diff.max() <= 1 and np.mean(diff > 0) <= 1e-3, (pipeline, diff.max())


# --- K7–K10: the int8 trunk ---------------------------------------------------------

def _i8(gen, shape, dev):
    return torch.from_numpy(gen.integers(-127, 128, shape).astype(np.int8)).to(dev)


def _packed(gen, lead, cin, dev):
    w = np.zeros(lead + (32 * -(-cin // 32),), np.int8)
    w[..., :cin] = gen.integers(-127, 128, lead + (cin,))
    return torch.from_numpy(w).to(dev)


# (n, h, w, cin, cout, dilation); the later cases reach the tensor-core
# kernel's edges: M not a multiple of the 128-row tile, cin 48 (16-byte chunks,
# not whole k32 steps), dilation 4, cin 512 (72 stages: the 4-stage ring
# wraps 18 times), 16- and 8-wide output tiles, 8-byte input copies (cin 40)
QCONV_CASES = [(3, 17, 19, 32, 32, 1), (2, 9, 11, 6, 5, 2), (2, 12, 10, 33, 70, 1),
               (4, 8, 8, 64, 128, 2), (1, 16, 16, 512, 512, 1), (2, 16, 16, 4, 4, 1),
               (1, 9, 13, 48, 40, 1), (2, 12, 12, 64, 64, 4), (3, 16, 16, 512, 128, 1),
               (1, 10, 7, 16, 8, 1), (2, 11, 9, 40, 16, 1), (1, 5, 27, 64, 256, 1)]


@pytest.mark.parametrize("case", QCONV_CASES, ids=lambda c: "x".join(map(str, c)))
def test_qconv3x3_kernel_bit_equal_to_plain(cuda, gen, case):
    n, h, w, cin, cout, dil = case
    x = _i8(gen, (n, h, w, cin), cuda)
    wt = _packed(gen, (cout, 3, 3), cin, cuda)
    sw = torch.from_numpy((gen.random(cout) * 1e-3 + 1e-4).astype(np.float32)).to(cuda)
    bias = torch.from_numpy(gen.standard_normal(cout).astype(np.float32)).to(cuda)
    before = k8.qconv3x3.launches
    got = k8.qconv3x3(x, wt, sw, bias, 0.0213, 0.0371, dil)
    torch.cuda.synchronize()
    assert k8.qconv3x3.launches == before + 1
    want = k8.qconv3x3_plain(x, wt, sw, bias, 0.0213, 0.0371, dil)
    assert torch.equal(got, want)
    assert got.abs().max() > 0 and (got.abs() < 127).any()  # neither all zero nor all clipped


def _unaligned_i8(gen, shape, shift, dev):
    """An int8 tensor ``shift`` bytes past a 256-byte-aligned allocation."""
    flat = _i8(gen, (int(np.prod(shape)) + shift,), dev)
    return flat[shift:].view(shape)


@pytest.mark.parametrize("cin,shift", [(32, 4), (40, 8), (32, 1), (64, 2)])
def test_qconv3x3_kernel_bit_equal_to_plain_on_unaligned_input(cuda, gen, cin, shift):
    # the input's copies narrow to 8 or 4 bytes, or byte loads, with the address
    x = _unaligned_i8(gen, (2, 7, 9, cin), shift, cuda)
    wt = _packed(gen, (24, 3, 3), cin, cuda)
    sw = torch.from_numpy((gen.random(24) * 1e-3 + 1e-4).astype(np.float32)).to(cuda)
    bias = torch.from_numpy(gen.standard_normal(24).astype(np.float32)).to(cuda)
    before = k8.qconv3x3.launches
    got = k8.qconv3x3(x, wt, sw, bias, 0.0213, 0.0371)
    torch.cuda.synchronize()
    assert k8.qconv3x3.launches == before + 1
    assert torch.equal(got, k8.qconv3x3_plain(x, wt, sw, bias, 0.0213, 0.0371))


@pytest.mark.parametrize("case", [(2, 5, 6, 16, 8, 4), (1, 7, 3, 5, 3, 6), (3, 8, 8, 40, 36, 36),
                                  (2, 16, 16, 512, 256, 256), (1, 5, 7, 64, 32, 32),
                                  (3, 9, 11, 128, 64, 64)],
                         ids=lambda c: "x".join(map(str, c)))
def test_qconvt2x2_kernel_bit_equal_to_plain(cuda, gen, case):
    n, h, w, cin, cout, cskip = case
    x = _i8(gen, (n, h, w, cin), cuda)
    wt = _packed(gen, (2, 2, cout), cin, cuda)
    sw = torch.full((cout,), 0.0042, device=cuda)
    bias = torch.from_numpy(gen.standard_normal(cout).astype(np.float32)).to(cuda)
    bufs = [torch.full((n, 2 * h, 2 * w, cout + cskip), 99, dtype=torch.int8, device=cuda)
            for _ in range(2)]
    before = k8.qconvt2x2.launches
    k8.qconvt2x2(x, wt, sw, bias, 0.031, 0.057, out=bufs[0], offset=0)
    k8.qconvt2x2_plain(x, wt, sw, bias, 0.031, 0.057, out=bufs[1], offset=0)
    torch.cuda.synchronize()
    assert k8.qconvt2x2.launches == before + 1
    assert torch.equal(bufs[0], bufs[1]) and (bufs[0][..., cout:] == 99).all()


# (rank, n, spatial, cin, cout, buffer channels, offset): odd row strides and
# offsets, so the staged output is written a byte at a time
TCONV_OFFSET_CASES = [(2, 2, (5, 6), 32, 16, 23, 7), (2, 1, (6, 5), 64, 32, 65, 33),
                      (3, 1, (2, 3, 5), 32, 16, 25, 9), (3, 2, (3, 4, 4), 16, 8, 13, 5)]


@pytest.mark.parametrize("case", TCONV_OFFSET_CASES, ids=lambda c: "x".join(map(str, c[:2] + c[2]
                                                                                   + c[3:])))
def test_qconvt_kernels_into_a_concat_buffer_at_an_offset(cuda, gen, case):
    rank, n, spatial, cin, cout, width, offset = case
    x = _i8(gen, (n,) + spatial + (cin,), cuda)
    wt = _packed(gen, (2,) * rank + (cout,), cin, cuda)
    sw = torch.full((cout,), 0.0042 if rank == 2 else 0.00042, device=cuda)
    bias = torch.from_numpy(gen.standard_normal(cout).astype(np.float32)).to(cuda)
    bufs = [torch.full((n,) + tuple(2 * e for e in spatial) + (width,), 99, dtype=torch.int8,
                       device=cuda) for _ in range(2)]
    if rank == 2:
        kern, args = k8.qconvt2x2, (0.031, 0.057)
        plain = k8.qconvt2x2_plain
    else:
        kern, args = k8.qconvt2x2x2, (0.057,)
        plain = k8.qconvt2x2x2_plain
    before = kern.launches
    kern(x, wt, sw, bias, *args, out=bufs[0], offset=offset)
    plain(x, wt, sw, bias, *args, out=bufs[1], offset=offset)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    assert torch.equal(bufs[0], bufs[1])
    assert (bufs[0][..., :offset] == 99).all() and (bufs[0][..., offset + cout:] == 99).all()


def test_requant_kernel_bit_equal_to_plain_in_all_three_forms(cuda, gen):
    e1 = torch.from_numpy((gen.standard_normal((3, 20, 22, 6)) * 4).astype(np.float32))
    e1 = e1.to(cuda).bfloat16()
    assert torch.equal(k8.requant(e1, 1.0, 0.0311), k8.requant_plain(e1, 1.0, 0.0311))
    f = torch.from_numpy((gen.standard_normal((2, 9, 7, 5)) * 4).astype(np.float32)).to(cuda)
    assert torch.equal(k8.requant(f, 1.0, 0.0311), k8.requant_plain(f, 1.0, 0.0311))
    skip = _i8(gen, (3, 20, 22, 7), cuda)
    bufs = [torch.full((3, 20, 22, 12), 5, dtype=torch.int8, device=cuda) for _ in range(2)]
    k8.requant(skip, 0.0371, 0.0413, out=bufs[0], offset=5)
    k8.requant_plain(skip, 0.0371, 0.0413, out=bufs[1], offset=5)
    assert torch.equal(bufs[0], bufs[1]) and (bufs[0][..., :5] == 5).all()
    got, want = k8.requant(skip, 0.0371), k8.requant_plain(skip, 0.0371)
    assert got.dtype == want.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("shape", [(4, 32, 32, 32), (2, 9, 7, 3), (3, 16, 16, 256)])
def test_maxpool_i8_kernel_equal_to_plain(cuda, gen, shape):
    x = _i8(gen, shape, cuda)
    assert torch.equal(k8.maxpool_i8(x), k8.maxpool_i8_plain(x))


# (n, h, w, buffer channels, channel range, K10's vector width): every width
# from a contiguous tensor and from channel ranges at offsets that force it;
# odd h and w floored
K10_WIDTHS = [(2, 8, 6, 32, (0, 32), 16), (2, 16, 16, 192, (0, 32), 16),
              (2, 16, 16, 192, (32, 64), 16), (2, 11, 13, 48, (16, 48), 16),
              (2, 5, 6, 24, (8, 16), 8), (3, 9, 7, 40, (0, 40), 8), (2, 6, 6, 24, (4, 8), 4),
              (1, 7, 5, 4, (0, 4), 4), (1, 6, 5, 24, (2, 4), 2), (2, 40, 30, 20, (2, 18), 2),
              (3, 9, 7, 3, (0, 3), 1), (2, 7, 9, 35, (3, 20), 1), (1, 1, 5, 16, (0, 16), 16)]


@pytest.mark.parametrize("case", K10_WIDTHS,
                         ids=lambda c: "x".join(map(str, c[:4])) + "-{}:{}".format(*c[4]))
def test_maxpool_i8_kernel_bit_equal_to_plain_at_every_width(cuda, gen, case):
    n, h, w, cbuf, (lo, hi), want = case
    flat = _i8(gen, (n * h * w * cbuf + 64,), cuda)
    base = (-flat.data_ptr()) % 64  # a 64-byte-aligned buffer
    x = flat[base:base + n * h * w * cbuf].view(n, h, w, cbuf)[..., lo:hi]
    out = torch.empty((n, h // 2, w // 2, hi - lo), dtype=torch.int8, device=cuda)
    assert k8._vec_width(x, cbuf, out, 0) == want
    before = k8.maxpool_i8.launches
    got = k8.maxpool_i8(x)
    torch.cuda.synchronize()
    assert k8.maxpool_i8.launches == before + 1
    assert torch.equal(got, k8.maxpool_i8_plain(x))


@pytest.mark.parametrize("shape", [(64, 256, 256, 32), (16, 511, 513, 8)])
def test_maxpool_i8_kernel_over_several_waves(cuda, gen, shape):
    # each thread of the one wave of blocks walks several vectors
    x = torch.randint(-128, 128, shape, dtype=torch.int8, device=cuda)
    assert torch.equal(k8.maxpool_i8(x), k8.maxpool_i8_plain(x))
    assert torch.equal(k8.maxpool_i8(x[..., 1:]), k8.maxpool_i8_plain(x[..., 1:]))


def test_int8_wrappers_refuse_what_the_kernels_do_not_take(cuda, gen):
    x = _i8(gen, (1, 8, 8, 8), cuda)
    wt = _packed(gen, (4, 3, 3), 8, cuda)
    sw, b = torch.ones(4, device=cuda), torch.zeros(4, device=cuda)
    with pytest.raises(ValueError, match="CUDA"):
        k8.qconv3x3(x, wt.cpu(), sw, b, 1.0, 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        k8.maxpool_i8(x.transpose(1, 2))
    with pytest.raises(ValueError, match="offset"):
        k8.requant(x, 1.0, 1.0, out=torch.zeros((1, 8, 8, 12), dtype=torch.int8, device=cuda),
                   offset=6)


@pytest.mark.parametrize("network,extra", [("Unet", {}), ("Unet", {"dilation": 2}),
                                           ("Siam_UNet", {"mode": "concat"})])
def test_quantized_predict_on_card_matches_cpu(cuda, gen, tmp_path, network, extra):
    cls = {"Unet": Unet, "Siam_UNet": Siam_UNet}[network]
    with torch.random.fork_rng():
        torch.manual_seed(5)
        net = cls(n_filter=8, **extra).train()
    with torch.no_grad():
        for _ in range(5):
            x = torch.rand((2, 1, 64, 64))
            net(x, torch.rand((2, 1, 64, 64))) if network == "Siam_UNet" else net(x)
    ckpt = str(tmp_path / "q.pt")
    torch.save({"state_dict": net.state_dict(), "model_name": network, "n_filter": 8,
                **extra}, ckpt)
    movie = _frames(gen, np.uint8, (4, 100, 90))
    kw = dict(resize_dim=(64, 64), show_progress=False, quantized=True)
    if network == "Siam_UNet":
        src = str(tmp_path / "m.tif")
        tiff.imwrite(src, movie)
        siam_unet.Predict(src, str(tmp_path / "card.tif"), ckpt, frames_per_chunk=2, **kw)
        siam_unet.Predict(src, str(tmp_path / "cpu.tif"), ckpt, frames_per_chunk=2,
                          device="cpu", **kw)
        card, cpu = tiff.imread(str(tmp_path / "card.tif")), tiff.imread(str(tmp_path / "cpu.tif"))
    else:
        card = Predict(movie, None, ckpt, **kw).result
        cpu = Predict(movie, None, ckpt, device="cpu", **kw).result
    d = np.abs(card.astype(int) - cpu.astype(int))
    assert d.max() <= 4 and d.mean() < 0.5 and (d > 1).mean() < 0.01, (d.max(), d.mean())


# --- K7v, K8v, K10v: the 3D int8 trunk ----------------------------------------------

# (n, d, h, w, cin, cout); the later cases: 16 -> 32 (four 16-channel taps
# a stage) and 32 -> 16 (the 16-wide tile) with M not a multiple of the
# 128-row tile, cin 48, and cin 384 -> 16
QCONV3D_CASES = [(2, 8, 16, 16, 16, 32), (2, 4, 8, 8, 384, 128), (1, 5, 7, 6, 6, 5),
                 (2, 4, 8, 8, 128, 256), (1, 8, 16, 16, 32, 16), (1, 3, 7, 9, 16, 32),
                 (2, 5, 6, 10, 32, 16), (1, 4, 5, 7, 48, 64), (1, 3, 8, 8, 384, 16)]


@pytest.mark.parametrize("case", QCONV3D_CASES, ids=lambda c: "x".join(map(str, c)))
def test_qconv3x3x3_kernel_bit_equal_to_plain(cuda, gen, case):
    n, d, h, w, cin, cout = case
    x = _i8(gen, (n, d, h, w, cin), cuda)
    wt = _packed(gen, (cout, 3, 3, 3), cin, cuda)
    sw = torch.from_numpy((gen.random(cout) * 1e-4 + 1e-5).astype(np.float32)).to(cuda)
    bias = torch.from_numpy(gen.standard_normal(cout).astype(np.float32)).to(cuda)
    before = k8.qconv3x3x3.launches
    got = k8.qconv3x3x3(x, wt, sw, bias, 0.0371)
    torch.cuda.synchronize()
    assert k8.qconv3x3x3.launches == before + 1
    want = k8.qconv3x3x3_plain(x, wt, sw, bias, 0.0371)
    assert torch.equal(got, want)
    assert got.abs().max() > 0 and (got.abs() < 127).any()  # neither all zero nor all clipped
    # into channels [2, 2 + O) of a wider buffer
    bufs = [torch.full((n, d, h, w, cout + 5), 99, dtype=torch.int8, device=cuda)
            for _ in range(2)]
    k8.qconv3x3x3(x, wt, sw, bias, 0.0371, out=bufs[0], offset=2)
    k8.qconv3x3x3_plain(x, wt, sw, bias, 0.0371, out=bufs[1], offset=2)
    assert torch.equal(bufs[0], bufs[1]) and torch.equal(bufs[0][..., 2:2 + cout], got)


@pytest.mark.parametrize("case", [(2, 2, 3, 4, 16, 8, 4), (1, 3, 5, 3, 5, 3, 6),
                                  (2, 4, 16, 16, 256, 256, 128), (2, 8, 32, 32, 64, 64, 32)],
                         ids=lambda c: "x".join(map(str, c)))
def test_qconvt2x2x2_kernel_bit_equal_to_plain(cuda, gen, case):
    n, d, h, w, cin, cout, cskip = case
    x = _i8(gen, (n, d, h, w, cin), cuda)
    wt = _packed(gen, (2, 2, 2, cout), cin, cuda)
    sw = torch.full((cout,), 0.00042, device=cuda)
    bias = torch.from_numpy(gen.standard_normal(cout).astype(np.float32)).to(cuda)
    bufs = [torch.full((n, 2 * d, 2 * h, 2 * w, cout + cskip), 99, dtype=torch.int8,
                       device=cuda) for _ in range(2)]
    before = k8.qconvt2x2x2.launches
    k8.qconvt2x2x2(x, wt, sw, bias, 0.057, out=bufs[0], offset=0)
    k8.qconvt2x2x2_plain(x, wt, sw, bias, 0.057, out=bufs[1], offset=0)
    torch.cuda.synchronize()
    assert k8.qconvt2x2x2.launches == before + 1
    assert torch.equal(bufs[0], bufs[1]) and (bufs[0][..., cout:] == 99).all()


@pytest.mark.parametrize("shape", [(4, 32, 32, 32, 32), (2, 9, 7, 5, 3), (3, 8, 16, 16, 128),
                                   (1, 5, 6, 7, 48)])
def test_maxpool_i8_3d_kernel_equal_to_plain(cuda, gen, shape):
    x = _i8(gen, shape, cuda)
    before = k8.maxpool_i8_3d.launches
    assert torch.equal(k8.maxpool_i8_3d(x), k8.maxpool_i8_3d_plain(x))
    assert k8.maxpool_i8_3d.launches == before + 1
    # an offset view: the 16-byte loads give way to byte loads
    flat = _i8(gen, (x.numel() + 1,), cuda)
    odd = flat[1:].view(shape)
    assert torch.equal(k8.maxpool_i8_3d(odd), k8.maxpool_i8_3d_plain(odd))


def test_int8_3d_wrappers_refuse_what_the_kernels_do_not_take(cuda, gen):
    x = _i8(gen, (1, 4, 8, 8, 8), cuda)
    wt = _packed(gen, (4, 3, 3, 3), 8, cuda)
    sw, b = torch.ones(4, device=cuda), torch.zeros(4, device=cuda)
    with pytest.raises(ValueError, match="CUDA"):
        k8.qconv3x3x3(x, wt.cpu(), sw, b, 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        k8.maxpool_i8_3d(x.transpose(2, 3))
    with pytest.raises(ValueError, match="CUDA"):
        k8.qconv3x3x3(x, wt, sw, b, 1.0, out=torch.zeros((1, 4, 8, 8, 4), dtype=torch.int8))


@pytest.mark.parametrize("network,extra", [("UNet3D", {}),
                                           ("UNet3D", {"use_interpolation": True}),
                                           ("MultiOutputUnet3D", {})])
def test_quantized_predict_3d_on_card_matches_cpu(cuda, gen, tmp_path, monkeypatch, network,
                                                  extra):
    monkeypatch.setenv("BIU_INT8_EXPERIMENTAL", "1")
    cls = {"UNet3D": UNet3D, "MultiOutputUnet3D": MultiOutputUnet3D}[network]
    with torch.random.fork_rng():
        torch.manual_seed(6)
        net = cls(n_filter=8, **extra).train()
    with torch.no_grad():
        for _ in range(5):
            net(torch.rand((2, 1, 16, 32, 32)))
    ckpt = str(tmp_path / "q3d.pt")
    heads = getattr(net, "heads", None)
    torch.save({"state_dict": net.state_dict(), "model_name": network, "n_filter": 8,
                "use_interpolation": net.use_interpolation,
                **({"output_heads": heads} if network == "MultiOutputUnet3D" else {})}, ckpt)
    zz, yy, xx = np.mgrid[0:24, 0:48, 0:48]
    vol = np.clip(30 + 180 * np.exp(-((zz - 12) ** 2 * 4 + (yy - 24) ** 2 + (xx - 24) ** 2)
                                    / 200.0) + 10 * gen.random((24, 48, 48)), 0, 255
                  ).astype(np.uint8)
    if network == "UNet3D":
        kw = dict(resize_dim=(16, 32, 32), show_progress=False, quantized=True)
        card = Predict3D(vol, None, ckpt, **kw)
        cpu = Predict3D(vol, None, ckpt, device="cpu", **kw)
        assert card.engine._quant_ready and cpu.engine._quant_ready
        d = np.abs(card.result.astype(int) - cpu.result.astype(int))
        assert d.max() <= 4 and d.mean() < 0.5 and (d > 1).mean() < 0.01, (d.max(), d.mean())
    else:
        kw = dict(max_patch_size=(16, 32, 32), show_progress=False, quantized=True)
        card = PredictMultiOutput3D(vol, ckpt, **kw)
        cpu = PredictMultiOutput3D(vol, ckpt, device="cpu", **kw)
        assert card.engine._quant_ready
        for head in cpu.result:
            rg = max(float(cpu.result[head].max() - cpu.result[head].min()), 0.5)
            d = np.abs(card.result[head] - cpu.result[head])
            assert d.max() / rg < 0.06 and d.mean() / rg < 0.01, (head, d.max(), rg)


# --- K11, K11v: the int8 x2 upsample into a concat buffer; K9 from a channel range ---

# (n, h, w, c, buffer channels, offset, input channels before and after the
# range read): 16-byte vectors, then 8, 4, 2 and 1 byte ones (the channel
# count, a row or the offset), odd extents; the last cases read a channel
# range of a wider tensor (a slot of the UNet++ grid's row buffer)
K11_CASES = [(4, 32, 32, 64, 128, 64, 0, 0), (2, 5, 7, 32, 48, 16, 0, 0),
             (3, 9, 4, 24, 40, 8, 0, 0), (2, 6, 6, 12, 16, 4, 0, 0), (1, 3, 5, 6, 10, 2, 0, 0),
             (2, 1, 2, 17, 17, 0, 0, 0), (2, 16, 16, 32, 33, 1, 0, 0),
             (2, 16, 16, 64, 192, 32, 64, 192), (1, 5, 7, 24, 40, 8, 3, 3),
             (2, 4, 3, 5, 7, 2, 1, 3)]


@pytest.mark.parametrize("case", K11_CASES, ids=lambda c: "x".join(map(str, c)))
def test_upsample2x_i8_kernel_bit_equal_to_plain(cuda, gen, case):
    n, h, w, c, ctot, off, pre, post = case
    x = _i8(gen, (n, h, w, pre + c + post), cuda)[..., pre:pre + c]
    bufs = [torch.full((n, 2 * h, 2 * w, ctot), 99, dtype=torch.int8, device=cuda)
            for _ in range(2)]
    before = k8.upsample2x_i8.launches
    k8.upsample2x_i8(x, out=bufs[0], offset=off)
    torch.cuda.synchronize()
    assert k8.upsample2x_i8.launches == before + 1
    k8.upsample2x_i8_plain(x, out=bufs[1], offset=off)
    assert torch.equal(bufs[0], bufs[1])
    assert torch.equal(k8.upsample2x_i8(x), k8.upsample2x_i8_plain(x))


# (n, d, h, w, c, buffer channels, offset)
# (n, d, h, w, C, output channels, offset): UNet3D(32)'s up3, up1 and up2
# widths, extents of 1 on each axis, and C, offsets and strides that 16 does
# not divide (vectors of 8, 4, 2 and 1 bytes)
K11V_CASES = [(2, 8, 16, 16, 64, 96, 0), (1, 3, 5, 7, 32, 48, 0), (2, 2, 3, 2, 6, 9, 3),
              (1, 1, 1, 4, 16, 16, 0), (2, 2, 4, 4, 256, 384, 0), (2, 4, 8, 8, 128, 192, 0),
              (2, 1, 5, 6, 64, 96, 0), (2, 5, 1, 6, 64, 96, 0), (2, 5, 6, 1, 64, 96, 0),
              (1, 3, 5, 7, 24, 40, 8), (1, 3, 4, 5, 12, 20, 4), (1, 2, 3, 4, 6, 10, 2),
              (2, 9, 10, 11, 48, 80, 32)]


@pytest.mark.parametrize("case", K11V_CASES, ids=lambda c: "x".join(map(str, c)))
def test_upsample2x_i8_3d_kernel_bit_equal_to_plain(cuda, gen, case):
    n, d, h, w, c, ctot, off = case
    x = _i8(gen, (n, d, h, w, c), cuda)
    # the extremes at the borders: -128 on the first plane, 127 on the last column
    x[:, 0], x[:, :, :, -1] = -128, 127
    bufs = [torch.full((n, 2 * d, 2 * h, 2 * w, ctot), 99, dtype=torch.int8, device=cuda)
            for _ in range(2)]
    before = k8.upsample2x_i8_3d.launches
    k8.upsample2x_i8_3d(x, out=bufs[0], offset=off)
    torch.cuda.synchronize()
    assert k8.upsample2x_i8_3d.launches == before + 1
    k8.upsample2x_i8_3d_plain(x, out=bufs[1], offset=off)
    assert torch.equal(bufs[0], bufs[1])


# (n, h, w, buffer channels, input channel range, cout, output buffer
# channels, offset): the UNet++ grid's row buffers — a cell's stage 1 reads
# channels [0, (j+2)·c) of its row in place, its stage 2 writes slot j
K7_ROW_CASES = [(2, 16, 16, 192, (0, 96), 32, None, 0), (2, 16, 16, 32, (0, 32), 32, 192, 32),
                (1, 9, 7, 40, (8, 24), 16, 48, 16), (1, 5, 6, 12, (3, 10), 5, 9, 2)]


@pytest.mark.parametrize("case", K7_ROW_CASES, ids=lambda c: "x".join(map(str, c[:5])))
def test_qconv3x3_kernel_on_row_buffers_bit_equal_to_plain(cuda, gen, case):
    n, h, w, cbuf, (lo, hi), cout, ctot, off = case
    x = _i8(gen, (n, h, w, cbuf), cuda)[..., lo:hi]
    wt = _packed(gen, (cout, 3, 3), hi - lo, cuda)
    sw = torch.from_numpy((gen.random(cout) * 1e-3 + 1e-4).astype(np.float32)).to(cuda)
    bias = torch.from_numpy(gen.standard_normal(cout).astype(np.float32)).to(cuda)
    outs = [None if ctot is None else
            torch.full((n, h, w, ctot), 99, dtype=torch.int8, device=cuda) for _ in range(2)]
    got = k8.qconv3x3(x, wt, sw, bias, 1.0, 0.05, out=outs[0], offset=off)
    torch.cuda.synchronize()
    want = k8.qconv3x3_plain(x, wt, sw, bias, 1.0, 0.05, out=outs[1], offset=off)
    assert torch.equal(got, want)
    if ctot is not None:
        assert got is outs[0] and (got[..., :off] == 99).all()
    # K10 on the same channel range
    assert torch.equal(k8.maxpool_i8(x), k8.maxpool_i8_plain(x))


def test_requant_kernel_reads_a_channel_range(cuda, gen):
    buf = _i8(gen, (2, 12, 10, 24), cuda)
    for view in (buf[..., 8:], buf[..., 3:11], buf[:1, 2:7, :, 5:6]):
        got, want = k8.requant(view, 0.0371), k8.requant_plain(view, 0.0371)
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))
        assert torch.equal(k8.requant(view, 0.0371, 0.05), k8.requant_plain(view, 0.0371, 0.05))
    with pytest.raises(ValueError, match="one row stride"):
        k8.requant(buf[:, ::2], 1.0)


# --- K9 (vectors of 16 elements, a lookup table for int8 input) and K11 (staged) ---

def _every_i8(gen, shape, dev):
    """int8 values over the whole range, the first (up to 256) elements
    -128, -127, ..."""
    x = torch.from_numpy(gen.integers(-128, 128, shape).astype(np.int8))
    k = min(256, x.numel())
    x.view(-1)[:k] = torch.arange(-128, 128)[:k].to(torch.int8)
    return x.to(dev)


def _floats_with_ties(gen, shape, dev, dtype, step):
    """Values spread past +-127 steps, with exact .5 ties, +-0 and huge ones."""
    f = (gen.standard_normal(shape) * 60 * step).astype(np.float32)
    special = np.array([0.5, 1.5, -2.5, -0.5, 126.5, -127.5, 0.0, -0.0, 1e30, -1e30, 3.5,
                        -4.5], np.float32)
    f.reshape(-1)[:special.size] = special * step
    return torch.from_numpy(f).to(dev).to(dtype)


# K9's forms on the int8 paths (2D trunk, AttentionUnet, 3D trunk, UNet++):
# (name, input kind, pixel dims, output: "new" tensor, "buffer" at the
# offset, or "range": the input read from a channel range at the offset)
K9_FORMS = [("2d e1", "bf16", 2, "new"), ("2d skip", "int8", 2, "buffer"),
            ("2d dequant", "int8", 2, "dequant"), ("attention dequant", "int8", 2, "range"),
            ("attention f32", "f32", 2, "buffer"), ("3d e1", "bf16", 3, "new"),
            ("3d raw skip", "raw", 3, "buffer"), ("3d d6 dequant", "int8", 3, "dequant"),
            ("nested g0_0", "bf16", 2, "new"), ("nested slot dequant", "int8", 2, "range")]
# (C, buffer channels, offset): vectors of 1, 2, 4, 8, 16 elements (where the
# form has a buffer; contiguous forms get the width of C alone)
K9_WIDTHS = [(12, 17, 5), (6, 8, 2), (12, 16, 4), (24, 48, 24), (32, 64, 32), (32, 192, 64)]


@pytest.mark.parametrize("form", K9_FORMS, ids=[f[0] for f in K9_FORMS])
@pytest.mark.parametrize("case", K9_WIDTHS, ids=lambda c: "C{}of{}at{}".format(*c))
def test_requant_kernel_bit_equal_to_plain_in_every_form(cuda, gen, form, case):
    _, kind, dims, where = form
    c, cbuf, off = case
    pix = (3, 7, 5) if dims == 2 else (2, 3, 7, 5)  # 105 / 210 rows: ragged against a block
    if kind in ("int8", "raw"):
        x = _every_i8(gen, pix + (c,), cuda)
    else:
        x = _floats_with_ties(gen, pix + (c,), cuda,
                              torch.bfloat16 if kind == "bf16" else torch.float32, 0.0625)
    s_a, s_b = {"int8": (0.5, 1.0), "raw": (1.0, 1.0)}.get(kind, (1.0, 0.0625))
    before = k8.requant.launches
    if where == "buffer":
        bufs = [torch.full(pix + (cbuf,), 99, dtype=torch.int8, device=cuda) for _ in range(2)]
        k8.requant(x, s_a, s_b, out=bufs[0], offset=off)
        torch.cuda.synchronize()
        k8.requant_plain(x, s_a, s_b, out=bufs[1], offset=off)
        assert torch.equal(bufs[0], bufs[1])
        assert (bufs[0][..., :off] == 99).all() and (bufs[0][..., off + c:] == 99).all()
    elif where == "range":
        buf = _every_i8(gen, pix + (cbuf,), cuda)
        x = buf[..., off:off + c]
        got, want = k8.requant(x, 0.0371), k8.requant_plain(x, 0.0371)
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    elif where == "dequant":
        got, want = k8.requant(x, 0.0371), k8.requant_plain(x, 0.0371)
        assert got.dtype == torch.bfloat16
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    else:
        got = k8.requant(x, s_a, s_b)
        torch.cuda.synchronize()
        assert torch.equal(got, k8.requant_plain(x, s_a, s_b))
        assert got.min() == -127 and got.max() == 127  # the clip was reached both ways
    assert k8.requant.launches == before + 1


@pytest.mark.parametrize("kind", ["int8", "bf16", "f32"])
def test_requant_kernel_over_several_waves(cuda, gen, kind):
    # 2^21 vectors of 16: each thread of the one wave of blocks walks several
    shape = (16, 256, 256, 32)
    if kind == "int8":
        x = _every_i8(gen, shape, cuda)
        bufs = [torch.zeros(shape[:-1] + (64,), dtype=torch.int8, device=cuda) for _ in range(2)]
        k8.requant(x, 0.031, 0.037, out=bufs[0], offset=32)
        k8.requant_plain(x, 0.031, 0.037, out=bufs[1], offset=32)
        assert torch.equal(bufs[0], bufs[1])
        got, want = k8.requant(x, 0.031), k8.requant_plain(x, 0.031)
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    else:
        x = _floats_with_ties(gen, shape, cuda,
                              torch.bfloat16 if kind == "bf16" else torch.float32, 0.05)
        assert torch.equal(k8.requant(x, 1.0, 0.05), k8.requant_plain(x, 1.0, 0.05))


# (h, w) over 1, 2, 3, 5 and 64, the channel count and batch taking turns
K11_SIZES = [(h, w, (16, 24, 64)[i % 3], (1, 16)[i % 2])
             for i, (h, w) in enumerate(itertools.product((1, 2, 3, 5, 64), repeat=2))]


@pytest.mark.parametrize("case", K11_SIZES, ids=lambda c: "x".join(map(str, c)))
def test_upsample2x_i8_kernel_bit_equal_to_plain_at_every_size(cuda, gen, case):
    h, w, c, n = case
    x = _every_i8(gen, (n, h, w, c), cuda)
    bufs = [torch.full((n, 2 * h, 2 * w, c), 99, dtype=torch.int8, device=cuda) for _ in range(2)]
    k8.upsample2x_i8(x, out=bufs[0])
    torch.cuda.synchronize()
    k8.upsample2x_i8_plain(x, out=bufs[1])
    assert torch.equal(bufs[0], bufs[1])


# (n, C, the input row buffer's stride and channel start, output channels,
# offset, expected vector width): a slot of a UNet++ row buffer (192 or 320
# bytes a pixel) into a concat buffer at offsets that force each width
K11_ROW_CASES = [(16, 64, 320, 0, 192, 32, 16), (1, 64, 192, 128, 192, 96, 16),
                 (16, 24, 192, 64, 192, 8, 8), (1, 16, 320, 64, 40, 4, 4),
                 (16, 16, 192, 32, 34, 2, 2), (1, 64, 320, 0, 65, 1, 1),
                 (1, 24, 320, 8, 48, 24, 8)]


@pytest.mark.parametrize("case", K11_ROW_CASES, ids=lambda c: "x".join(map(str, c)))
def test_upsample2x_i8_kernel_from_row_buffers_bit_equal_to_plain(cuda, gen, case):
    n, c, stride, lo, ctot, off, width = case
    h, w = 9, 13
    x = _every_i8(gen, (n, h, w, stride), cuda)[..., lo:lo + c]
    bufs = [torch.full((n, 2 * h, 2 * w, ctot), 99, dtype=torch.int8, device=cuda)
            for _ in range(2)]
    assert k8._vec_width(x, stride, bufs[0], off) == width
    k8.upsample2x_i8(x, out=bufs[0], offset=off)
    torch.cuda.synchronize()
    k8.upsample2x_i8_plain(x, out=bufs[1], offset=off)
    assert torch.equal(bufs[0], bufs[1])
    assert (bufs[0][..., :off] == 99).all() and (bufs[0][..., off + c:] == 99).all()


def test_upsample2x_i8_wrappers_refuse_what_the_kernel_does_not_take(cuda, gen):
    x = _i8(gen, (1, 4, 4, 8), cuda)
    with pytest.raises(ValueError, match="CUDA"):
        k8.upsample2x_i8(x, out=torch.zeros((1, 8, 8, 8), dtype=torch.int8))
    with pytest.raises(ValueError, match="contiguous"):
        k8.upsample2x_i8(x.transpose(1, 2))
    with pytest.raises(ValueError, match="NDHWC int8"):
        k8.upsample2x_i8_3d(x)


@pytest.mark.parametrize("registry,deep", [("MultiOutputNestedUNet", False),
                                           ("MultiOutputNestedUNet_3Levels", True)])
def test_quantized_nested_predict_on_card_matches_cpu(cuda, gen, tmp_path, monkeypatch,
                                                      registry, deep):
    monkeypatch.setenv("BIU_INT8_EXPERIMENTAL", "1")
    heads = {"mask": {"channels": 1, "activation": "sigmoid"},
             "orientation": {"channels": 2, "activation": None}}
    ckpt = str(tmp_path / "nested.pt")
    write_warm_checkpoint(torch, ckpt, registry, 8, seed=7, output_heads=heads,
                          deep_supervision=deep)
    movie = _frames(gen, np.uint8, (3, 100, 90))
    kw = dict(max_patch_size=(48, 48), safe_margin=4, show_progress=False, quantized=True)
    before = k8.upsample2x_i8.launches
    card = PredictMultiOutput(movie, ckpt, **kw)
    assert card.engine._quant_ready and k8.upsample2x_i8.launches > before
    cpu = PredictMultiOutput(movie, ckpt, device="cpu", **kw)
    for head in cpu.result:
        rg = max(float(cpu.result[head].max() - cpu.result[head].min()), 0.5)
        d = np.abs(card.result[head] - cpu.result[head])
        assert d.max() / rg < 0.25 and d.mean() / rg < 0.03, (head, d.max(), rg)


@pytest.mark.parametrize("quantized", [False, True])
def test_attention_predict_on_card_matches_cpu(cuda, gen, tmp_path, quantized):
    ckpt = str(tmp_path / "att.pt")
    write_warm_checkpoint(torch, ckpt, "AttentionUnet", 8, seed=7)
    movie = _frames(gen, np.uint8, (4, 100, 90))
    kw = dict(resize_dim=(64, 64), show_progress=False, quantized=quantized)
    card = Predict(movie, None, ckpt, **kw)
    cpu = Predict(movie, None, ckpt, device="cpu", **kw)
    assert card.engine._quant_ready == cpu.engine._quant_ready == quantized
    d = np.abs(card.result.astype(int) - cpu.result.astype(int))
    if quantized:
        assert d.max() <= 4 and d.mean() < 0.5 and (d > 1).mean() < 0.01, (d.max(), d.mean())
    else:
        assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (d.max(), (d > 0).mean())


# --- slice: K3c, the legacy models, multi-channel Predict, AttentionUnet training ---

K3C_CASES = [
    # (id, (F, h, w), tile, add_tile, dtype, channels)
    ("exact-bf16-c2", (2, 128, 128), 64, 0, torch.bfloat16, 2),
    ("exact-f32-c3", (2, 128, 128), 64, 0, torch.float32, 3),
    ("overlap-bf16-c2", (2, 100, 90), 32, 1, torch.bfloat16, 2),
    ("tile-40-f32-c3", (2, 70, 100), 40, 1, torch.float32, 3),
    ("rows-1000-c2", (2, 1000, 1000), 256, 1, torch.bfloat16, 2),
    ("exact-1024-c2", (2, 1024, 1024), 256, 0, torch.bfloat16, 2),
    ("heavy-overlap-c2", (2, 64, 70), 32, 4, torch.float32, 2),
]


@pytest.mark.parametrize("case", K3C_CASES, ids=[c[0] for c in K3C_CASES])
def test_sigmoid_stitch_channels_kernel_equals_plain(cuda, gen, case):
    _, (n_frames, h, w), t, add, dtype, c = case
    plan = TilePlan(h, w, t, t, grid_starts(h, t, add), grid_starts(w, t, add), cuda)
    n = n_frames * plan.per_frame + 2
    logits = torch.from_numpy((gen.standard_normal((n, c, t, t)) * 4).astype(np.float32))
    logits = logits.to(cuda, dtype)
    before = sigmoid_stitch.launches
    ours = sigmoid_stitch(logits, n_frames, plan)
    torch.cuda.synchronize()
    assert sigmoid_stitch.launches == before + c and ours.shape == (n_frames, c, h, w)
    ref = sigmoid_stitch_plain(logits, n_frames, plan)
    assert (ours.int() - ref.int()).abs().max().item() <= 1
    # each channel as a one-channel launch of its own
    for k in range(c):
        assert torch.equal(sigmoid_stitch(logits[:, k].contiguous(), n_frames, plan), ours[:, k])


@pytest.mark.parametrize("name,nf", [("Unet_v0", 8), ("BabyUnet", 4)])
def test_legacy_predict_on_card_matches_cpu(cuda, gen, tmp_path, name, nf):
    from bio_image_unet_tpu_torch.models import get_model

    net = init_weights_(get_model(name, n_filter=nf), torch.Generator().manual_seed(3),
                        random_bn_stats=True)
    path = str(tmp_path / f"{name}.pt")
    torch.save({"state_dict": net.state_dict(), "model_name": name, "n_filter": nf}, path)
    movie = _frames(gen, np.uint8, (2, 512, 512))
    kw = dict(resize_dim=(256, 256), show_progress=False, batch_size=4)
    before = sigmoid_stitch.launches
    card = Predict(movie, None, path, half_precision=True, **kw)
    assert card.engine.dtype == torch.float32 and sigmoid_stitch.launches == before + 1
    cpu = Predict(movie, None, path, device="cpu", **kw).result
    diff = np.abs(card.result.astype(int) - cpu.astype(int))
    assert diff.max() <= 1 and np.mean(diff > 0) <= 1e-3, (diff.max(), np.mean(diff > 0))


def test_multichannel_predict_on_card_matches_cpu(cuda, gen, tmp_path):
    net = init_weights_(Unet(n_filter=8, out_channels=2), torch.Generator().manual_seed(4),
                        random_bn_stats=True)
    path = str(tmp_path / "unet_c2.pt")
    torch.save({"state_dict": net.state_dict(), "model_name": "Unet", "n_filter": 8,
                "out_channels": 2}, path)
    movie = _frames(gen, np.uint16, (3, 100, 90))
    kw = dict(resize_dim=(64, 64), add_tile=1, show_progress=False, batch_size=4)
    counts = (normalize_tile.launches, sigmoid_stitch.launches)
    card = Predict(movie, None, path, **kw).result
    # host-staged: no K2; K3c a chunk, one launch a channel
    assert (normalize_tile.launches, sigmoid_stitch.launches) == (counts[0], counts[1] + 2)
    cpu = Predict(movie, None, path, device="cpu", **kw).result
    assert card.shape == cpu.shape == (3, 2, 100, 90)
    diff = np.abs(card.astype(int) - cpu.astype(int))
    assert diff.max() <= 1 and np.mean(diff > 0) <= 1e-3, (diff.max(), np.mean(diff > 0))


@pytest.mark.parametrize("half", [False, True], ids=["f32", "bf16"])
def test_attention_trainer_on_card_matches_cpu(cuda, tmp_path, half):
    """3 steps and a validation pass of ``AttentionUnet(8)`` on the card
    against the CPU: float32 (TF32 off) within rtol 1e-3, bf16 within rtol
    2e-2 (the two devices' bf16 convs round differently)."""
    rows = {}
    for dev in ("cuda", "cpu"):
        out = tmp_path / dev
        t = Trainer(_Tiles(), 1, network="AttentionUnet", n_filter=8, batch_size=4, lr=1e-4,
                    save_dir=str(out), seed=0, device=dev, device_cache=True,
                    half_precision=half)
        t.start()
        with open(os.path.join(out, "metrics.csv")) as fh:
            rows[dev] = np.array([[float(v) for v in r[1:3]] for r in list(csv.reader(fh))[1:]])
    np.testing.assert_allclose(rows["cuda"], rows["cpu"], rtol=2e-2 if half else 1e-3)
