"""The port's CUDA kernels held against their plain PyTorch versions on the
card, and ``Predict`` on the card held against ``Predict`` on the CPU.

Every test here needs an NVIDIA GPU with the CUDA toolkit (the kernels are
built with nvcc on first use and have no CPU mode); without one they skip.
The file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -p no:cacheprovider
"""

import csv
import os

import numpy as np
import pytest
import torch

from bio_image_unet_tpu_torch.data.augment_device import (augment_apply, augment_apply_plain,
                                                          draw)
from bio_image_unet_tpu_torch.models import Unet
from bio_image_unet_tpu_torch.ops import histogram as hist
from bio_image_unet_tpu_torch.ops.blocks import init_weights_
from bio_image_unet_tpu_torch.ops.stitch import sigmoid_stitch, sigmoid_stitch_plain
from bio_image_unet_tpu_torch.predict import Predict
from bio_image_unet_tpu_torch.predict.normalize import normalize_tile, normalize_tile_plain
from bio_image_unet_tpu_torch.predict.tiling import TilePlan, grid_starts
from bio_image_unet_tpu_torch.train import Trainer
from bio_image_unet_tpu_torch.utils.synth import blob_sample

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
