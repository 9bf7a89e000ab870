"""The port's ``Siam_UNet`` and the Siam path's kernels (plain versions) held
against the JAX package on the CPU.

- ``Siam_UNet`` in each join (``max``, ``concat``, ``corr``, ``control``),
  its weights carried across by ``state_dict_from_jax`` with ``strict=True``,
  unfolded and BN-folded, against ``model.apply`` in float32: atol 2e-4.
- K6's plain version against JAX's ``depthwise_xcorr`` at odd and even plane
  sizes: rtol 2e-5, atol 2e-4 (the bound of ``tests/test_ops_parity.py``).
- K2p's plain version and the pair bounds (K1 per frame, per prev plane and
  over the pair rows) against the pieces of JAX's pair program
  (``_device_frame_bounds``, ``_normalize_clip``, ``jnp.pad``,
  ``_extract_tiles``): bounds bit-equal, tiles equal.
- The Siam checkpoint rules of the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from bio_image_unet_tpu import checkpoint as jcheckpoint
from bio_image_unet_tpu.models import Siam_UNet as JSiam
from bio_image_unet_tpu.ops.functional import depthwise_xcorr as j_xcorr
from bio_image_unet_tpu.predict.predictor import (_device_frame_bounds, _extract_tiles,
                                                  _normalize_clip, _tile_plan)
from bio_image_unet_tpu_torch import checkpoint
from bio_image_unet_tpu_torch.interop import state_dict_from_jax
from bio_image_unet_tpu_torch.models import Siam_UNet, get_model
from bio_image_unet_tpu_torch.ops.blocks import init_weights_
from bio_image_unet_tpu_torch.ops.functional import depthwise_xcorr, depthwise_xcorr_plain
from bio_image_unet_tpu_torch.ops.histogram import clip_bounds, pair_clip_bounds
from bio_image_unet_tpu_torch.predict.fastpath import folded_forward
from bio_image_unet_tpu_torch.predict.normalize import normalize_tile_pairs
from bio_image_unet_tpu_torch.predict.tiling import TilePlan, grid_starts
from bio_image_unet_tpu_torch.train import Trainer
from torch_parity import write_seeded_checkpoint

MODES = ("max", "concat", "corr", "control")


@pytest.fixture(scope="module")
def siam_ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("siam")
    return {mode: write_seeded_checkpoint(root, mode, "Siam_UNet", seed, n_filter=4, mode=mode)
            for seed, mode in enumerate(MODES)}


@pytest.mark.parametrize("mode", MODES)
def test_siam_model_and_folded_forward_match_jax(siam_ckpts, mode):
    path, variables = siam_ckpts[mode]
    net = Siam_UNet(n_filter=4, mode=mode)
    net.load_state_dict(state_dict_from_jax(variables), strict=True)
    net.eval()
    # the reference .pt rebuilds the same model from its hyperparams
    state = checkpoint.load(path)
    rebuilt = get_model(state["hyperparams"]["model_name"], **state["hyperparams"])
    assert isinstance(rebuilt, Siam_UNet) and rebuilt.mode == mode
    rebuilt.load_state_dict(state["state_dict"], strict=True)
    assert set(rebuilt.state_dict()) == set(net.state_dict())
    assert ("conv_concat.0.weight" in net.state_dict()) == (mode == "concat")

    rng = np.random.default_rng(3)
    x = rng.random((2, 1, 32, 32), dtype=np.float32)
    prev = rng.random((2, 1, 32, 32), dtype=np.float32)
    model = JSiam(n_filter=4, mode=mode)
    _, j_logits = jax.jit(lambda v, a, b: model.apply(v, a, b, train=False))(
        variables, x.transpose(0, 2, 3, 1), prev.transpose(0, 2, 3, 1))
    ref = np.asarray(j_logits).transpose(0, 3, 1, 2)
    xt, pt = torch.from_numpy(x), torch.from_numpy(prev)
    with torch.no_grad():
        probs, logits = net(xt, pt)
        folded = folded_forward(net)(xt, pt)[1]
    np.testing.assert_allclose(logits.numpy(), ref, atol=2e-4, rtol=0)
    np.testing.assert_allclose(folded.numpy(), ref, atol=2e-4, rtol=0)
    np.testing.assert_allclose(probs.numpy(), 1 / (1 + np.exp(-ref)), atol=1e-4, rtol=0)
    with pytest.raises(ValueError, match="prev_x"):
        net(xt)


def test_siam_bf16_model_and_refusals():
    """The bf16 compute dtype of ``Unet`` carries to the siamese trunk; an
    unknown join raises."""
    gen = torch.Generator().manual_seed(0)
    net = init_weights_(Siam_UNet(n_filter=4, mode="corr"), gen, random_bn_stats=True).eval()
    half = Siam_UNet(n_filter=4, mode="corr", dtype=torch.bfloat16).eval()
    half.load_state_dict(net.state_dict(), strict=True)
    x, prev = torch.rand((2, 1, 32, 32), generator=gen), torch.rand((2, 1, 32, 32), generator=gen)
    with torch.no_grad():
        ref, got = net(x, prev)[1], half(x, prev)[1]
    assert got.dtype == torch.float32 and all(p.dtype == torch.float32 for p in half.parameters())
    assert (got - ref).abs().max() <= 0.05 * ref.abs().max() + 0.05
    with pytest.raises(NotImplementedError, match="Unknown mode"):
        Siam_UNet(n_filter=4, mode="sum")


XCORR_SHAPES = [
    # cur (B, C, H, W), kernel (kh, kw)
    ((2, 3, 5, 5), (5, 5)),
    ((2, 3, 4, 6), (4, 6)),
    ((1, 4, 16, 16), (16, 16)),
    ((3, 2, 7, 8), (3, 4)),
]


@pytest.mark.parametrize("shape,kernel", XCORR_SHAPES, ids=lambda v: "x".join(map(str, v)))
def test_depthwise_xcorr_plain_matches_jax(shape, kernel):
    rng = np.random.default_rng(sum(shape))
    cur = rng.standard_normal(shape).astype(np.float32)
    prev = rng.standard_normal(shape[:2] + kernel).astype(np.float32)
    ref = np.asarray(j_xcorr(jnp.asarray(cur.transpose(0, 2, 3, 1)),
                             jnp.asarray(prev.transpose(0, 2, 3, 1)))).transpose(0, 3, 1, 2)
    ours = depthwise_xcorr(torch.from_numpy(cur), torch.from_numpy(prev))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=2e-5, atol=2e-4)
    # the reference's formulation: one grouped conv with 'same' padding
    b, c = shape[:2]
    grouped = F.conv2d(torch.from_numpy(cur).reshape(1, b * c, *shape[2:]),
                       torch.from_numpy(prev).reshape(b * c, 1, *kernel), groups=b * c,
                       padding="same").reshape(shape)
    np.testing.assert_allclose(ours.numpy(), grouped.numpy(), rtol=2e-5, atol=2e-4)
    # bf16 in: the float32 sum rounded once to bf16; channels_last kept
    cl = torch.from_numpy(cur).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    half = depthwise_xcorr(cl, torch.from_numpy(prev).to(torch.bfloat16))
    assert half.dtype == torch.bfloat16
    want = depthwise_xcorr_plain(cl.float(), torch.from_numpy(prev).to(torch.bfloat16).float())
    assert torch.equal(half, want.to(torch.bfloat16))


def test_depthwise_xcorr_refuses_bad_arguments():
    x = torch.zeros((2, 3, 4, 4))
    with pytest.raises(ValueError, match="same"):
        depthwise_xcorr(x, torch.zeros((3, 3, 4, 4)))
    with pytest.raises(ValueError, match="float32 or two bfloat16"):
        depthwise_xcorr(x, x.to(torch.bfloat16))


PAIR_CASES = [
    # name, dtype, block (k+1, h, w), tile, add_tile, mode, invert
    ("u8-single-exact", np.uint8, (4, 64, 64), 32, 0, "single", False),
    ("u16-first-gather", np.uint16, (3, 50, 70), 32, 1, "first", False),
    ("f32-all-zero-pad-invert", np.float32, (4, 20, 40), 32, 0, "all", True),
    ("u8-all-gather", np.uint8, (3, 48, 48), 32, 0, "all", False),
]


def _block(rng, dtype, shape):
    if dtype == np.float32:
        return (rng.standard_normal(shape) * 30 + 5).astype(np.float32)
    return rng.integers(0, np.iinfo(dtype).max, shape, endpoint=True).astype(dtype)


@pytest.mark.parametrize("case", PAIR_CASES, ids=[c[0] for c in PAIR_CASES])
def test_pair_bounds_and_tiles_equal_jax(case):
    """The JAX pair program's steps (``predictor.py:974-1010``) one by one
    against the port's pair bounds and K2p's plain version."""
    name, dtype, shape, tile, add, mode, invert = case
    block = _block(np.random.default_rng(len(name)), dtype, shape)
    k, h, w = shape[0] - 1, shape[1], shape[2]
    clip = (1.0, 99.5)
    n_bits = {np.uint8: 8, np.uint16: 16, np.float32: 0}[dtype]
    xs, ys = grid_starts(h, tile, add), grid_starts(w, tile, add)

    def bounds3(frames):
        return [np.asarray(v) for v in _device_frame_bounds(jnp.asarray(frames), clip, n_bits)]

    prevs, curs = block[:-1], block[1:]
    if mode == "single":
        b = bounds3(block)
        pb, cb = [v[:-1] for v in b], [v[1:] for v in b]
        ours = clip_bounds(torch.from_numpy(block), *clip)
        want = np.stack(b)
    elif mode == "first":
        pb = cb = bounds3(prevs)
        ours = clip_bounds(torch.from_numpy(prevs.copy()), *clip)
        want = np.stack(pb)
    else:
        pairs = np.concatenate([prevs.reshape(k, -1), curs.reshape(k, -1)], axis=1)
        pb = cb = bounds3(pairs)
        ours = pair_clip_bounds(torch.from_numpy(block), *clip)
        want = np.stack(pb)
    np.testing.assert_array_equal(ours.numpy().view(np.int32), want.view(np.int32))

    exact, row_idx, col_idx = _tile_plan(h, w, tile, tile, xs, ys)
    per = len(xs) * len(ys)
    n_pad = k * per + 3
    sets = []
    for planes, bb in ((prevs, pb), (curs, cb)):
        f = _normalize_clip(jnp.asarray(planes, jnp.float32),
                            *(v[:, None, None] for v in bb), invert)
        f = jnp.pad(f, ((0, 0), (0, max(tile - h, 0)), (0, max(tile - w, 0))))
        t = np.asarray(_extract_tiles(f.astype(jnp.uint8), len(xs), len(ys), tile, tile, exact,
                                      row_idx, col_idx))[..., 0]
        sets.append(np.concatenate([t, np.repeat(t[-1:], n_pad - len(t), axis=0)]))
    plan = TilePlan(h, w, tile, tile, xs, ys, "cpu")
    tiles = normalize_tile_pairs(torch.from_numpy(block), ours, plan, n_pad, invert)
    assert tiles.shape == (2, n_pad, tile, tile) and tiles.dtype == torch.uint8
    np.testing.assert_array_equal(tiles.numpy(), np.stack(sets))
    if h < tile:  # the zero pad: 0 inverted or not
        assert (tiles[:, :, h:] == 0).all()


def test_pair_kernels_refuse_bad_arguments():
    block = torch.zeros((3, 32, 32), dtype=torch.uint8)
    plan = TilePlan(32, 32, 32, 32, [0], [0], "cpu")
    with pytest.raises(ValueError, match="pair bounds"):
        normalize_tile_pairs(block, torch.zeros((4, 5)), plan, 2, False)
    with pytest.raises(ValueError, match="k >= 1"):
        normalize_tile_pairs(block[:1], torch.zeros((4, 1)), plan, 2, False)
    with pytest.raises(ValueError, match="n_total"):
        normalize_tile_pairs(block, torch.zeros((4, 3)), plan, 1, False)
    with pytest.raises(ValueError, match="k >= 1"):
        pair_clip_bounds(block[:1], 0.0, 99.0)


def test_siam_checkpoint_rules(tmp_path, siam_ckpts):
    """A Siam ``.pt`` rebuilds from its top-level ``model_name``/``n_filter``/
    ``mode``; without ``mode`` it takes the JAX class default (``concat``), so
    a ``max`` state dict saved without it fails the strict load; the port's
    ``checkpoint.save`` writes ``mode`` and the JAX package reads it back."""
    sd = checkpoint.load(siam_ckpts["max"][0])["state_dict"]
    hyper = {"model_name": "Siam_UNet", "n_filter": 4, "mode": "max"}
    path = str(tmp_path / "siam_max.pt")
    checkpoint.save(path, sd, hyper, epoch=1)
    assert torch.load(path, weights_only=True)["mode"] == "max"
    state = checkpoint.load(path)
    net = get_model("Siam_UNet", **state["hyperparams"])
    assert net.mode == "max"
    net.load_state_dict(state["state_dict"], strict=True)
    assert jcheckpoint.load(path)["hyperparams"]["mode"] == "max"

    concat = checkpoint.load(siam_ckpts["concat"][0])["state_dict"]
    no_mode = {"model_name": "Siam_UNet", "n_filter": 4}
    checkpoint.save(str(tmp_path / "concat.pt"), concat, no_mode)
    default = get_model("Siam_UNet", **checkpoint.load(str(tmp_path / "concat.pt"))["hyperparams"])
    assert default.mode == "concat"
    default.load_state_dict(concat, strict=True)
    with pytest.raises(RuntimeError, match="conv_concat"):
        get_model("Siam_UNet", **no_mode).load_state_dict(sd, strict=True)

    # the siamese trainer is a later slice
    data = [{"image": np.zeros((1, 32, 32), np.float32), "mask": np.zeros((1, 32, 32), np.float32)}]
    with pytest.raises(NotImplementedError, match="not ported"):
        Trainer(data, 1, network="Siam_UNet", n_filter=4, save_dir=str(tmp_path), device="cpu")
