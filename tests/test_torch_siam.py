"""The port's ``Siam_UNet`` and the Siam path's kernels (plain versions) held
against the JAX package on the CPU.

- ``Siam_UNet`` in each join (``max``, ``concat``, ``corr``, ``control``),
  its weights carried across by ``state_dict_from_jax`` with ``strict=True``,
  unfolded and BN-folded, against ``model.apply`` in float32: atol 2e-4.
- K6's plain version against JAX's ``depthwise_xcorr`` at odd and even plane
  sizes: rtol 2e-5, atol 2e-4 (the bound of ``tests/test_ops_parity.py``);
  K6's register tiling and staging, emulated on the CPU, bit-equal to the
  plain version (the kernel's order-and-rounding claim).
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
from bio_image_unet_tpu_torch.ops import functional
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


def _xcorr_tiled(cur: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """K6's tiling (``csrc/depthwise_xcorr.cu``) emulated in float32 on the
    CPU, with the kernel's own staging (``xcorr_geometry``): zero-haloed
    planes and kernels, R×S output tiles, each warp region's tap range (rows
    exact, columns rounded out to 4) walked u outer, v inner, a product and
    a sum rounded apiece; every read is checked to lie in the staged plane
    and every 4-column window start to be 16-byte aligned."""
    b, c, h, w = cur.shape
    kh, kw = prev.shape[2:]
    g = functional.xcorr_geometry(h, w, kh, kw, cur.element_size())
    r_, s_ = functional.XCORR_R, functional.XCORR_S
    ph, pw = (kh - 1) // 2, (kw - 1) // 2
    rows = h + 2 * g.pad_t
    x = torch.zeros((b * c, rows, g.xp))
    x[:, g.pad_t:g.pad_t + h, g.pad_l:g.pad_l + w] = cur.float().reshape(b * c, h, w)
    k = torch.zeros((b * c, kh, g.kwp))
    k[:, :, :kw] = prev.float().reshape(b * c, kh, kw)
    out = torch.empty((b * c, h, w))
    assert g.xp % 4 == 0 and g.xplane % 32 == 4 and g.cg * g.n == 32 and g.tpr % g.n == 0
    for tr in range(-(-h // r_)):
        for tc in range(g.tpr):
            i0, j0, jr = tr * r_, tc * s_, (tc - tc % g.n) * s_
            u_lo, u_hi = max(0, ph - (i0 + r_ - 1)), min(kh, h + ph - i0)
            v_lo = max(0, pw - (jr + g.n * s_ - 1)) // 4 * 4
            v_end = -(-min(kw, w + pw - jr) // 4) * 4
            y0, x0 = g.pad_t + i0 - ph, g.pad_l + j0 - pw
            assert y0 + u_lo >= 0 and y0 + r_ - 1 + u_hi - 1 < rows
            assert x0 + v_lo >= 0 and x0 + v_end + 3 < g.xp and v_end <= g.kwp
            assert (x0 + v_lo) % 4 == 0
            acc = torch.zeros((b * c, r_, s_))
            for u in range(u_lo, u_hi):
                for v in range(v_lo, v_end):
                    win = x[:, y0 + u:y0 + u + r_, x0 + v:x0 + v + s_]
                    acc = acc + win * k[:, u, v][:, None, None]
            out[:, i0:i0 + r_, j0:j0 + s_] = acc[:, :min(r_, h - i0), :max(0, min(s_, w - j0))]
    return out.reshape(b, c, h, w).to(cur.dtype)


# the Siam paths' K6 shapes scaled down in B and C (bf16 16² planes at 256²
# tiles, float32 32² at 512²), odd planes and even kernels
XCORR_TILED = [((2, 40, 16, 16), (16, 16), torch.bfloat16), ((1, 20, 32, 32), (32, 32), torch.float32),
               ((3, 5, 7, 6), (3, 4), torch.float32), ((2, 3, 4, 6), (4, 6), torch.float32),
               ((1, 2, 9, 13), (2, 8), torch.bfloat16), ((2, 3, 5, 5), (5, 5), torch.float32),
               ((1, 3, 1, 1), (1, 1), torch.float32), ((1, 2, 12, 20), (12, 20), torch.float32)]


@pytest.mark.parametrize("shape,kernel,dtype", XCORR_TILED,
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v)[6:])
def test_depthwise_xcorr_tiling_bit_equal_to_plain(shape, kernel, dtype):
    rng = np.random.default_rng(sum(shape) + sum(kernel))
    cur = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
    prev = torch.from_numpy(rng.standard_normal(shape[:2] + kernel).astype(np.float32)).to(dtype)
    assert torch.equal(_xcorr_tiled(cur, prev), depthwise_xcorr_plain(cur, prev))


def test_depthwise_xcorr_staging_limit():
    # the haloed planes of a block fit its shared memory up to 112² planes
    # with kernels as large; above, the plane form takes a plane and its
    # kernel whose float32 values fit a block (hw + khw ≤ 58112: up to 170²
    # with a 170² kernel); the wrapper refuses larger ones
    assert functional.xcorr_geometry(100, 100, 100, 100).cg == 1
    assert functional.xcorr_geometry(112, 112, 112, 112).cg == 1
    assert functional.xcorr_geometry(16, 16, 16, 16, 2).cg == 32
    assert functional.xcorr_geometry(32, 32, 32, 32).cg == 16
    for n in (113, 128, 170):
        assert functional.xcorr_geometry(n, n, n, n) is None
        assert functional.xcorr_plane_fits(n, n, n, n)
    assert functional.xcorr_plane_fits(170, 171, 170, 170)
    assert not functional.xcorr_plane_fits(171, 171, 170, 170)
    assert functional.xcorr_geometry(200, 200, 200, 200) is None
    assert not functional.xcorr_plane_fits(200, 200, 200, 200)
    for g in (functional.xcorr_geometry(16, 16, 16, 16, 2), functional.xcorr_geometry(32, 32, 32, 32)):
        assert g.smem <= functional._SMEM_BYTES and g.threads == 512


def _xcorr_per_output(cur: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """K6's plane form (``xcorr_plane``) emulated in float32 on the CPU: an
    unpadded plane, each output's taps clipped to the plane exactly, u
    outer, v inner, a product and a sum rounded apiece."""
    b, c, h, w = cur.shape
    kh, kw = prev.shape[2:]
    ph, pw = (kh - 1) // 2, (kw - 1) // 2
    x, k = cur.float(), prev.float()
    out = torch.empty((b, c, h, w))
    for i in range(h):
        for j in range(w):
            acc = torch.zeros((b, c))
            for u in range(max(0, ph - i), min(kh, h + ph - i)):
                for v in range(max(0, pw - j), min(kw, w + pw - j)):
                    acc = acc + x[:, :, i + u - ph, j + v - pw] * k[:, :, u, v]
            out[:, :, i, j] = acc
    return out.to(cur.dtype)


@pytest.mark.parametrize("shape,kernel,dtype", [
    ((2, 3, 7, 6), (7, 6), torch.float32), ((1, 2, 9, 13), (2, 8), torch.bfloat16),
    ((1, 2, 8, 8), (5, 4), torch.float32)],
    ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v)[6:])
def test_depthwise_xcorr_plane_form_bit_equal_to_plain(shape, kernel, dtype):
    rng = np.random.default_rng(7 * sum(shape) + sum(kernel))
    cur = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
    prev = torch.from_numpy(rng.standard_normal(shape[:2] + kernel).astype(np.float32)).to(dtype)
    assert torch.equal(_xcorr_per_output(cur, prev), depthwise_xcorr_plain(cur, prev))


# (shape, dtype, channels_last, the block's planes, expected elements a load)
XCORR_VECTORS = [((128, 256, 16, 16), torch.bfloat16, True, 32, 8),
                 ((128, 256, 16, 16), torch.bfloat16, False, 32, 8),
                 ((32, 256, 32, 32), torch.float32, False, 16, 4),
                 ((32, 256, 32, 32), torch.float32, True, 16, 4),
                 ((2, 40, 16, 16), torch.bfloat16, True, 32, 1),  # 40 channels: no whole block
                 ((3, 5, 7, 6), torch.float32, False, 32, 1),  # rows of 6
                 ((2, 3, 12, 20), torch.float32, False, 32, 4),
                 ((2, 64, 4, 6), torch.bfloat16, False, 32, 1),
                 ((2, 16, 8, 8), torch.float32, True, 16, 4),
                 ((2, 8, 8, 8), torch.float32, True, 16, 1)]  # 8 channels < a block


@pytest.mark.parametrize("shape,dtype,cl,cg,want", XCORR_VECTORS,
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_depthwise_xcorr_staging_vector(shape, dtype, cl, cg, want):
    # K6 stages 16 bytes a load along the fastest axis where a block's run
    # fills whole aligned vectors, else one element
    t = torch.zeros(shape, dtype=dtype)
    if cl:
        t = t.contiguous(memory_format=torch.channels_last)
    assert t.data_ptr() % 16 == 0
    assert functional.xcorr_stage_vector(t, cg) == want
    # one element off a 16-byte boundary: element loads
    n = t.numel()
    shifted = torch.zeros(n + 1, dtype=dtype)[1:].view(shape)
    assert functional.xcorr_stage_vector(shifted, cg) == 1


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

    # the siamese trainer rebuilds the join from ``mode`` and writes it into
    # its checkpoint; ``network="Siam_UNet"`` without a mode is a plain trunk,
    # as in JAX (get_model passes mode=None)
    data = [{"image": np.zeros((1, 32, 32), np.float32), "mask": np.zeros((1, 32, 32), np.float32),
             "prev_image": np.zeros((1, 32, 32), np.float32)}]
    t = Trainer(data, 1, network="Siam_UNet", n_filter=4, mode="max", save_dir=str(tmp_path),
                device="cpu")
    assert t.model.mode == "max" and t.params_meta["mode"] == "max"
    plain = Trainer(data, 1, network="Siam_UNet", n_filter=4, save_dir=str(tmp_path),
                    device="cpu")
    assert plain.model.mode is None and "mode" not in plain.params_meta
