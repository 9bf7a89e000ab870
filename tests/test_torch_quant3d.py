"""The port's w8a8 int8 graph of the 3D trunks
(``bio_image_unet_tpu_torch.predict.quant3d``, K7v/K8v/K10v in ``ops.int8``)
held against the JAX package's ``predict/quant3d.py`` on the CPU.

- K7v, K8v and K10v's plain versions equal the JAX pieces bit for bit (the
  conv with the epilogue of ``quant3d.py:269-283``, the transposed conv of
  ``:277``, ``_maxpool_i8_3d``), with 16 input channels zero-padded to 32,
  decode1's width and channel counts that are not multiples of 4, and odd
  extents for the pool; K9 on NDHWC tensors; K11v's (the trilinear
  decoder's ×2 of int8 values, ``:305-310``) equals the torch calls it
  replaced and JAX's, at up1's and up2's channel counts and d = 1 too;
- a numpy model of K11v's integer arithmetic (biased 16-bit lanes, two
  channels a word, one multiply-add an axis, the shift-and-remainder
  rounding) equals the plain version on bricks with the extremes and on every
  pair of int8 values at each weight, and its rounding equals rint(S / 64)
  for every blend S;
- the weight store, quantized at the same maxes from JAX's folded float32
  arrays with the activation scales folded in, equals ``_build_pack``'s
  codes, scales and biases for the three decoder variants;
- the calibrator's per-site maxes are within 2e-2 relative of
  ``build_calibrator_3d``'s (bf16 forwards on both sides);
- ``Int8UNet3D`` on JAX's folded weights and calibrated maxes equals
  ``build_int8_apply_3d``'s ``apply_fn`` bit for bit, logits and heads (the
  probabilities within 6e-8: torch's and XLA's sigmoids differ in the last
  bit): its
  int8 codes are the same computation, and the bf16 ``encode1`` and head
  round as XLA's do on these inputs (measured; a one-ulp difference there
  would move a few codes, and then the masks would be held to the uint8
  contract instead).

Checkpoints are drawn in the port at ``n_filter=8`` with BN-warmed statistics
(``torch_parity.write_seeded_checkpoint``); tiles are (16, 32, 32) volumes
drawn with numpy from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from bio_image_unet_tpu import models as jmodels
from bio_image_unet_tpu.predict import quant as jquant
from bio_image_unet_tpu.predict import quant3d as jquant3d
from bio_image_unet_tpu_torch import checkpoint
from bio_image_unet_tpu_torch.models import get_model
from bio_image_unet_tpu_torch.ops import int8 as k
from bio_image_unet_tpu_torch.predict import quant, quant3d
from torch_parity import assert_u8_contract, port_folded, write_seeded_checkpoint

_DN3 = ("NDHWC", "DHWIO", "NDHWC")
HEADS = {"mask": {"channels": 1, "activation": "sigmoid"},
         "vec": {"channels": 2, "activation": None}}
# the three decoder variants, the transposed conv with heads too: (registry,
# seed, extra hyperparameters)
MODELS = {
    "tconv": ("UNet3D", 60, {}),
    "trilinear": ("UNet3D", 61, {"use_interpolation": True}),
    "mo_nearest": ("MultiOutputUnet3D", 62, {"output_heads": HEADS}),
    "mo_tconv": ("MultiOutputUnet3D", 63, {"output_heads": HEADS, "use_interpolation": False}),
}
TILE = (16, 32, 32)


def _q(rng, shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


# --- K7v, K8v, K10v, K9 plain versions vs the JAX pieces ------------------------------

@pytest.mark.parametrize("cin,cout", [(16, 32), (96, 32), (6, 5), (384, 16)],
                         ids=["encode2-pad", "decode1-nf8", "odd", "decode1-nf32"])
def test_qconv3x3x3_plain_matches_jax(cin, cout):
    rng = np.random.default_rng(cin + cout)
    shape = (2, 4, 5, 6, cin) if cin < 300 else (1, 3, 4, 4, cin)
    x = _q(rng, shape)
    w_dhwio = _q(rng, (3, 3, 3, cin, cout))
    sw = (rng.random(cout) * 1e-4 + 1e-5).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    s_out = np.float32(0.0371)

    @jax.jit
    def ref(x, w, sw, bias, s_out):
        # quant3d.py:269 qconv
        y = lax.conv_general_dilated(x, w, (1, 1, 1), "SAME", dimension_numbers=_DN3,
                                     preferred_element_type=jnp.int32)
        a = y.astype(jnp.float32) * sw + bias
        return jquant._requant(jax.nn.leaky_relu(a, 0.1), s_out)

    want = np.asarray(ref(x, w_dhwio, sw, bias, s_out))
    assert 0 < np.abs(want).max() and (np.abs(want) < 127).any()
    w = np.zeros((cout, 3, 3, 3, -(-cin // 32) * 32), np.int8)
    w[..., :cin] = np.transpose(w_dhwio, (4, 0, 1, 2, 3))
    args = (torch.from_numpy(w), torch.from_numpy(sw), torch.from_numpy(bias), float(s_out))
    got = k.qconv3x3x3(torch.from_numpy(x), *args)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    # into channels [3, 3 + O) of a wider buffer, its other channels untouched
    buf = torch.full(shape[:-1] + (cout + 5,), 99, dtype=torch.int8)
    assert k.qconv3x3x3(torch.from_numpy(x), *args, out=buf, offset=3) is buf
    np.testing.assert_array_equal(buf[..., 3:3 + cout].numpy(), want)
    assert (buf[..., :3] == 99).all() and (buf[..., 3 + cout:] == 99).all()


@pytest.mark.parametrize("cin,cout", [(64, 64), (16, 8), (5, 3)])
def test_qconvt2x2x2_plain_matches_jax(cin, cout):
    rng = np.random.default_rng(3 * cin + cout)
    x = _q(rng, (2, 3, 4, 5, cin))
    w_jax = _q(rng, (2, 2, 2, cout, cin))  # (kd, kh, kw, O, I) under transpose_kernel
    sw = np.float32(0.00042)
    bias = rng.standard_normal(cout).astype(np.float32)
    s_out = np.float32(0.057)

    @jax.jit
    def ref(x, w, sw, bias, s_out):
        # quant3d.py:277 qtconv
        y = lax.conv_transpose(x, w, (2, 2, 2), "VALID", dimension_numbers=_DN3,
                               transpose_kernel=True, preferred_element_type=jnp.int32)
        return jquant._requant(y.astype(jnp.float32) * sw + bias, s_out)

    want = np.asarray(ref(x, w_jax, sw, bias, s_out))
    w = np.zeros((2, 2, 2, cout, 32 * -(-cin // 32)), np.int8)
    w[..., :cin] = w_jax
    # into the first channels of a concat buffer, its other channels untouched
    buf = torch.full((2, 6, 8, 10, cout + 4), 99, dtype=torch.int8)
    out = k.qconvt2x2x2(torch.from_numpy(x), torch.from_numpy(w), torch.full((cout,), float(sw)),
                        torch.from_numpy(bias), float(s_out), out=buf, offset=0)
    assert out is buf
    np.testing.assert_array_equal(buf[..., :cout].numpy(), want)
    assert (buf[..., cout:] == 99).all()


@pytest.mark.parametrize("shape", [(2, 8, 6, 4, 16), (1, 7, 5, 9, 3), (2, 4, 4, 4, 32)])
def test_maxpool_i8_3d_plain_matches_jax(shape):
    x = _q(np.random.default_rng(sum(shape)), shape)
    want = np.asarray(jax.jit(jquant3d._maxpool_i8_3d)(x))
    np.testing.assert_array_equal(k.maxpool_i8_3d(torch.from_numpy(x)).numpy(), want)


def test_requant_on_ndhwc_matches_jax():
    rng = np.random.default_rng(9)
    skip = _q(rng, (2, 4, 6, 5, 7))
    # the raw skip into channels [C_up, ...) of the concat buffer: s_a = s_b = 1
    buf = torch.zeros((2, 4, 6, 5, 11), dtype=torch.int8)
    k.requant(torch.from_numpy(skip), 1.0, 1.0, out=buf, offset=4)
    np.testing.assert_array_equal(buf[..., 4:].numpy(), skip)
    assert (buf[..., :4] == 0).all()
    # encode1's bf16 output → int8 (quant3d.py:291) and the dequant of d6 (:317)
    e1 = jnp.asarray((rng.standard_normal((2, 4, 6, 5, 3)) * 3).astype(np.float32),
                     jnp.bfloat16)
    want = np.asarray(jax.jit(lambda e: jquant._requant(e.astype(jnp.float32),
                                                        np.float32(0.0625)))(e1))
    got = k.requant(torch.tensor(np.asarray(e1.astype(jnp.float32))).bfloat16(), 1.0, 0.0625)
    np.testing.assert_array_equal(got.numpy(), want)
    sa = np.float32(0.0371)
    want = np.asarray(jax.jit(lambda h: (h.astype(jnp.float32) * sa).astype(jnp.bfloat16))(skip))
    got = k.requant(torch.from_numpy(skip), float(sa))
    np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))


@pytest.mark.parametrize("shape", [(2, 4, 8, 8, 32), (1, 3, 5, 2, 7), (2, 1, 1, 3, 16),
                                   (2, 2, 3, 3, 256), (2, 2, 4, 4, 128), (1, 1, 4, 6, 64)])
def test_upsample2x_i8_3d_plain_matches_jax(shape):
    """K11v's plain version is the trilinear decoder's torch-call path
    (``F.interpolate``, round half to even, clip) bit for bit, and both equal
    JAX's ``upsample_linear`` + round + clip (``quant3d.py:305-310``), into
    the first channels of a concat buffer."""
    from bio_image_unet_tpu.ops.functional import upsample_linear as jup

    x = _q(np.random.default_rng(sum(shape) + 5), shape)
    want = np.asarray(jax.jit(lambda q: jnp.clip(jnp.round(jup(q.astype(jnp.float32), 2)),
                                                 -127, 127).astype(jnp.int8))(x))
    t = torch.from_numpy(x)
    calls = torch.clamp(torch.round(torch.nn.functional.interpolate(
        t.permute(0, 4, 1, 2, 3).float(), scale_factor=2, mode="trilinear",
        align_corners=False)), -127, 127).to(torch.int8).permute(0, 2, 3, 4, 1)
    np.testing.assert_array_equal(calls.numpy(), want)
    c = shape[-1]
    buf = torch.full(calls.shape[:-1] + (c + 5,), 99, dtype=torch.int8)
    assert k.upsample2x_i8_3d(t, out=buf) is buf
    np.testing.assert_array_equal(buf[..., :c].numpy(), want)
    assert (buf[..., c:] == 99).all()
    np.testing.assert_array_equal(k.upsample2x_i8_3d(t).numpy(), want)


# --- K11v's integer arithmetic, modelled in numpy ---------------------------------
# ``csrc/int8_resample.cu``'s K11v blends biased values (v + 128) in 16-bit
# lanes, two channels a uint32 word, with one integer multiply-add an axis
# (3·near + far), and rounds each lane's S + 64·128 by a max with 64, an add
# of 31 and of bit 6, and a shift.  The model below does the same word
# arithmetic (uint32, wrapping as the card does) so that a carry between
# lanes or a wrong rounding would show against the plain version.

_M32 = np.uint32


def _k11v_axis(n):
    """For each of the 2n outputs of an axis of n inputs: the input it takes
    3/4 of and the one it takes 1/4 of (clamped at the borders)."""
    o = np.arange(2 * n)
    j = o >> 1
    return j, np.where(o & 1, np.minimum(j + 1, n - 1), np.maximum(j - 1, 0))


def _k11v_round(s):
    """The kernel's rounding of packed biased lane sums (``k11v_round``)."""
    s = np.maximum(s & _M32(0xFFFF), _M32(0x40)) | (np.maximum(s >> _M32(16), _M32(0x40))
                                                    << _M32(16))
    return (s + _M32(0x001F001F) + ((s >> _M32(6)) & _M32(0x00010001))) >> _M32(6)


def _k11v_model(x):
    """(n, d, h, w, c) int8 -> the kernel's (n, 2d, 2h, 2w, c) int8: bias,
    spread channels (0, 2) and (1, 3) of each four into two words, blend W,
    then H, then D, round, pack and unbias."""
    n, d, h, w, c = x.shape
    c4 = -(-c // 4) * 4
    u = np.zeros((n, d, h, w, c4), np.uint8)
    u[..., :c] = x.view(np.uint8) ^ 0x80
    u = u.reshape(n, d, h, w, c4 // 4, 4).astype(np.uint32)
    words = np.stack([u[..., 0] | (u[..., 2] << _M32(16)), u[..., 1] | (u[..., 3] << _M32(16))],
                     axis=-1)
    for axis in (3, 2, 1):  # W, H, D as the kernel walks them
        near, far = _k11v_axis(words.shape[axis])
        words = (np.take(words, near, axis) * _M32(3) + np.take(words, far, axis)).astype(np.uint32)
    r = _k11v_round(words)
    even, odd = r[..., 0], r[..., 1]
    out = np.stack([even & 0xFF, odd & 0xFF, (even >> 16) & 0xFF, (odd >> 16) & 0xFF], axis=-1)
    out = (out.astype(np.uint8) ^ 0x80).view(np.int8)
    return out.reshape(n, 2 * d, 2 * h, 2 * w, c4)[..., :c]


@pytest.mark.parametrize("shape", [(2, 3, 5, 4, 8), (1, 1, 1, 1, 4), (1, 4, 1, 7, 6),
                                   (2, 2, 3, 2, 64), (1, 1, 6, 1, 3)])
def test_k11v_integer_model_equals_plain(shape):
    """The kernel's integer arithmetic equals K11v's plain version on random
    bricks holding -128 and 127 at the borders, and on bricks all -128 (the
    clip) and all 127."""
    rng = np.random.default_rng(sum(shape))
    x = rng.integers(-128, 128, shape).astype(np.int8)
    x[:, 0], x[:, :, -1], x[..., 0, :] = -128, 127, -128
    for brick in (x, np.full(shape, -128, np.int8), np.full(shape, 127, np.int8)):
        want = k.upsample2x_i8_3d_plain(torch.from_numpy(brick)).numpy()
        np.testing.assert_array_equal(_k11v_model(brick), want)


@pytest.mark.parametrize("axis", [1, 2, 3], ids=["d", "h", "w"])
def test_k11v_integer_model_on_every_pair_at_each_weight(axis):
    """Along one axis of two inputs (a, b) the four outputs take the weights
    1 (4a), 3/4 + 1/4 (3a + b), 1/4 + 3/4 (a + 3b) and 1 (4b): every pair of
    int8 values, one a channel, through the model equals the plain version."""
    a, b = np.meshgrid(np.arange(-128, 128), np.arange(-128, 128), indexing="ij")
    shape = [1, 1, 1, 1, a.size]
    shape[axis] = 2
    x = np.stack([a.ravel(), b.ravel()]).astype(np.int8).reshape(shape)
    want = k.upsample2x_i8_3d_plain(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(_k11v_model(x), want)


def test_k11v_rounding_is_rint_of_the_sum_over_64_for_every_sum():
    """Every blend S in [-8192, 8128] (64ths of values in [-128, 127]): the
    kernel's lane rounding of S + 64·128 is rint(S / 64) clipped at -127
    (np.rint of the exact float32 quotient, half to even), plus 128, in both
    lanes of a word with any neighbour."""
    s_all = np.arange(-8192, 8129)
    want = np.clip(np.rint(s_all.astype(np.float32) / np.float32(64)), -127, 127) + 128
    other = np.random.default_rng(0).permutation(s_all)
    for lo, hi in ((s_all, other), (other, s_all)):
        words = ((lo + 8192).astype(np.uint32) | ((hi + 8192).astype(np.uint32) << _M32(16)))
        r = _k11v_round(words)
        got = r & 0xFF if lo is s_all else (r >> 16) & 0xFF
        np.testing.assert_array_equal(got, want)


def test_3d_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros((1, 2, 4, 4, 8), dtype=torch.int8)
    w = torch.zeros((4, 3, 3, 3, 32), dtype=torch.int8)
    sw, b = torch.ones(4), torch.zeros(4)
    with pytest.raises(ValueError, match="NDHWC int8"):
        k.qconv3x3x3(x[0], w, sw, b, 1.0)
    with pytest.raises(ValueError, match="taps"):
        k.qconv3x3x3(x, torch.zeros((4, 3, 3, 2, 32), dtype=torch.int8), sw, b, 1.0)
    with pytest.raises(ValueError, match="padded"):
        k.qconv3x3x3(torch.zeros((1, 2, 4, 4, 40), dtype=torch.int8), w, sw, b, 1.0)
    with pytest.raises(ValueError, match="offset"):
        k.qconv3x3x3(x, w, sw, b, 1.0, out=torch.zeros((1, 2, 4, 4, 6), dtype=torch.int8),
                     offset=3)
    with pytest.raises(ValueError, match="taps"):
        k.qconvt2x2x2(x, w, sw, b, 1.0)
    with pytest.raises(ValueError, match="NDHWC int8"):
        k.maxpool_i8_3d(x.float())


# --- the graph: weight store, calibrator, forward ------------------------------------

@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    """Per decoder variant: the port's model, JAX's (apply_fn,
    make_variables) and calibrator, JAX's folded weights in the port's
    layout, the test tiles and JAX's calibrated maxes with the 1.1 margin."""
    root = tmp_path_factory.mktemp("quant3d_pt")
    out = {}
    for i, (name, (registry, seed, extra)) in enumerate(MODELS.items()):
        path, variables = write_seeded_checkpoint(root, name, registry, seed, n_filter=8,
                                                  warm=True, **extra)
        state = checkpoint.load(path)
        net = get_model(registry, **state["hyperparams"])
        net.load_state_dict(state["state_dict"])
        jm = jmodels.get_model(registry, n_filter=8, in_channels=1, **extra)
        apply_fn, make = jquant3d.build_int8_apply_3d(jm, variables)
        cal = jquant3d.build_calibrator_3d(jm, variables)
        x = _volumes(70 + i)
        out[name] = dict(net=net.eval(), apply=jax.jit(apply_fn), make=make, cal=cal, x=x,
                         maxes=np.asarray(cal(jnp.asarray(x[..., None]))) * np.float32(1.1),
                         folded=port_folded(variables), extra=extra)
    return out


def _volumes(seed, n=4):
    """(n, 16, 32, 32) float32 tiles in [0, 1]: noise and a bright blob."""
    rng = np.random.default_rng(seed)
    zz, yy, xx = np.mgrid[:TILE[0], :TILE[1], :TILE[2]]
    blob = np.exp(-((zz - 8) ** 2 * 4 + (yy - 12 - seed % 5) ** 2 + (xx - 18) ** 2) / 60.0)
    return np.clip(rng.random((n,) + TILE) * 0.4 + blob * 0.6, 0, 1).astype(np.float32)


def _jax_lookups(make, maxes):
    """JAX's named weight getters (``w8``, ``f32``) of ``make_variables(maxes)``
    — the lookups its ``apply_fn`` reads, from the closure that holds them."""
    jvars = make(maxes)
    cells = dict(zip(make.__code__.co_freevars, (c.cell_contents for c in make.__closure__)))
    return jvars, cells["_lookups"][0](jvars)


@pytest.mark.parametrize("name", list(MODELS))
def test_weight_store_equals_build_pack(graphs, name):
    g = graphs[name]
    jvars, (w8, f32) = _jax_lookups(g["make"], g["maxes"])
    interp, heads = g["net"].use_interpolation, g["net"].heads
    sites = quant3d._sites_3d(interp, heads is not None)
    scales = dict(zip(sites, quant.act_scales(g["maxes"])))
    np.testing.assert_array_equal(np.asarray(jvars[2]), quant.act_scales(g["maxes"]))
    store = quant3d._quantize(g["folded"], scales, interp, heads, "cpu")
    names = [n for n in store.conv]
    assert len(names) == 13 + 3 * ((not interp) or heads is not None)
    for n in names:
        codes, sw, bias = (t.numpy() for t in store.conv[n])
        ref = np.asarray(w8(n))
        if n.startswith("up") and not n.endswith("_conv"):  # (2, 2, 2, O, I), per tensor
            got = codes[..., :ref.shape[-1]]
            np.testing.assert_array_equal(sw, np.full(ref.shape[3], np.asarray(f32(f"{n}.sw"))))
            cin = ref.shape[-1]
        else:  # (O, 3, 3, 3, I_pad) against (3, 3, 3, I, O)
            got = np.transpose(codes[..., :ref.shape[3]], (1, 2, 3, 4, 0))
            np.testing.assert_array_equal(sw, np.asarray(f32(f"{n}.sw")))
            cin = ref.shape[3]
        assert codes.shape[-1] % 32 == 0 and not codes[..., cin:].any(), n
        np.testing.assert_array_equal(got, ref, err_msg=n)
        np.testing.assert_array_equal(bias, np.asarray(f32(f"{n}.bias")), err_msg=n)
    assert quant3d._sites_3d(interp, heads is not None) == jquant3d._sites_3d(
        interp, heads is not None)


@pytest.mark.parametrize("name", list(MODELS))
def test_calibrator_matches_jax(graphs, name):
    g = graphs[name]
    cal_fn, _ = quant.int8_builders(g["net"], "cpu")
    ours = cal_fn(torch.from_numpy(g["x"][:, None]))
    assert ours.dtype == np.float32 and ours.shape == g["maxes"].shape
    np.testing.assert_allclose(ours * np.float32(1.1), g["maxes"], rtol=2e-2)


@pytest.mark.parametrize("name", list(MODELS))
def test_int8_forward_matches_jax(graphs, name):
    """On JAX's folded weights and maxes the logits and heads are equal, the
    probabilities within 6e-8 and so the uint8 masks within one level on at
    most 0.1% of voxels."""
    g = graphs[name]
    ref = g["apply"](g["make"](g["maxes"]), jnp.asarray(g["x"][..., None]))
    fwd = quant3d.build_int8_apply_3d(g["net"], "cpu", g["folded"])(g["maxes"])
    assert isinstance(fwd, quant3d.Int8UNet3D)
    with torch.inference_mode():
        ours = fwd(torch.from_numpy(g["x"][:, None]))
    if isinstance(ref, dict):
        assert set(ours) == set(ref)
        for head, v in ref.items():
            assert ours[head].dtype == torch.float32
            np.testing.assert_array_equal(np.moveaxis(ours[head].numpy(), 1, -1), np.asarray(v),
                                          err_msg=head)
        return
    assert ours[1].dtype == torch.float32
    np.testing.assert_array_equal(ours[1][:, 0].numpy(), np.asarray(ref[1])[..., 0])
    probs, probs_ref = ours[0][:, 0].numpy(), np.asarray(ref[0])[..., 0]
    np.testing.assert_allclose(probs, probs_ref, rtol=0, atol=6e-8)
    assert_u8_contract((probs * 255.0).astype(np.uint8), (probs_ref * 255.0).astype(np.uint8))
