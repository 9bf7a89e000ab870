"""The port's w8a8 int8 trunk (``bio_image_unet_tpu_torch.predict.quant``,
``ops.int8``) held against the JAX package's ``predict/quant.py`` on the CPU.

- K7–K10's plain versions equal the matching JAX pieces bit for bit (int8
  out; bf16 for the dequant), at dilation 1 and 2 and with channel counts
  that are not multiples of 4;
- the port's int8 weight store, built from JAX's folded float32 arrays,
  equals ``_WeightPack``'s codes and scales bit for bit;
- ``int8_status`` answers as JAX's for every model class the port builds,
  with and without ``BIU_INT8_EXPERIMENTAL``;
- the calibrator's per-site maxes are within 2e-2 relative of JAX's
  ``build_calibrator`` (bf16 forwards on both sides);
- the int8 forward, given JAX's calibrated maxes, gives uint8 masks within
  one level of ``build_int8_apply``'s on at most 0.1% of pixels (heads
  within atol 2e-3).

Checkpoints are drawn in the port (``torch_parity.write_seeded_checkpoint``)
at ``n_filter=4``; inputs are 32² tiles drawn with numpy from a seed.
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from bio_image_unet_tpu import models as jmodels
from bio_image_unet_tpu.predict import quant as jquant
from bio_image_unet_tpu.predict.fastpath import fold_unet2d as jfold
from bio_image_unet_tpu_torch import checkpoint
from bio_image_unet_tpu_torch.models import get_model
from bio_image_unet_tpu_torch.ops import int8 as k
from bio_image_unet_tpu_torch.predict import quant
from torch_parity import assert_u8_contract, port_folded, write_seeded_checkpoint

_DN = ("NHWC", "HWIO", "NHWC")
HEADS = {"mask": {"channels": 1, "activation": "sigmoid"},
         "orientation": {"channels": 2, "activation": None}}
# (name, registry, seed, extra hyperparameters)
MODELS = {
    "unet": ("Unet", 40, {}),
    "unet_d2": ("Unet", 41, {"dilation": 2}),
    "mo": ("MultiOutputUnet", 42, {"output_heads": HEADS}),
    "siam_max": ("Siam_UNet", 43, {"mode": "max"}),
    "siam_control": ("Siam_UNet", 44, {"mode": "control"}),
    "siam_concat": ("Siam_UNet", 45, {"mode": "concat"}),
}


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("quant_pt")
    out = {}
    for name, (registry, seed, extra) in MODELS.items():
        path, variables = write_seeded_checkpoint(root, name, registry, seed, **extra)
        out[name] = (path, variables, registry, extra)
    return out


def _port_model(path):
    state = checkpoint.load(path)
    net = get_model(state["hyperparams"]["model_name"], **state["hyperparams"])
    net.load_state_dict(state["state_dict"])
    return net.eval()


def _jax_model(registry, extra):
    return jmodels.get_model(registry, n_filter=4, in_channels=1, **extra)


def _tiles(seed, n=6, size=32):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (n, size, size)).astype(np.float32) / np.float32(255.0)
    # a bright moving disc, so the twin encoder and the heads see structure
    yy, xx = np.mgrid[:size, :size]
    disc = ((yy - size / 2) ** 2 + (xx - size / 3 - seed % 5) ** 2) < (size / 4) ** 2
    return np.clip(x * 0.5 + disc * 0.5, 0, 1).astype(np.float32)


# --- K7–K10 plain versions vs the JAX pieces ----------------------------------------

def _q(rng, shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


@pytest.mark.parametrize("cin,cout,dil", [(8, 16, 1), (6, 5, 2), (33, 7, 1), (4, 40, 2)])
def test_qconv3x3_plain_matches_jax(cin, cout, dil):
    rng = np.random.default_rng(cin * 100 + cout + dil)
    x = _q(rng, (3, 10, 12, cin))
    w_hwio = _q(rng, (3, 3, cin, cout))
    sw = (rng.random(cout) * 0.01 + 1e-3).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    s_in, s_out = np.float32(0.0137), np.float32(0.211)

    @jax.jit
    def ref(x, w, s_in, sw, bias, s_out):
        # quant.py:417 qconv
        y = lax.conv_general_dilated(x, w, (1, 1), "SAME", rhs_dilation=(dil, dil),
                                     dimension_numbers=_DN, preferred_element_type=jnp.int32)
        a = y.astype(jnp.float32) * (s_in * sw) + bias
        return jquant._requant(jax.nn.leaky_relu(a, 0.1), s_out)

    want = np.asarray(ref(x, w_hwio, s_in, sw, bias, s_out))
    w = np.zeros((cout, 3, 3, -(-cin // 32) * 32), np.int8)
    w[..., :cin] = np.transpose(w_hwio, (3, 0, 1, 2))
    got = k.qconv3x3(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(sw),
                     torch.from_numpy(bias), float(s_in), float(s_out), dil)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("cin,cout", [(16, 8), (5, 3), (40, 12)])
def test_qconvt2x2_plain_matches_jax(cin, cout):
    rng = np.random.default_rng(cin + 7 * cout)
    x = _q(rng, (2, 5, 6, cin))
    w_jax = _q(rng, (2, 2, cout, cin))  # (kh, kw, O, I) under transpose_kernel
    sw = np.float32(0.0042)
    bias = rng.standard_normal(cout).astype(np.float32)
    s_in, s_out = np.float32(0.031), np.float32(0.057)

    @jax.jit
    def ref(x, w, s_in, sw, bias, s_out):
        # quant.py:428 qtconv
        y = lax.conv_transpose(x, w, (2, 2), "VALID", dimension_numbers=_DN,
                               transpose_kernel=True, preferred_element_type=jnp.int32)
        a = y.astype(jnp.float32) * (s_in * sw) + bias
        return jquant._requant(a, s_out)

    want = np.asarray(ref(x, w_jax, s_in, sw, bias, s_out))
    w = np.zeros((2, 2, cout, 32 * -(-cin // 32)), np.int8)
    w[..., :cin] = w_jax
    # into the first channels of a concat buffer, its other channels untouched
    buf = torch.full((2, 10, 12, cout + 3), 99, dtype=torch.int8)
    out = k.qconvt2x2(torch.from_numpy(x), torch.from_numpy(w),
                      torch.full((cout,), float(sw)), torch.from_numpy(bias), float(s_in),
                      float(s_out), out=buf, offset=0)
    assert out is buf
    np.testing.assert_array_equal(buf[..., :cout].numpy(), want)
    assert (buf[..., cout:] == 99).all()


def test_requant_plain_matches_jax():
    rng = np.random.default_rng(5)
    x8 = _q(rng, (2, 6, 7, 5))
    sa, sb = np.float32(0.0371), np.float32(0.0413)
    # the skip rescale (quant.py:487-488) into channels [C, 2C)
    want = np.asarray(jax.jit(lambda x: jquant._requant(x.astype(jnp.float32) * sa, sb))(x8))
    buf = torch.zeros((2, 6, 7, 10), dtype=torch.int8)
    k.requant(torch.from_numpy(x8), float(sa), float(sb), out=buf, offset=5)
    np.testing.assert_array_equal(buf[..., 5:].numpy(), want)
    assert (buf[..., :5] == 0).all()
    # encode1's bf16 output (quant.py:441), ties of the half-even rounding included
    e1 = (rng.standard_normal((2, 6, 7, 5)) * 3).astype(np.float32)
    e1[0, 0, 0, :3] = np.array([0.5, 1.5, -2.5], np.float32) * 0.0625
    e1_bf = jnp.asarray(e1, jnp.bfloat16)
    want = np.asarray(jax.jit(lambda e: jquant._requant(e.astype(jnp.float32),
                                                        np.float32(0.0625)))(e1_bf))
    got = k.requant(torch.tensor(np.asarray(e1_bf.astype(jnp.float32))).bfloat16(), 1.0, 0.0625)
    np.testing.assert_array_equal(got.numpy(), want)
    assert list(got[0, 0, 0, :3].numpy()) == [0, 2, -2]
    # the dequant before the head (quant.py:495)
    want = np.asarray(jax.jit(lambda h: (h.astype(jnp.float32) * sa).astype(jnp.bfloat16))(x8))
    got = k.requant(torch.from_numpy(x8), float(sa))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))


@pytest.mark.parametrize("shape", [(2, 8, 6, 3), (1, 7, 5, 4)])
def test_maxpool_i8_plain_matches_jax(shape):
    x = _q(np.random.default_rng(sum(shape)), shape)
    want = np.asarray(jax.jit(jquant._maxpool_i8)(x))
    np.testing.assert_array_equal(k.maxpool_i8(torch.from_numpy(x)).numpy(), want)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros((1, 4, 4, 8), dtype=torch.int8)
    w = torch.zeros((4, 3, 3, 32), dtype=torch.int8)
    sw, b = torch.ones(4), torch.zeros(4)
    with pytest.raises(ValueError, match="int8"):
        k.qconv3x3(x.float(), w, sw, b, 1.0, 1.0)
    with pytest.raises(ValueError, match="padded"):
        k.qconv3x3(torch.zeros((1, 4, 4, 40), dtype=torch.int8), w, sw, b, 1.0, 1.0)
    with pytest.raises(ValueError, match="offset"):
        k.requant(x, 1.0, 1.0, out=torch.zeros((1, 4, 4, 10), dtype=torch.int8), offset=4)
    with pytest.raises(ValueError, match="int8"):
        k.maxpool_i8(x.float())


# (channels, byte shift of the view, expected input copy width)
@pytest.mark.parametrize("cin,shift,want", [(32, 0, 16), (48, 0, 16), (16, 0, 16), (40, 0, 8),
                                            (12, 0, 4), (33, 0, 1), (32, 4, 4), (32, 8, 8),
                                            (64, 2, 1)])
def test_qconv_input_copy_width(cin, shift, want):
    # K7/K8's cp.async width: the widest of 16, 8, 4 bytes that every pixel's
    # channel run starts on, else byte loads
    flat = torch.zeros(3 * cin + 64, dtype=torch.int8)
    base = (-flat.data_ptr()) % 64  # a 64-byte-aligned start
    x = flat[base + shift:base + shift + 3 * cin].view(1, 1, 3, cin)
    assert k._in_vec(x) == want


# (cout, row stride, channel offset, expected store width)
@pytest.mark.parametrize("cout,stride,offset,want", [(32, 32, 0, 16), (32, 64, 0, 16),
                                                     (64, 96, 0, 16), (16, 23, 7, 1),
                                                     (24, 24, 0, 8), (36, 72, 0, 4),
                                                     (5, 5, 0, 1), (32, 65, 33, 1),
                                                     (6, 10, 2, 2), (32, 48, 16, 16)])
def test_qconv_output_store_width(cout, stride, offset, want):
    # the widest of 16, 8, 4, 2, 1 bytes dividing cout, the row stride, the
    # offset and the address: one store never straddles a pixel or a tap
    out = torch.zeros((2, 3, stride), dtype=torch.int8)
    assert out.data_ptr() % 16 == 0
    assert k._out_vec(out, cout, offset) == want


# --- weight store, status ------------------------------------------------------------

def test_weight_store_equals_weightpack(ckpts):
    _, variables, _, _ = ckpts["siam_concat"]
    folded = jax.tree_util.tree_map(np.asarray, jfold(variables))
    pack = jquant._WeightPack()
    store = quant.Int8Weights("cpu")
    convs = [f"encode{i}" for i in range(2, 9)] + ["conv_concat", "middle_conv1",
                                                   "decode1", "decode8"]
    for name in convs + ["up1", "up4"]:
        per_channel = not name.startswith("up")
        pack.quant_conv(name, folded[name], per_channel=per_channel)
        # the port's layout: OIHW for a conv, (I, O, 2, 2) for a transposed conv
        kern = np.transpose(folded[name]["kernel"], (3, 2, 0, 1))
        store.quant_conv(name, {"weight": torch.from_numpy(np.ascontiguousarray(kern)),
                                "bias": torch.from_numpy(np.asarray(folded[name]["bias"]))},
                         per_channel=per_channel)
    i8_buf, f32_buf, lookups = pack.finish()
    w8, f32 = lookups((i8_buf, f32_buf, None))
    for name in convs + ["up1", "up4"]:
        codes, sw, bias = store.conv[name]
        ref = np.asarray(w8(name))
        if name.startswith("up"):
            got = codes.numpy()[..., :ref.shape[-1]]  # (2, 2, O, I), JAX's own layout
            np.testing.assert_array_equal(sw.numpy(), np.full(ref.shape[2],
                                                              np.asarray(f32(f"{name}.sw"))))
        else:
            got = np.transpose(codes.numpy()[..., :ref.shape[2]], (1, 2, 3, 0))
            np.testing.assert_array_equal(sw.numpy(), np.asarray(f32(f"{name}.sw")))
        cin = ref.shape[3] if name.startswith("up") else ref.shape[2]
        assert codes.shape[-1] % 32 == 0 and not codes.numpy()[..., cin:].any()
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(bias.numpy(), np.asarray(f32(f"{name}.bias")))


_STATUS_MODELS = [
    ("Unet", {}), ("Unet", {"dilation": 2}), ("AttentionUnet", {}),
    ("MultiOutputUnet", {"output_heads": HEADS}),
    ("Siam_UNet", {"mode": "max"}), ("Siam_UNet", {"mode": "control"}),
    ("Siam_UNet", {"mode": "concat"}), ("Siam_UNet", {"mode": "corr"}),
    ("MultiOutputNestedUNet", {"output_heads": HEADS}),
    ("MultiOutputNestedUNet_3Levels", {"output_heads": HEADS}),
    ("UNet3D", {}), ("UNet3D", {"use_interpolation": True}),
    ("MultiOutputUnet3D", {"output_heads": HEADS}),
    ("MultiOutputUnet3D", {"output_heads": HEADS, "use_interpolation": True}),
]


@pytest.mark.parametrize("env", [None, "1", "0", "off", "yes"])
def test_int8_status_matches_jax(monkeypatch, env):
    if env is None:
        monkeypatch.delenv("BIU_INT8_EXPERIMENTAL", raising=False)
    else:
        monkeypatch.setenv("BIU_INT8_EXPERIMENTAL", env)
    for registry, extra in _STATUS_MODELS:
        ours = get_model(registry, n_filter=4, **extra)
        ref = jmodels.get_model(registry, n_filter=4, **extra)
        assert quant.int8_status(ours) == jquant.int8_status(ref), (registry, extra, env)
        assert quant.supports_int8(ours) == jquant.supports_int8(ref)
        assert quant._int8_family(ours) == jquant._int8_family(ref)
    assert quant._sites("concat") == jquant._sites("concat")
    assert quant._sites(None) == jquant._sites(None)
    assert quant._SKIPS == jquant._SKIPS and quant._INT8_MODES == jquant._INT8_MODES


# --- calibrator and the int8 forward -----------------------------------------------------

@pytest.fixture(scope="module")
def jax_int8(ckpts):
    """Per model: the JAX triple, the port's pair, the test tiles and JAX's
    calibrated maxes (with the engine's 1.1 margin)."""
    out = {}
    for i, (name, (path, variables, registry, extra)) in enumerate(ckpts.items()):
        jm = _jax_model(registry, extra)
        cal, apply_fn, make = jquant.int8_builders(jm, variables)
        net = _port_model(path)
        x = _tiles(10 * i)
        prev = _tiles(10 * i + 1) if registry == "Siam_UNet" else None
        args = (x[..., None],) if prev is None else (x[..., None], prev[..., None])
        maxes = np.asarray(cal(*[jnp.asarray(a) for a in args]))
        out[name] = dict(net=net, cal=cal, apply=jax.jit(apply_fn), make=make, x=x, prev=prev,
                         maxes=maxes, folded=port_folded(variables))
    return out


def _t(a):
    return None if a is None else torch.from_numpy(a[:, None])


@pytest.mark.parametrize("name", list(MODELS))
def test_calibrator_matches_jax(jax_int8, name):
    r = jax_int8[name]
    cal_fn, _ = quant.int8_builders(r["net"], "cpu")
    ours = cal_fn(_t(r["x"]), _t(r["prev"]))
    assert ours.dtype == np.float32 and ours.shape == r["maxes"].shape
    np.testing.assert_allclose(ours, r["maxes"], rtol=2e-2)


def test_control_calibration_encodes_prev(jax_int8):
    """Under ``control`` the bf16 forward skips prev's encoder, but the
    calibrator must not: a prev plane much brighter than cur raises the
    encoder sites' maxes, as in JAX."""
    r = jax_int8["siam_control"]
    cal_fn, _ = quant.int8_builders(r["net"], "cpu")
    bright = np.clip(r["prev"] * 4.0, 0, 1).astype(np.float32)
    ours = cal_fn(_t(r["x"] * 0.2), _t(bright))
    ref = np.asarray(r["cal"](jnp.asarray(r["x"][..., None] * 0.2),
                              jnp.asarray(bright[..., None])))
    np.testing.assert_allclose(ours, ref, rtol=2e-2)
    alone = cal_fn(_t(r["x"] * 0.2), _t(r["x"] * 0.2))
    assert (ours[:8] > alone[:8]).any()


@pytest.mark.parametrize("name", list(MODELS))
def test_int8_forward_matches_jax(jax_int8, name):
    r = jax_int8[name]
    maxes = r["maxes"] * 1.1
    jvars = r["make"](maxes)
    args = (r["x"][..., None],) if r["prev"] is None else (r["x"][..., None],
                                                            r["prev"][..., None])
    ref = r["apply"](jvars, *[jnp.asarray(a) for a in args])
    fwd = quant.build_int8_apply(r["net"], "cpu", r["folded"])(maxes)
    with torch.inference_mode():
        ours = fwd(_t(r["x"]), _t(r["prev"]))
    if isinstance(ref, dict):
        for head, v in ref.items():
            got = ours[head].permute(0, 2, 3, 1).numpy()
            np.testing.assert_allclose(got, np.asarray(v), atol=2e-3)
        return
    probs_ref = (np.asarray(ref[0])[..., 0] * 255.0).astype(np.uint8)
    probs = (ours[0][:, 0].numpy() * 255.0).astype(np.uint8)
    assert_u8_contract(probs, probs_ref)


def test_port_and_chip_smoke_import_no_jax():
    """No module of the port, and not ``chip_smoke.py``, imports JAX, flax,
    ml_dtypes or the JAX package (a name matched exactly or followed by '.':
    the port's own name starts with the JAX package's)."""
    blocked = ("jax", "jaxlib", "flax", "optax", "ml_dtypes", "bio_image_unet_tpu")
    repo = Path(__file__).resolve().parent.parent
    files = sorted((repo / "bio_image_unet_tpu_torch").rglob("*.py")) + [repo / "chip_smoke.py"]
    assert any(f.name == "quant.py" for f in files) and any(f.name == "int8.py" for f in files)
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            bad = [n for n in names if any(n == b or n.startswith(b + ".") for b in blocked)]
            assert not bad, (str(path), bad)
