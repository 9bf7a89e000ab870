"""The port's w8a8 int8 graph of UNet++
(``bio_image_unet_tpu_torch.predict.quant_nested``, K11 in ``ops.int8``)
held against the JAX package's ``predict/quant_nested.py`` on the CPU.

- ``_grid_order`` and ``_sites_nested`` equal JAX's at both depths;
- K11's plain version (the ×2 ``align_corners=True`` bilinear of int8
  values) equals JAX's ``upsample_linear`` + round + clip bit for bit on odd
  sizes and channel counts, into a channel range of a wider buffer;
- the weight store, quantized at the same maxes from JAX's folded float32
  arrays with the activation scales folded in, equals ``_build_pack``'s
  codes, scales and biases;
- the calibrator's per-site maxes are within 2e-2 relative of
  ``build_calibrator_nested``'s (bf16 forwards on both sides);
- ``Int8NestedUNet`` on JAX's folded weights and calibrated maxes equals
  ``build_int8_apply_nested``'s ``apply_fn`` bit for bit on every head.

``tests/test_torch_predict_quant_nested.py`` holds the Predict path.

The models, BN-warmed in the port at ``n_filter=4``
(``torch_parity.write_seeded_checkpoint``): ``MultiOutputNestedUNet`` (4
levels) with and without deep supervision, ``MultiOutputNestedUNet_3Levels``
likewise; tiles of 48² drawn with numpy from a seed.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bio_image_unet_tpu import models as jmodels
from bio_image_unet_tpu.ops.functional import upsample_linear as jupsample_linear
from bio_image_unet_tpu.predict import quant_nested as jqn
from bio_image_unet_tpu_torch import checkpoint
from bio_image_unet_tpu_torch.models import get_model
from bio_image_unet_tpu_torch.ops import int8 as k
from bio_image_unet_tpu_torch.predict import quant, quant_nested
from torch_parity import port_folded, write_seeded_checkpoint

HEADS = {"mask": {"channels": 1, "activation": "sigmoid"},
         "orientation": {"channels": 2, "activation": None}}
# (registry, seed, deep supervision)
MODELS = {
    "L4": ("MultiOutputNestedUNet", 80, False),
    "L4_ds": ("MultiOutputNestedUNet", 81, True),
    "L3": ("MultiOutputNestedUNet_3Levels", 82, False),
    "L3_ds": ("MultiOutputNestedUNet_3Levels", 83, True),
}
TILE = 48


@pytest.mark.parametrize("levels", [3, 4])
def test_grid_order_and_sites_match_jax(levels):
    assert quant_nested._grid_order(levels) == jqn._grid_order(levels)
    assert quant_nested._sites_nested(levels) == jqn._sites_nested(levels)


# --- K11 -----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_upsample_i8():
    @jax.jit
    def ref(x):
        # quant_nested.py:249-252
        upf = jupsample_linear(x.astype(jnp.float32), 2, align_corners=True)
        return jnp.clip(jnp.round(upf), -127, 127).astype(jnp.int8)

    return ref


@pytest.mark.parametrize("h,w", list(itertools.product((1, 2, 5, 16), repeat=2)))
def test_upsample2x_i8_plain_matches_jax(jax_upsample_i8, h, w):
    rng = np.random.default_rng(10 * h + w)
    for c in (1, 3, 17):
        x = rng.integers(-127, 128, (2, h, w, c)).astype(np.int8)
        want = np.asarray(jax_upsample_i8(x))
        got = k.upsample2x_i8(torch.from_numpy(x))
        assert got.dtype == torch.int8 and got.shape == (2, 2 * h, 2 * w, c)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{h}x{w}x{c}")
        # into channels [5, 5 + C) of a wider buffer, the rest untouched
        buf = torch.full((2, 2 * h, 2 * w, c + 8), 99, dtype=torch.int8)
        assert k.upsample2x_i8(torch.from_numpy(x), out=buf, offset=5) is buf
        np.testing.assert_array_equal(buf[..., 5:5 + c].numpy(), want)
        assert (buf[..., :5] == 99).all() and (buf[..., 5 + c:] == 99).all()


def test_upsample2x_i8_refuses_what_the_kernel_does_not_take():
    x = torch.zeros((1, 4, 4, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="NHWC int8"):
        k.upsample2x_i8(x.float())
    with pytest.raises(ValueError, match="NHWC int8"):
        k.upsample2x_i8(x[0])
    with pytest.raises(ValueError, match="offset"):
        k.upsample2x_i8(x, out=torch.zeros((1, 8, 8, 10), dtype=torch.int8), offset=3)
    with pytest.raises(ValueError, match="cannot take"):
        k.upsample2x_i8(x, out=torch.zeros((1, 6, 8, 16), dtype=torch.int8))


# --- the graph: weight store, calibrator, forward --------------------------------------

@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    """Per model: the port's model and ``.pt``, JAX's model, (apply_fn,
    make_variables) and calibrator, JAX's folded weights in the port's layout,
    the test tiles and JAX's calibrated maxes with the engine's 1.1 margin."""
    root = tmp_path_factory.mktemp("quant_nested_pt")
    out = {}
    for i, (name, (registry, seed, deep)) in enumerate(MODELS.items()):
        extra = {"output_heads": HEADS, "deep_supervision": deep}
        path, variables = write_seeded_checkpoint(root, name, registry, seed, warm=True, **extra)
        state = checkpoint.load(path)
        net = get_model(registry, **state["hyperparams"])
        net.load_state_dict(state["state_dict"])
        jm = jmodels.get_model(registry, n_filter=4, **extra)
        apply_fn, make = jqn.build_int8_apply_nested(jm, variables)
        cal = jqn.build_calibrator_nested(jm, variables)
        x = _tiles(90 + i)
        out[name] = dict(path=path, net=net.eval(), jm=jm, apply=jax.jit(apply_fn), make=make,
                         x=x, maxes=np.asarray(cal(jnp.asarray(x[..., None]))) * np.float32(1.1),
                         folded=port_folded(variables))
    return out


def _tiles(seed, n=3):
    """(n, 48, 48) float32 tiles in [0, 1]: noise and a bright blob."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:TILE, :TILE]
    blob = np.exp(-((yy - 20 - seed % 7) ** 2 + (xx - 26) ** 2) / 90.0)
    return np.clip(rng.random((n, TILE, TILE)) * 0.4 + blob * 0.6, 0, 1).astype(np.float32)


def _jax_lookups(make, maxes):
    """JAX's named weight getters (``w8``, ``f32``) of ``make_variables(maxes)``,
    from the closure that holds them."""
    jvars = make(maxes)
    cells = dict(zip(make.__code__.co_freevars, (c.cell_contents for c in make.__closure__)))
    return jvars, cells["_lookups"][0](jvars)


@pytest.mark.parametrize("name", list(MODELS))
def test_weight_store_equals_build_pack(graphs, name):
    g = graphs[name]
    jvars, (w8, f32) = _jax_lookups(g["make"], g["maxes"])
    L, deep = g["net"].levels, g["net"].deep_supervision
    np.testing.assert_array_equal(np.asarray(jvars[2]), quant.act_scales(g["maxes"]))
    scales = dict(zip(quant_nested._sites_nested(L), quant.act_scales(g["maxes"])))
    store = quant_nested._quantize(g["folded"], scales, L, HEADS, deep, "cpu")
    names = list(store.conv)
    assert len(names) == (L + 1) * (L + 2) - 1  # two convs a block, but g0_0's first
    for n in names:
        codes, sw, bias = (t.numpy() for t in store.conv[n])
        ref = np.asarray(w8(n))  # (3, 3, I, O)
        got = np.transpose(codes[..., :ref.shape[2]], (1, 2, 3, 0))
        assert codes.shape[-1] % 32 == 0 and not codes[..., ref.shape[2]:].any(), n
        np.testing.assert_array_equal(got, ref, err_msg=n)
        np.testing.assert_array_equal(sw, np.asarray(f32(f"{n}.sw")), err_msg=n)
        np.testing.assert_array_equal(bias, np.asarray(f32(f"{n}.bias")), err_msg=n)
    heads = [f"output_layers.{h}" + (f"_{L}" if deep else "") for h in HEADS]
    assert sorted(store.float) == sorted(["g0_0s1"] + heads)


@pytest.mark.parametrize("name", list(MODELS))
def test_calibrator_matches_jax(graphs, name):
    g = graphs[name]
    cal_fn, make_forward = quant.int8_builders(g["net"], "cpu")
    ours = cal_fn(torch.from_numpy(g["x"][:, None]))
    assert ours.dtype == np.float32 and ours.shape == g["maxes"].shape
    np.testing.assert_allclose(ours * np.float32(1.1), g["maxes"], rtol=2e-2)
    assert isinstance(make_forward(g["maxes"]), quant_nested.Int8NestedUNet)


@pytest.mark.parametrize("name", list(MODELS))
def test_int8_forward_matches_jax(graphs, name):
    """On JAX's folded weights and maxes every head is equal bit for bit."""
    g = graphs[name]
    ref = g["apply"](g["make"](g["maxes"]), jnp.asarray(g["x"][..., None]))
    fwd = quant_nested.build_int8_apply_nested(g["net"], "cpu", g["folded"])(g["maxes"])
    with torch.inference_mode():
        ours = fwd(torch.from_numpy(g["x"][:, None]))
    assert set(ours) == set(ref) == set(HEADS)
    for head, v in ref.items():
        assert ours[head].dtype == torch.float32
        np.testing.assert_array_equal(ours[head].permute(0, 2, 3, 1).numpy(), np.asarray(v),
                                      err_msg=head)
