"""The port's multi-output data path held against the JAX package on the CPU:
the multi-head device augmentation (K4h's plain version,
``data/augment_device.augment_heads_apply_plain``) against
``augment_jax.augment_batch_heads`` on JAX's own draws, the host transforms of
the multi-output pipeline on the same ``np.random`` streams, and
``DataProcessMultiOutput`` on the same TIFFs and seed.

Tolerances: the augmented image within one float32 ulp (the K4 contract);
targets equal, zeros compared by value (the orientation rotation multiplies by
0 and ±1, so only the sign of a zero can differ); host transforms and
pipeline items equal.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bio_image_unet_tpu.data import augment as jaug
from bio_image_unet_tpu.data import tiff as jtiff
from bio_image_unet_tpu.data.augment_jax import (_orientation_components, _spatial_tx,
                                                 augment_batch_heads as jax_batch_heads)
from bio_image_unet_tpu.data.pipelines import DataProcessMultiOutput as JDataProcessMultiOutput
from bio_image_unet_tpu_torch.data import augment as aug
from bio_image_unet_tpu_torch.data.augment_device import (COS, PLAIN, SIN, AugmentDraws,
                                                          HeadLayout, augment_batch_heads,
                                                          augment_heads_apply,
                                                          augment_heads_apply_plain, draw,
                                                          orientation_keys)
from bio_image_unet_tpu_torch.data.pipelines import DataProcessMultiOutput

HEAD_CHANNELS = {"mask": 1, "orientation": 2, "distance": 1}


def _nchw(a):
    return torch.from_numpy(np.array(np.moveaxis(np.asarray(a), -1, 1)))


def _nhwc(t):
    return np.moveaxis(t.numpy(), 1, -1)


def _ulps(a, b):
    return int(np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64)).max())


def _heads(rng, b, s):
    """NHWC head targets: a binary mask, a unit (cos, sin) field and a
    distance map."""
    theta = rng.uniform(0, 2 * np.pi, (b, s, s))
    return {"mask": (rng.random((b, s, s, 1)) > 0.5).astype(np.float32),
            "orientation": np.stack([np.cos(theta), np.sin(theta)], -1).astype(np.float32),
            "distance": rng.random((b, s, s, 1)).astype(np.float32)}


def _jax_draws(key, b, shape, noise_mult=(0.5, 1.2), gauss_sigma=None, p_pipeline=0.8,
               brightness_contrast=(0.25, 0.25)):
    """The draws of ``augment_batch_heads(key, ...)``, made with its keys in
    its order (a split into 5, ``augment_jax.py:203``; the noise stages draw
    their apply gates from their own keys, ``:86-113``), as ``AugmentDraws``."""
    k_gate, k_spatial, k_bc, k_mult, k_gauss = jax.random.split(key, 5)
    gate = jax.random.bernoulli(k_gate, p_pipeline, (b,))
    k_rot, k_h, k_v = jax.random.split(k_spatial, 3)
    ks = jax.random.randint(k_rot, (b,), 0, 4)
    fh = jax.random.bernoulli(k_h, 0.5, (b,))
    fv = jax.random.bernoulli(k_v, 0.5, (b,))
    k_apply, k_a, k_b = jax.random.split(k_bc, 3)
    bright, contrast = brightness_contrast
    bc_apply = jax.random.bernoulli(k_apply, 0.5, (b,))
    alpha = 1.0 + jax.random.uniform(k_a, (b,), minval=-contrast, maxval=contrast)
    beta = jax.random.uniform(k_b, (b,), minval=-bright, maxval=bright)
    km_apply, k_m = jax.random.split(k_mult)
    kg_apply, k_n = jax.random.split(k_gauss)
    mult_apply = jax.random.bernoulli(km_apply, 0.3, (b, 1, 1, 1)).reshape(b)
    gauss_apply = jax.random.bernoulli(kg_apply, 0.3, (b, 1, 1, 1)).reshape(b)

    def t(a):
        return torch.from_numpy(np.asarray(a).copy()).to(torch.int32)

    flags = torch.stack([t(gate), t(ks), t(fh), t(fv), t(bc_apply), t(mult_apply),
                         t(gauss_apply)], 1)
    coef = torch.from_numpy(np.stack([np.asarray(alpha), np.asarray(beta)], 1).astype(np.float32))
    d = AugmentDraws(flags=flags, coef=coef, sigma=0.0 if gauss_sigma is None else gauss_sigma)
    if noise_mult is not None:
        d.mult = _nchw(jax.random.uniform(k_m, shape, minval=noise_mult[0],
                                          maxval=noise_mult[1]))
    if gauss_sigma is not None:
        d.gauss = _nchw(jax.random.normal(k_n, shape))
    return d


def _layout(names=HEAD_CHANNELS, orient=("orientation",)):
    return HeadLayout.of({k: HEAD_CHANNELS[k] for k in names}, orient)


@pytest.mark.parametrize("k,fh,fv", list(itertools.product(range(4), (False, True),
                                                           (False, True))))
def test_spatial_and_orientation_cases_match_jax(rng, k, fh, fv):
    """All 16 (k, flip_h, flip_v) cases with the gate on and the intensity
    stage off: every head moves as ``_spatial_tx`` moves it, and the
    orientation head is re-expressed as ``_orientation_components`` does."""
    heads = _heads(rng, 1, 8)
    image = rng.random((1, 8, 8, 1)).astype(np.float32)
    layout = _layout()
    one, zero = torch.ones(1, dtype=torch.int32), torch.zeros(1, dtype=torch.int32)
    d = AugmentDraws(flags=torch.stack([one, torch.tensor([k], dtype=torch.int32),
                                        one if fh else zero, one if fv else zero,
                                        zero, zero, zero], 1),
                     coef=torch.tensor([[1.0, 0.0]]))
    target = layout.concat({n: _nchw(v) for n, v in heads.items()})
    out_img, out_tgt = augment_heads_apply_plain(_nchw(image), target, layout.codes, d)
    ours = layout.split(out_tgt)
    np.testing.assert_array_equal(
        _nhwc(out_img)[0], np.asarray(_spatial_tx(jnp.asarray(image[0]), k, fh, fv, (0, 1))))
    for name, v in heads.items():
        ref = _spatial_tx(jnp.asarray(v[0]), k, fh, fv, (0, 1))
        if name == "orientation":
            ref = _orientation_components(ref, k, fh, fv)
        np.testing.assert_array_equal(_nhwc(ours[name])[0], np.asarray(ref), err_msg=name)


@pytest.mark.parametrize("gauss_sigma", [None, 0.04], ids=["mult", "mult+gauss"])
def test_augment_batch_heads_matches_jax(rng, gauss_sigma):
    """Full ``augment_batch_heads(key, ...)`` draws for several keys, an
    orientation head between two other heads: the plain K4h on JAX's draws
    gives JAX's batch (image within one ulp, targets equal)."""
    b, s = 16, 12
    image = rng.random((b, s, s, 1)).astype(np.float32)
    heads = _heads(rng, b, s)
    layout = _layout()
    target = layout.concat({n: _nchw(v) for n, v in heads.items()})
    cases = set()
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        ref_img, ref_tgt = jax_batch_heads(
            key, jnp.asarray(image), {n: jnp.asarray(v) for n, v in heads.items()},
            orientation_keys=("orientation",), gauss_sigma=gauss_sigma)
        d = _jax_draws(key, b, image.shape, gauss_sigma=gauss_sigma)
        out_img, out_tgt = augment_heads_apply_plain(_nchw(image), target, layout.codes, d)
        assert _ulps(_nhwc(out_img), np.asarray(ref_img)) <= 1
        for name, v in layout.split(out_tgt).items():
            np.testing.assert_array_equal(_nhwc(v), np.asarray(ref_tgt[name]), err_msg=name)
        on = d.flag("gate").bool()
        cases |= {tuple(r) for r in d.flags[on][:, 1:4].tolist()}
        assert 0 < int(on.sum()) < b
    assert len(cases) >= 12  # most (k, flip_h, flip_v) cases drawn with the gate on


def test_augment_heads_apply_gathers_index_on_cpu(rng):
    """``index`` gathers rows of a resident set; on CPU tensors the wrapper is
    the plain version and launches nothing; ``augment_batch_heads`` takes a
    head dict or the concatenated set with its layout."""
    n, b, s = 10, 4, 16
    image = _nchw(rng.random((n, s, s, 1)).astype(np.float32))
    heads = {k: _nchw(v) for k, v in _heads(rng, n, s).items()}
    layout = _layout()
    target = layout.concat(heads)
    index = torch.tensor([7, 2, 2, 9], dtype=torch.int64)
    d = draw(torch.Generator().manual_seed(0), b, (b, 1, s, s), gauss_sigma=0.05)
    before = augment_heads_apply.launches
    out = augment_heads_apply(image, target, layout.codes, d, index=index)
    assert augment_heads_apply.launches == before
    ref = augment_heads_apply_plain(image[index], target[index], layout.codes, d)
    assert all(torch.equal(a, r) for a, r in zip(out, ref))
    assert out[1].shape == (b, 4, s, s) and float(out[0].min()) >= 0.0
    # the gated-off samples pass through untouched
    off = ~d.flag("gate").bool()
    assert torch.equal(out[1][off], target[index][off])
    # the convenience form from a head dict equals the resident form
    a_img, a_heads = augment_batch_heads(torch.Generator().manual_seed(3), image, heads,
                                         orientation_keys(heads), index=index)
    b_img, b_heads = augment_batch_heads(torch.Generator().manual_seed(3), image, target,
                                         index=index, layout=layout)
    assert torch.equal(a_img, b_img)
    assert all(torch.equal(a_heads[k], b_heads[k]) for k in heads)
    assert a_heads["orientation"].shape == (b, 2, s, s)
    # the rotation keeps unit vectors unit
    norm = a_heads["orientation"].pow(2).sum(1)
    assert torch.allclose(norm, torch.ones_like(norm), atol=1e-5)


def test_head_layout_codes_and_refusals():
    layout = _layout()
    assert layout.codes.tolist() == [PLAIN, COS, SIN, PLAIN]
    assert layout.names == ("mask", "orientation", "distance") and layout.channels == (1, 2, 1)
    assert orientation_keys(["mask", "orientation", "orientation_2", "x"]) == (
        "orientation", "orientation_2")
    with pytest.raises(ValueError, match="want 2"):
        HeadLayout.of({"orientation": 3}, ("orientation",))
    x = torch.zeros((2, 1, 8, 8))
    d = draw(torch.Generator(), 2, (2, 1, 8, 8))
    with pytest.raises(ValueError, match="codes"):
        augment_heads_apply_plain(x, torch.zeros((2, 2, 8, 8)), torch.tensor([SIN, COS]), d)
    with pytest.raises(ValueError, match="codes"):
        augment_heads_apply_plain(x, torch.zeros((2, 2, 8, 8)), torch.tensor([PLAIN]), d)


# --- host transforms ------------------------------------------------------------

def _same_stream(make_port, make_jax, img, seed=0, mask=False):
    port_t, jax_t = make_port(), make_jax()
    outs = []
    for t in (port_t, jax_t):
        rng = np.random.default_rng(seed)
        params = t.sample(rng, img.shape)
        outs.append(t.apply_mask(img, params) if mask else t.apply(img, params))
    np.testing.assert_array_equal(outs[0], outs[1])
    return outs[0]


TRANSFORMS = {
    "RandomScale-up": (lambda m: m.RandomScale(scale_limit=(0.2, 0.4), p=1.0), (37, 29)),
    "RandomScale-down": (lambda m: m.RandomScale(scale_limit=(-0.5, -0.3), p=1.0), (37, 29, 2)),
    "PadIfNeeded": (lambda m: m.PadIfNeeded(48, 40), (37, 29, 2)),
    "RandomCrop": (lambda m: m.RandomCrop(16, 12), (37, 29)),
    "GaussNoise-std": (lambda m: m.GaussNoise(std_range=(0.01, 0.1), p=1.0), (24, 20)),
    "GaussNoise-var": (lambda m: m.GaussNoise(var_limit=(10.0, 50.0), p=1.0), (24, 20)),
    "ShotNoise": (lambda m: m.ShotNoise(scale_range=(0.001, 0.01), p=1.0), (24, 20)),
}


@pytest.mark.parametrize("name", list(TRANSFORMS))
@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_host_transforms_match_jax(rng, name, dtype):
    make, shape = TRANSFORMS[name]
    img = rng.random(shape)
    img = (img * 255).astype(np.uint8) if dtype == np.uint8 else img.astype(np.float32)
    out = _same_stream(lambda: make(aug), lambda: make(jaug), img, seed=7)
    if "Noise" in name:
        assert out.dtype == img.dtype and not np.array_equal(out, img)
        np.testing.assert_array_equal(
            _same_stream(lambda: make(aug), lambda: make(jaug), img, mask=True), img)
    with pytest.raises(ValueError, match="exactly one"):
        aug.GaussNoise()


@pytest.mark.parametrize("case", ["float-nan", "probability", "bool", "chw", "angles"])
@pytest.mark.parametrize("order", [0, 3])
def test_rotate_array_matches_jax(rng, case, order):
    if case == "float-nan":
        x = rng.standard_normal((21, 17)).astype(np.float32) * 3
        x[4:9, 2:6] = np.nan
    elif case == "probability":
        x = rng.random((21, 17)).astype(np.float32) * 0.8 + 0.1
    elif case == "bool":
        x = rng.random((16, 16)) > 0.5
    elif case == "chw":
        x = rng.random((2, 19, 23)).astype(np.float32)
    else:
        x = rng.uniform(0, 2 * np.pi, (20, 20)).astype(np.float32)
    for angle in (17.5, 213.0):
        ours = aug.rotate_array(x, angle, order=order)
        ref = jaug.rotate_array(x, angle, order=order)
        np.testing.assert_array_equal(ours, ref)
    if case == "float-nan":
        assert np.isnan(ours).any()
    if case == "chw":  # rotated in its (H, W) plane, channel by channel
        np.testing.assert_array_equal(ours[1], aug.rotate_array(x[1], 213.0, order=order))


# --- DataProcessMultiOutput -----------------------------------------------------

def _write_frames(root, n=3, shape=(40, 48)):
    """Image, mask and orientation-angle TIFFs (NaN where the angle is not
    defined) for both packages' ``DataProcessMultiOutput``."""
    rng = np.random.default_rng(11)
    dirs = {k: root / k for k in ("image", "mask", "orientation")}
    for d in dirs.values():
        d.mkdir(parents=True)
    for i in range(n):
        img = rng.integers(0, 4000, shape).astype(np.uint16)
        mask = (rng.random(shape) > 0.6).astype(np.float32)
        angle = rng.uniform(0, np.pi, shape).astype(np.float32)
        angle[mask == 0] = np.nan
        jtiff.imwrite(str(dirs["image"] / f"f{i}.tif"), img)
        jtiff.imwrite(str(dirs["mask"] / f"f{i}.tif"), mask)
        jtiff.imwrite(str(dirs["orientation"] / f"f{i}.tif"), angle)
    return str(dirs["image"]), [str(dirs["mask"]), str(dirs["orientation"])]


def test_data_process_multi_output_matches_jax(tmp_path):
    """The same TIFFs and seed through both pipelines (both rotation
    branches, the host pipeline with every transform enabled): every item
    equal after the CHW ↔ HWC transpose, the orientation as (cos θ, sin θ)
    with NaN filled."""
    image_dir, target_dirs = _write_frames(tmp_path / "src")
    kw = dict(target_types={"mask": "mask", "orientation": "mask"}, dim_out=(32, 32),
              aug_factor=2, scale_limit=(-0.2, 0.2), nan_to_val=-2.0, seed=5)
    ours = DataProcessMultiOutput(image_dir, target_dirs, data_dir=str(tmp_path / "port"), **kw)
    ref = JDataProcessMultiOutput(image_dir, target_dirs, data_dir=str(tmp_path / "jax"), **kw)
    assert len(ours) == len(ref) == 3 * 3  # max(int(40·48 / 32² · 2), 2) patches per frame
    assert ours.target_keys == ["mask", "orientation"]
    filled = 0
    for i in range(len(ours)):
        a, b = ours[i], ref[i]
        assert set(a) == set(b) == {"image", "mask", "orientation"}
        assert a["image"].shape == (1, 32, 32) and a["orientation"].shape == (2, 32, 32)
        for k in a:
            assert a[k].dtype == np.float32
            np.testing.assert_array_equal(a[k], np.moveaxis(b[k], -1, 0), err_msg=f"{i} {k}")
        assert not np.isnan(a["orientation"]).any()
        filled += int((a["orientation"] == -2.0).sum())
    assert filled > 0  # the NaN regions were filled with nan_to_val
