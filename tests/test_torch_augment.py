"""The port's on-device augmentation (``data/augment_device.py``, K4's plain
version) held against ``bio_image_unet_tpu.data.augment_jax`` on the CPU.

Threefry and Philox streams differ, so each test draws with ``jax.random``
in the exact split order of ``augment_jax.py:142-145`` and hands those draws
to the port: the spatial and intensity arithmetic is then compared value for
value (image atol 1e-6, masks equal)."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bio_image_unet_tpu.data.augment_jax import _spatial_tx, augment_batch
from bio_image_unet_tpu_torch.data.augment_device import (FLAGS, AugmentDraws,
                                                          augment_apply, augment_apply_plain,
                                                          draw)
from bio_image_unet_tpu_torch.data.augment_device import augment_batch as port_augment_batch


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.array(a), -1, 1)))


def _nhwc(t):
    return np.moveaxis(t.numpy(), 1, -1)


def _draws(*, alpha, beta, **named):
    """``AugmentDraws`` from one (B,) tensor per name of ``FLAGS`` plus
    ``alpha`` and ``beta``; the other keyword arguments are its fields."""
    fields = {k: named.pop(k) for k in list(named) if k not in FLAGS}
    flags = torch.stack([named[n].to(torch.int32) for n in FLAGS], 1)
    coef = torch.stack([alpha.to(torch.float32), beta.to(torch.float32)], 1)
    return AugmentDraws(flags=flags, coef=coef, **fields)


def _jax_draws(key, b, shape, prev, brightness_contrast=(0.25, 0.25),
               noise_mult=(0.5, 1.2), gauss_sigma=None, p_pipeline=0.8):
    """The draws of ``augment_jax.augment_batch(key, ...)``, made with the
    same keys in the same order, as the port's ``AugmentDraws``."""
    (k_gate, k_spatial, k_bc, k_mult, k_gauss,
     k_mult2, k_gauss2, k_am, k_ag) = jax.random.split(key, 9)
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
    mult_apply = jax.random.bernoulli(k_am, 0.3, (b,))
    gauss_apply = jax.random.bernoulli(k_ag, 0.3, (b,))

    def t(a):
        return torch.from_numpy(np.asarray(a).copy())

    d = _draws(gate=t(gate), k=t(ks), flip_h=t(fh), flip_v=t(fv), bc_apply=t(bc_apply),
               alpha=t(alpha), beta=t(beta), mult_apply=t(mult_apply),
               gauss_apply=t(gauss_apply),
               sigma=0.0 if gauss_sigma is None else float(gauss_sigma))
    if noise_mult is not None:
        d.mult = _nchw(jax.random.uniform(jax.random.split(k_mult)[1], shape,
                                          minval=noise_mult[0], maxval=noise_mult[1]))
        if prev:
            d.mult_prev = _nchw(jax.random.uniform(jax.random.split(k_mult2)[1], shape,
                                                   minval=noise_mult[0], maxval=noise_mult[1]))
    if gauss_sigma is not None:
        d.gauss = _nchw(jax.random.normal(jax.random.split(k_gauss)[1], shape))
        if prev:
            d.gauss_prev = _nchw(jax.random.normal(jax.random.split(k_gauss2)[1], shape))
    return d


def _batch(rng, b=4, s=16, c=1):
    image = rng.random((b, s, s, c), np.float32)
    mask = (rng.random((b, s, s, c)) > 0.5).astype(np.float32)
    prev = rng.random((b, s, s, c), np.float32)
    return image, mask, prev


@pytest.mark.parametrize("k,fh,fv", list(itertools.product(range(4), (False, True),
                                                           (False, True))))
def test_spatial_cases_match_spatial_tx(rng, k, fh, fv):
    """All 16 (k, flip_h, flip_v) cases on a 2-channel tile: the gate on, the
    intensity stage off, so only the spatial map is compared."""
    image, mask, _ = _batch(rng, b=1, s=8, c=2)
    ref_img = np.asarray(_spatial_tx(jnp.asarray(image[0]), k, fh, fv, (0, 1)))
    ref_mask = np.asarray(_spatial_tx(jnp.asarray(mask[0]), k, fh, fv, (0, 1)))
    one = torch.ones(1, dtype=torch.bool)
    zero = torch.zeros(1, dtype=torch.bool)
    d = _draws(gate=one, k=torch.tensor([k]), flip_h=one if fh else zero,
               flip_v=one if fv else zero, bc_apply=zero, alpha=torch.ones(1),
               beta=torch.zeros(1), mult_apply=zero, gauss_apply=zero)
    out_img, out_mask = augment_apply_plain(_nchw(image), _nchw(mask), d)
    np.testing.assert_array_equal(_nhwc(out_img)[0], ref_img)
    np.testing.assert_array_equal(_nhwc(out_mask)[0], ref_mask)


@pytest.mark.parametrize("pair", [False, True], ids=["image-mask", "pair"])
@pytest.mark.parametrize("gauss_sigma", [None, 0.04], ids=["mult", "mult+gauss"])
def test_augment_batch_matches_jax(rng, pair, gauss_sigma):
    """A full ``augment_batch(key, ...)`` in both forms, for several keys:
    the port's plain K4 on JAX's draws gives JAX's batch."""
    image, mask, prev = _batch(rng, b=8, s=16, c=1)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        args = (jnp.asarray(image), jnp.asarray(mask)) + ((jnp.asarray(prev),) if pair else ())
        ref = augment_batch(key, *args, gauss_sigma=gauss_sigma)
        d = _jax_draws(key, 8, image.shape, pair, gauss_sigma=gauss_sigma)
        ours = augment_apply_plain(_nchw(image), _nchw(mask), d,
                                   prev=_nchw(prev) if pair else None)
        assert len(ours) == len(ref)
        np.testing.assert_allclose(_nhwc(ours[0]), np.asarray(ref[0]), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(_nhwc(ours[1]), np.asarray(ref[1]))
        if pair:
            np.testing.assert_allclose(_nhwc(ours[2]), np.asarray(ref[2]), rtol=0, atol=1e-6)
        # the draws did something: some samples changed, some did not
        changed = (ours[0] != _nchw(image)).flatten(1).any(1)
        assert 0 < int(changed.sum()) <= 8


def test_augment_apply_gathers_index_on_cpu(rng):
    """``index`` gathers rows of a resident tile set; on CPU tensors the
    wrapper is the plain version and launches nothing."""
    image, mask, _ = _batch(rng, b=10, s=16, c=1)
    img_t, mask_t = _nchw(image), _nchw(mask)
    index = torch.tensor([7, 2, 2, 9], dtype=torch.int64)
    d = draw(torch.Generator().manual_seed(0), 4, (4, 1, 16, 16), gauss_sigma=0.05)
    before = augment_apply.launches
    out = augment_apply(img_t, mask_t, d, index=index)
    assert augment_apply.launches == before
    ref = augment_apply_plain(img_t[index], mask_t[index], d)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert out[0].shape == (4, 1, 16, 16) and out[1].dtype == torch.float32
    assert float(out[0].min()) >= 0.0 and float(out[0].max()) <= 1.0


def test_draw_distributions():
    """The torch draws follow the JAX function's probabilities and ranges."""
    d = draw(torch.Generator().manual_seed(1), 4000, (4000, 1, 4, 4), prev=True,
             gauss_sigma=0.04)
    assert d.flags.dtype == torch.int32 and d.flags.shape == (4000, 7)
    assert abs(d.flag("gate").float().mean().item() - 0.8) < 0.03
    assert set(d.flag("k").unique().tolist()) == {0, 1, 2, 3}
    for name in ("flip_h", "flip_v", "bc_apply"):
        assert abs(d.flag(name).float().mean().item() - 0.5) < 0.03
    for name in ("mult_apply", "gauss_apply"):
        assert abs(d.flag(name).float().mean().item() - 0.3) < 0.03
    alpha, beta = d.coef[:, 0], d.coef[:, 1]
    assert 0.75 <= alpha.min().item() and alpha.max().item() <= 1.25
    assert -0.25 <= beta.min().item() and beta.max().item() <= 0.25
    assert alpha.std().item() > 0.1 and beta.std().item() > 0.1
    assert 0.5 <= d.mult.min().item() and d.mult.max().item() < 1.2
    assert d.mult_prev is not None and not torch.equal(d.mult, d.mult_prev)
    assert d.gauss.shape == (4000, 1, 4, 4) and d.sigma == pytest.approx(0.04)


def test_augment_rejects_3d_and_bad_shapes(rng):
    """Volumes take the 3D form (K4v) now; a volume whose (X, Y) plane is not
    square, ranks that differ, and a non-square tile are refused."""
    vol = torch.zeros((2, 1, 4, 8, 8))
    assert port_augment_batch(torch.Generator(), vol, vol)[0].shape == vol.shape
    with pytest.raises(ValueError, match="square"):
        port_augment_batch(torch.Generator(), vol[..., :6], vol[..., :6])
    with pytest.raises(ValueError, match="one rank"):
        augment_apply_plain(vol, vol[:, :, 0], draw(torch.Generator(), 2, (2, 1, 4, 8, 8)))
    with pytest.raises(ValueError, match="square"):
        augment_apply_plain(torch.zeros((2, 1, 8, 6)), torch.zeros((2, 1, 8, 6)),
                            draw(torch.Generator(), 2, (2, 1, 8, 6)))
