"""Host-side image augmentation of the offline pipelines (the port's copy
of the transforms of ``bio_image_unet_tpu/data/augment.py`` that
``DataProcess2D``, ``DataProcessMultiOutput``, ``DataProcess3D`` and
``DataProcessMultiOutput3D`` compose in their ``_augment``:
``Transform``/``Compose`` :53-106, ``RandomRotate90`` :108,
``ShiftScaleRotate`` :128, ``RandomScale`` :183, ``PadIfNeeded`` :209,
``RandomCrop`` :228, ``RandomCrop3D`` :247, ``ShiftScaleRotate3D`` :265,
``RandomBrightnessContrast`` :293, ``Blur`` :316,
``MultiplicativeNoise`` :351, ``GaussNoise`` :376, ``ShotNoise`` :408, the
NaN-aware ``rotate_array`` :434 and ``rotate_array_90`` :473).

numpy/scipy only.  Every transform draws from the ``np.random.Generator`` in
the same order and with the same calls as the JAX package's, so one seed gives
bit-equal tiles in both packages.  The other transforms of the JAX module
come with the pipelines that use them.

One divergence: the JAX ``ShiftScaleRotate`` warps with OpenCV, which the port
does not depend on.  Here the same affine map (OpenCV's
``getRotationMatrix2D`` about the pixel-centre, plus the shift) goes through
``scipy.ndimage.affine_transform`` with the reflect-101 border (``mirror``),
linear for images and nearest for masks.  The identity transform (the
pipeline's default limits ``(0, 0, 0)``) is an exact copy in both; other
parameters can differ from OpenCV's fixed-point interpolation by a level.
``ShiftScaleRotate3D`` warps each z slice of a volume with it, on one draw.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
from scipy import ndimage


def _max_value(img: np.ndarray) -> float:
    return 255.0 if img.dtype == np.uint8 else 1.0


def _clip_like(img: np.ndarray, out: np.ndarray) -> np.ndarray:
    if img.dtype == np.uint8:
        return np.clip(out, 0, 255).astype(np.uint8)
    return np.clip(out, 0.0, 1.0).astype(img.dtype, copy=False)


class Transform:
    """Base transform: ``sample`` draws shared params once per call,
    ``apply``/``apply_mask`` use them on each target."""

    def __init__(self, p: float = 0.5):
        self.p = p

    def sample(self, rng: np.random.Generator, shape) -> dict:
        return {}

    def apply(self, img: np.ndarray, params: dict) -> np.ndarray:
        return img

    def apply_mask(self, mask: np.ndarray, params: dict) -> np.ndarray:
        return self.apply(mask, params)


class Compose:
    """Apply transforms in order; the whole pipeline fires with prob ``p``.
    Spatial params are shared across all targets.  ``targets`` maps extra
    target names to 'image' (intensity ops too) or 'mask' (spatial only)."""

    def __init__(self, transforms: Sequence[Transform], p: float = 1.0,
                 targets: Optional[Dict[str, str]] = None):
        self.transforms = list(transforms)
        self.p = p
        self.targets = dict(targets or {})

    def __call__(self, rng: Optional[np.random.Generator] = None, **data):
        rng = rng or np.random.default_rng()
        if rng.random() >= self.p:
            return dict(data)
        out = dict(data)
        for t in self.transforms:
            if rng.random() >= t.p:
                continue
            ref_shape = out["image"].shape if "image" in out else next(iter(out.values())).shape
            params = t.sample(rng, ref_shape)
            for name, arr in out.items():
                kind = "image" if name == "image" else self.targets.get(name, "mask")
                out[name] = t.apply(arr, params) if kind == "image" else t.apply_mask(arr, params)
        return out


# --- spatial -------------------------------------------------------------------


class RandomRotate90(Transform):
    """k ∈ {0, 1, 2, 3} quarter-turns."""

    def sample(self, rng, shape):
        return {"k": int(rng.integers(0, 4))}

    def apply(self, img, params):
        return np.ascontiguousarray(np.rot90(img, params["k"]))


class ShiftScaleRotate(Transform):
    """Affine with shift ∈ ±shift_limit·(W, H), scale ∈ 1 ± scale_limit,
    angle ∈ ±rotate_limit (degrees); reflect-101 border, linear interpolation
    for images, nearest for masks (see the module docstring for the
    difference from OpenCV)."""

    def __init__(self, shift_limit=0.0625, scale_limit=0.1, rotate_limit=45, p=0.5):
        super().__init__(p)
        self.shift_limit = self._pair(shift_limit)
        self.scale_limit = self._pair(scale_limit)
        self.rotate_limit = self._pair(rotate_limit)

    @staticmethod
    def _pair(v):
        return tuple(v) if isinstance(v, (tuple, list)) else (-v, v)

    def sample(self, rng, shape):
        return {
            "dx": rng.uniform(*self.shift_limit),
            "dy": rng.uniform(*self.shift_limit),
            "scale": 1.0 + rng.uniform(*self.scale_limit),
            "angle": rng.uniform(*self.rotate_limit),
        }

    @staticmethod
    def _matrix(params, h: int, w: int) -> np.ndarray:
        """OpenCV's ``getRotationMatrix2D((w/2 − 0.5, h/2 − 0.5), angle,
        scale)`` plus the shift: the 2×3 map from source (x, y) to
        destination (x, y)."""
        a = math.radians(params["angle"])
        alpha, beta = params["scale"] * math.cos(a), params["scale"] * math.sin(a)
        cx, cy = w / 2 - 0.5, h / 2 - 0.5
        return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy + params["dx"] * w],
                         [-beta, alpha, beta * cx + (1 - alpha) * cy + params["dy"] * h]])

    def _warp(self, img, params, nearest: bool):
        h, w = img.shape[:2]
        m = self._matrix(params, h, w)
        if np.array_equal(m, [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]):
            return img.copy()
        inv = np.linalg.inv(np.vstack([m, [0.0, 0.0, 1.0]]))
        # (x, y) → (row, col) order for scipy: out[r, c] = in[M·(r, c) + o]
        mat = np.array([[inv[1, 1], inv[1, 0]], [inv[0, 1], inv[0, 0]]])
        off = np.array([inv[1, 2], inv[0, 2]])
        order = 0 if nearest else 1
        planes = img[..., None] if img.ndim == 2 else img
        out = np.stack([ndimage.affine_transform(planes[..., c], mat, off, order=order,
                                                 mode="mirror", output=img.dtype)
                        for c in range(planes.shape[-1])], axis=-1)
        return out[..., 0] if img.ndim == 2 else out

    def apply(self, img, params):
        return self._warp(img, params, nearest=False)

    def apply_mask(self, mask, params):
        return self._warp(mask, params, nearest=True)


class RandomScale(Transform):
    """Resize by 1 + U(lo, hi), nearest neighbour for every target
    (multi_output_unet/data.py:190-192)."""

    def __init__(self, scale_limit=(0.0, 0.0), p=0.5):
        super().__init__(p)
        self.scale_limit = (tuple(scale_limit) if isinstance(scale_limit, (tuple, list))
                            else (-scale_limit, scale_limit))

    def sample(self, rng, shape):
        return {"factor": 1.0 + rng.uniform(*self.scale_limit)}

    def apply(self, img, params):
        f = params["factor"]
        if f == 1.0:
            return img
        h, w = img.shape[:2]
        nh, nw = max(int(round(h * f)), 1), max(int(round(w * f)), 1)
        yi = np.minimum((np.arange(nh) / f).astype(np.int64), h - 1)
        xi = np.minimum((np.arange(nw) / f).astype(np.int64), w - 1)
        return np.ascontiguousarray(img[yi][:, xi])


class PadIfNeeded(Transform):
    """Wrap padding to at least (min_height, min_width) with the content at
    the bottom left: the padding fills the top and the right
    (multi_output_unet/data.py:194-195)."""

    def __init__(self, min_height: int, min_width: int, p: float = 1.0):
        super().__init__(p)
        self.min_height, self.min_width = min_height, min_width

    def apply(self, img, params):
        h, w = img.shape[:2]
        pad_h = max(0, self.min_height - h)
        pad_w = max(0, self.min_width - w)
        if pad_h == 0 and pad_w == 0:
            return img
        widths = [(pad_h, 0), (0, pad_w)] + [(0, 0)] * (img.ndim - 2)
        return np.pad(img, widths, mode="wrap")


class RandomCrop(Transform):
    """A (height, width) crop at a uniform offset."""

    def __init__(self, height: int, width: int, p: float = 1.0):
        super().__init__(p)
        self.height, self.width = height, width

    def sample(self, rng, shape):
        h, w = shape[:2]
        return {"y": int(rng.integers(0, max(h - self.height, 0) + 1)),
                "x": int(rng.integers(0, max(w - self.width, 0) + 1))}

    def apply(self, img, params):
        y, x = params["y"], params["x"]
        return np.ascontiguousarray(img[y:y + self.height, x:x + self.width])


class RandomCrop3D(Transform):
    """A (Z, X, Y) crop of a volume at a uniform offset per axis."""

    def __init__(self, size: Sequence[int], p: float = 1.0):
        super().__init__(p)
        self.size = tuple(size)

    def sample(self, rng, shape):
        return {"starts": [int(rng.integers(0, max(shape[i] - self.size[i], 0) + 1))
                           for i in range(3)]}

    def apply(self, img, params):
        z, x, y = params["starts"]
        dz, dx, dy = self.size
        return np.ascontiguousarray(img[z:z + dz, x:x + dx, y:y + dy])


class ShiftScaleRotate3D(Transform):
    """The affine of :class:`ShiftScaleRotate` (one draw) on every z slice of
    a (Z, X, Y) volume: a rotation about the Z axis, with scale and shift in
    the (X, Y) plane."""

    def __init__(self, shift_limit=0.0, scale_limit=(-0.75, 0.0),
                 rotate_limit=(0.0, 360.0), p=0.8):
        super().__init__(p)
        self._ssr = ShiftScaleRotate(shift_limit, scale_limit, rotate_limit, p=1.0)

    def sample(self, rng, shape):
        return self._ssr.sample(rng, shape[1:])

    def apply(self, vol, params):
        return np.stack([self._ssr.apply(sl, params) for sl in vol])

    def apply_mask(self, vol, params):
        return np.stack([self._ssr.apply_mask(sl, params) for sl in vol])


# --- intensity (image only) ----------------------------------------------------


class RandomBrightnessContrast(Transform):
    """out = img·(1 + c) + b·max_value."""

    def __init__(self, brightness_limit=0.2, contrast_limit=0.2, p=0.5):
        super().__init__(p)
        self.brightness_limit = brightness_limit
        self.contrast_limit = contrast_limit

    def sample(self, rng, shape):
        return {
            "alpha": 1.0 + rng.uniform(-self.contrast_limit, self.contrast_limit),
            "beta": rng.uniform(-self.brightness_limit, self.brightness_limit),
        }

    def apply(self, img, params):
        out = img.astype(np.float32) * params["alpha"] + params["beta"] * _max_value(img)
        return _clip_like(img, out)

    def apply_mask(self, mask, params):
        return mask


class Blur(Transform):
    """Box blur with a random odd kernel size in ``blur_limit``: over the
    first two axes of an (H, W[, C]) image, or with ``volumetric`` in-plane
    over the last two axes of a channel-less (Z, X, Y) volume, each z slice
    on its own (a (1, k, k) filter)."""

    def __init__(self, blur_limit=(3, 7), p=0.5, volumetric: bool = False):
        super().__init__(p)
        self.blur_limit = (
            tuple(blur_limit) if isinstance(blur_limit, (tuple, list)) else (3, blur_limit))
        self.volumetric = volumetric

    def sample(self, rng, shape):
        lo, hi = self.blur_limit
        return {"ksize": int(rng.integers(lo // 2, hi // 2 + 1)) * 2 + 1}

    def apply(self, img, params):
        k = params["ksize"]
        if self.volumetric:
            size = (1,) * (img.ndim - 2) + (k, k)
        else:
            size = (k, k) + (1,) * (img.ndim - 2)
        out = ndimage.uniform_filter(img.astype(np.float32), size=size, mode="nearest")
        return _clip_like(img, out)

    def apply_mask(self, mask, params):
        return mask


class MultiplicativeNoise(Transform):
    """Per-pixel (``elementwise``) or per-image uniform multiplier."""

    def __init__(self, multiplier=(0.9, 1.1), elementwise=True, p=0.5):
        super().__init__(p)
        self.multiplier = tuple(multiplier)
        self.elementwise = elementwise

    def sample(self, rng, shape):
        return {"rng": rng}

    def apply(self, img, params):
        rng = params["rng"]
        m = (rng.uniform(*self.multiplier, size=img.shape) if self.elementwise
             else rng.uniform(*self.multiplier))
        return _clip_like(img, img.astype(np.float32) * m)

    def apply_mask(self, mask, params):
        return mask


class GaussNoise(Transform):
    """Additive Gaussian noise: ``var_limit``, the absolute-variance API
    (siam_unet/data.py:239), or ``std_range``, a fraction of the maximum
    value (multi_output_unet/data.py:198)."""

    def __init__(self, var_limit=None, std_range=None, p=0.5):
        super().__init__(p)
        if (var_limit is None) == (std_range is None):
            raise ValueError("pass exactly one of var_limit / std_range")
        self.var_limit = var_limit
        self.std_range = std_range

    def sample(self, rng, shape):
        if self.var_limit is not None:
            lo, hi = (self.var_limit if isinstance(self.var_limit, (tuple, list))
                      else (0, self.var_limit))
            return {"sigma": float(np.sqrt(rng.uniform(lo, hi))), "relative": False,
                    "rng": rng}
        return {"sigma": float(rng.uniform(*self.std_range)), "relative": True, "rng": rng}

    def apply(self, img, params):
        sigma = params["sigma"] * (_max_value(img) if params["relative"] else 1.0)
        noise = params["rng"].normal(0.0, sigma, size=img.shape)
        return _clip_like(img, img.astype(np.float32) + noise)

    def apply_mask(self, mask, params):
        return mask


class ShotNoise(Transform):
    """Poisson (photon-count) noise, ``Poisson(img / scale) · scale`` on the
    [0, max] intensity scale (multi_output_unet/data.py:197)."""

    def __init__(self, scale_range=(0.1, 0.3), p=0.5):
        super().__init__(p)
        self.scale_range = tuple(scale_range)

    def sample(self, rng, shape):
        return {"scale": float(rng.uniform(*self.scale_range)), "rng": rng}

    def apply(self, img, params):
        scale = params["scale"] * _max_value(img)
        lam = np.maximum(img.astype(np.float32), 0.0) / scale
        return _clip_like(img, params["rng"].poisson(lam).astype(np.float32) * scale)

    def apply_mask(self, mask, params):
        return mask


def rotate_array(x: np.ndarray, angle: float, order: int = 1) -> np.ndarray:
    """Rotation by ``angle`` degrees with the grid-wrap border, keeping NaN
    regions NaN and probability maps in their [min, max] range
    (multi_output_unet/data.py:213-242, ``scipy.ndimage.rotate``).  A
    channels-first (C, H, W) array rotates in its (H, W) plane, the JAX
    package's documented divergence from the reference, whose default axes
    rotate the (C, H) plane (``augment.py:439-444``)."""
    if x.dtype == bool:
        x = x.astype(np.float32)
        xmin, xmax, needs_clip = 0.0, 1.0, True
    elif np.nanmin(x) >= 0 and np.nanmax(x) <= 1:
        xmin, xmax, needs_clip = float(np.nanmin(x)), float(np.nanmax(x)), True
    else:
        xmin = xmax = None
        needs_clip = False
    axes = (1, 2) if x.ndim == 3 and x.shape[0] < x.shape[1] else (0, 1)
    if np.any(np.isnan(x)):
        nan_mask = np.isnan(x)
        rotated = ndimage.rotate(np.where(nan_mask, 0, x), angle, axes=axes[::-1],
                                 reshape=False, mode="grid-wrap", order=order).astype(np.float32)
        rotated_mask = ndimage.rotate(nan_mask.astype(np.uint8), angle, axes=axes[::-1],
                                      reshape=False, mode="grid-wrap", order=order) > 0.5
        rotated[rotated_mask] = np.nan
    else:
        rotated = ndimage.rotate(x, angle, axes=axes[::-1], reshape=False, mode="grid-wrap",
                                 order=order).astype(np.float32)
    if needs_clip:
        rotated = np.clip(rotated, xmin, xmax)
    return rotated


def rotate_array_90(x: np.ndarray, factor: int) -> np.ndarray:
    """rot90 that handles CHW layout (``augment.py:473``)."""
    if x.ndim == 3 and x.shape[0] < x.shape[1]:
        return np.ascontiguousarray(np.rot90(x, factor, axes=(1, 2)))
    return np.ascontiguousarray(np.rot90(x, factor))
