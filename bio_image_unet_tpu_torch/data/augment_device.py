"""On-device batched augmentation of the training hot path (counterpart of
``bio_image_unet_tpu/data/augment_jax.py:132 augment_batch``), with K4.

The JAX function draws its randomness from a threefry key inside the jitted
step; threefry and Philox streams differ, so here the work is split in two:

1. :func:`draw` makes every random draw with a ``torch.Generator`` on the
   tensors' device, as small tensors and per-pixel fields
   (:class:`AugmentDraws`);
2. :func:`augment_apply` does everything else in one launch of K4
   (``csrc/augment_batch.cu``): gather the tiles ``index`` of the resident
   tile set, rot90 by k then flip_h then flip_v (``augment_jax.py:41-47``),
   brightness/contrast, multiplicative noise and Gaussian noise on the image
   (``:71-129``), and the untransformed tile where the p=0.8 gate is off
   (``:155-156``).

Because the draws are explicit, :func:`augment_apply_plain` (the plain
PyTorch version) is held against JAX on the CPU with JAX's own draws, and K4
against the plain version on the card.  On a CPU tensor ``augment_apply``
takes the plain version; on a CUDA tensor it launches K4 or raises.

Layout is NCHW: image (N, C, S, S), mask (N, C', S, S) float32 with square
tiles (as ``jnp.rot90`` under ``lax.switch`` requires).  The pair form
(``prev``, ``augment_jax.py:159-170``) shares the spatial draw, the
brightness/contrast draw and the noise apply flags, and draws its own noise
fields.

The multi-head form (``augment_jax.py:192 augment_batch_heads``) has the same
split: :func:`draw`, then :func:`augment_heads_apply`, one launch of K4h
(``csrc/augment_batch.cu``), on the head targets concatenated along channels
(:class:`HeadLayout`).  Every target channel moves with the image; the
(cos, sin) channels of each orientation head (every head whose name contains
``"orientation"``, ``trainer.py:491-493``) are also rotated into the output
frame (``augment_jax.py:178``).  Its plain version is
:func:`augment_heads_apply_plain`.

The 3D forms take 5-D volume sets, (N, C, Z, S, S) (JAX: (B, Z, X, Y, C)):
rot90 and the flips move the (X, Y) plane alike for every z
(``augment_jax.py:147``, ``:207``); the intensity stage, its fields and the
gate are as in 2D.  :func:`augment_volume_apply` launches K4v and
:func:`augment_heads_volume_apply` K4hv (``csrc/augment_batch.cu``); the
plain versions above take both ranks, and :func:`augment_batch` and
:func:`augment_batch_heads` pick the kernel by the image's rank.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import torch

from ..ops import _cuda

__all__ = ["AugmentDraws", "FLAGS", "draw", "augment_apply", "augment_apply_plain",
           "augment_volume_apply", "augment_batch", "HeadLayout", "orientation_keys",
           "augment_heads_apply", "augment_heads_apply_plain", "augment_heads_volume_apply",
           "augment_batch_heads"]


FLAGS = ("gate", "k", "flip_h", "flip_v", "bc_apply", "mult_apply", "gauss_apply")


@dataclass
class AugmentDraws:
    """One batch's random draws, in the form K4 takes them.

    ``flags`` is (B, 7) int32, one column per name of ``FLAGS``: the p=0.8
    gate, the quarter-turns k (0..3), flip_h, flip_v, and the apply flags of
    brightness/contrast, multiplicative noise and Gaussian noise.  ``coef`` is
    (B, 2) float32: the contrast factor ``alpha = 1 + U(−c, c)`` and the
    brightness offset ``beta = U(−b, b)`` (images in [0, 1]).  ``mult`` is the
    multiplier field and ``gauss`` the standard normal field that K4 scales
    by ``sigma``, each shaped like the image batch, (B, C, S, S) or
    (B, C, Z, S, S), in the output frame; a field left
    ``None`` switches its stage off.  The pair form carries its own fields in
    ``mult_prev``/``gauss_prev``."""

    flags: torch.Tensor
    coef: torch.Tensor
    mult: Optional[torch.Tensor] = None
    gauss: Optional[torch.Tensor] = None
    sigma: float = 0.0
    mult_prev: Optional[torch.Tensor] = None
    gauss_prev: Optional[torch.Tensor] = None

    def flag(self, name: str) -> torch.Tensor:
        return self.flags[:, FLAGS.index(name)]


def draw(generator: torch.Generator, batch: int, field_shape, prev: bool = False,
         brightness_contrast: Tuple[float, float] = (0.25, 0.25),
         noise_mult: Optional[Tuple[float, float]] = (0.5, 1.2),
         gauss_sigma: Optional[float] = None, p_pipeline: float = 0.8) -> AugmentDraws:
    """Every draw of one ``augment_batch`` call, on ``generator``'s device,
    with the JAX function's distributions and probabilities: gate
    p=``p_pipeline``; k uniform on 0..3; flips p=0.5; brightness/contrast
    p=0.5; each noise stage p=0.3.  ``field_shape`` is the image batch's
    (B, C, S, S) or (B, C, Z, S, S); images are in [0, 1] (``max_value`` 1
    of the JAX function)."""
    dev = generator.device
    u = torch.rand((batch, 9), generator=generator, device=dev)
    bright, contrast = brightness_contrast
    # columns in the order of FLAGS; built from Python scalars only, so a
    # draw never copies from the host and never waits for the device
    cols = (u[:, 0] < p_pipeline, torch.clamp(u[:, 1] * 4, max=3.0), u[:, 2] < 0.5,
            u[:, 3] < 0.5, u[:, 4] < 0.5, u[:, 7] < 0.3, u[:, 8] < 0.3)
    flags = torch.stack([c.to(torch.int32) for c in cols], 1)
    coef = torch.stack([1.0 + (u[:, 5] * (2 * contrast) - contrast),
                        u[:, 6] * (2 * bright) - bright], 1)
    out = AugmentDraws(flags=flags, coef=coef,
                       sigma=0.0 if gauss_sigma is None else float(gauss_sigma))

    def uniform():
        return torch.empty(field_shape, device=dev).uniform_(*noise_mult, generator=generator)

    def normal():
        return torch.randn(field_shape, generator=generator, device=dev)

    if noise_mult is not None:
        out.mult = uniform()
        out.mult_prev = uniform() if prev else None
    if gauss_sigma is not None:
        out.gauss = normal()
        out.gauss_prev = normal() if prev else None
    return out


def _check(image: torch.Tensor, mask: torch.Tensor, prev: Optional[torch.Tensor]):
    """NCHW tiles (N, C, S, S) or NCDHW volumes (N, C, Z, S, S), the square
    (S, S) plane the one that rotates; the targets share N and the spatial
    extent."""
    if image.dim() not in (4, 5) or mask.dim() != image.dim():
        raise ValueError(f"augment_apply takes NCHW or NCDHW tensors of one rank, got "
                         f"{tuple(image.shape)} and {tuple(mask.shape)}")
    s = image.shape[-1]
    if (image.shape[-2] != s or mask.shape[2:] != image.shape[2:]
            or mask.shape[0] != image.shape[0]):
        raise ValueError("augment_apply needs square (X, Y) planes of one size and as many "
                         f"masks as images, got {tuple(image.shape)} and {tuple(mask.shape)}")
    if prev is not None and prev.shape != image.shape:
        raise ValueError(f"prev {tuple(prev.shape)} must match image {tuple(image.shape)}")


def _spatial(x: torch.Tensor, k: int, fh: bool, fv: bool) -> torch.Tensor:
    """One (C, S, S) or (C, Z, S, S) sample: rot90 by k in the last two
    axes' plane, then flip_h along the last axis and flip_v along the one
    before (``augment_jax.py:41 _spatial_tx``, whose 3D ``axes`` are (1, 2)
    of (Z, X, Y, C))."""
    x = torch.rot90(x, k, dims=(-2, -1))
    if fh:
        x = torch.flip(x, dims=(-1,))
    if fv:
        x = torch.flip(x, dims=(-2,))
    return x


def _intensity(x: torch.Tensor, d: AugmentDraws, mult, gauss) -> torch.Tensor:
    """The image-only stage (``augment_jax.py:116 _intensity``)."""
    col = (-1,) + (1,) * (x.dim() - 1)

    def on(name):
        return d.flag(name).bool().view(col)

    alpha, beta = d.coef[:, 0].view(col), d.coef[:, 1].view(col)
    out = torch.where(on("bc_apply"), torch.clamp(x * alpha + beta, 0.0, 1.0), x)
    if mult is not None:
        out = torch.where(on("mult_apply"), torch.clamp(out * mult, 0.0, 1.0), out)
    if gauss is not None:
        out = torch.where(on("gauss_apply"), torch.clamp(out + d.sigma * gauss, 0.0, 1.0), out)
    return out


def augment_apply_plain(image, mask, draws: AugmentDraws, index=None, prev=None):
    """Plain PyTorch K4 (``torch.rot90``, ``torch.flip``, ``torch.where``,
    ``clamp``); same arguments and results as :func:`augment_apply`."""
    _check(image, mask, prev)
    if index is not None:
        image, mask = image[index], mask[index]
        prev = None if prev is None else prev[index]
    ks, fhs, fvs = (draws.flag(n).tolist() for n in ("k", "flip_h", "flip_v"))

    def spatial(t):
        return torch.stack([_spatial(t[b], ks[b], bool(fhs[b]), bool(fvs[b]))
                            for b in range(t.shape[0])])

    gate = draws.flag("gate").bool().view((-1,) + (1,) * (image.dim() - 1))
    outs = [torch.where(gate, _intensity(spatial(image), draws, draws.mult, draws.gauss), image),
            torch.where(gate, spatial(mask), mask)]
    if prev is not None:
        outs.append(torch.where(gate, _intensity(spatial(prev), draws, draws.mult_prev,
                                                 draws.gauss_prev), prev))
    return tuple(outs)


def _require_args(what: str, image, named, codes, draws: AugmentDraws, index,
                  pair: bool = False) -> int:
    """The checks of a kernel wrapper before its launch: every tensor on
    ``image``'s card, contiguous and float32 (``codes`` (ΣC,) int32), a 1-D
    int64 ``index``, noise fields shaped like the image batch (the pair
    form's own fields too) and draws for that batch.  Returns the batch
    size."""
    dev = image.device
    fields = (("mult", draws.mult), ("gauss", draws.gauss))
    if pair:
        fields += (("mult_prev", draws.mult_prev), ("gauss_prev", draws.gauss_prev))
    for name, t in named + fields:
        if t is None:
            continue
        _cuda.require_cuda(t, f"{what} {name}", dev)
        if t.dtype != torch.float32:
            raise ValueError(f"{what} {name}: expected float32, got {t.dtype}")
    if codes is not None:
        ct = named[-1][1].shape[1]
        _cuda.require_cuda(codes, f"{what} codes", dev)
        if codes.dtype != torch.int32 or tuple(codes.shape) != (ct,):
            raise ValueError(f"{what} codes: expected ({ct},) int32, got "
                             f"{tuple(codes.shape)} {codes.dtype}")
    if index is not None:
        if index.dtype != torch.int64 or index.dim() != 1:
            raise ValueError(f"{what} index: expected a 1-D int64 tensor")
        _cuda.require_cuda(index, f"{what} index", dev)
    b = image.shape[0] if index is None else index.shape[0]
    want = (b,) + tuple(image.shape[1:])
    for name, f in fields:
        if f is not None and tuple(f.shape) != want:
            raise ValueError(f"{what} {name}: field {tuple(f.shape)}, want {want}")
    if pair and ((draws.mult is None) != (draws.mult_prev is None)
                 or (draws.gauss is None) != (draws.gauss_prev is None)):
        raise ValueError(f"{what}: the pair form needs its own noise fields")
    flags, coef = draws.flags, draws.coef
    _cuda.require_cuda(flags, f"{what} flags", dev)
    _cuda.require_cuda(coef, f"{what} coef", dev)
    if (flags.dtype, coef.dtype) != (torch.int32, torch.float32) or (
            tuple(flags.shape), tuple(coef.shape)) != ((b, len(FLAGS)), (b, 2)):
        raise ValueError(f"{what}: draws {tuple(flags.shape)} {flags.dtype} / "
                         f"{tuple(coef.shape)} {coef.dtype} for a batch of {b}")
    return b


def _ptr(t):
    return None if t is None else t.data_ptr()


def augment_apply(image: torch.Tensor, mask: torch.Tensor, draws: AugmentDraws,
                  index: Optional[torch.Tensor] = None, prev: Optional[torch.Tensor] = None):
    """K4: gather rows ``index`` (default: all, in order) of the tile sets
    ``image`` (N, C, S, S) and ``mask`` (N, C', S, S) (and ``prev``) and apply
    ``draws`` → ``(image, mask)`` or ``(image, mask, prev)``, each (B, ·, S, S)
    float32.  On CUDA tensors one kernel launch; on CPU tensors the plain
    version.  Volume sets (5-D) go to :func:`augment_volume_apply`."""
    _check(image, mask, prev)
    if image.dim() == 5 and prev is None:
        return augment_volume_apply(image, mask, draws, index)
    if image.device.type == "cpu":
        return augment_apply_plain(image, mask, draws, index, prev)
    if image.dim() == 5:
        raise ValueError("augment_apply: the pair form (prev) takes NCHW tiles only")
    b = _require_args("augment_apply", image, (("image", image), ("mask", mask),
                                               ("prev", prev)), None, draws, index,
                      pair=prev is not None)
    n_src, ci, s = image.shape[0], image.shape[1], image.shape[-1]
    co, dev = mask.shape[1], image.device
    img_out = torch.empty((b, ci, s, s), dtype=torch.float32, device=dev)
    mask_out = torch.empty((b, co, s, s), dtype=torch.float32, device=dev)
    prev_out = None if prev is None else torch.empty_like(img_out)
    A = _cuda
    fn = A.function("augment_batch", "k4_augment_batch",
                    [A.P, A.P, A.P, A.P, A.I32, A.I32, A.I32, A.I32, A.I32, A.P, A.P,
                     A.P, A.P, A.P, A.P, A.F32, A.P, A.P, A.P, A.P])
    A.launch(fn, dev, _ptr(image), _ptr(mask), _ptr(prev), _ptr(index), n_src, b, ci, co, s,
             _ptr(draws.flags), _ptr(draws.coef), _ptr(draws.mult), _ptr(draws.gauss),
             _ptr(draws.mult_prev), _ptr(draws.gauss_prev), float(draws.sigma),
             _ptr(img_out), _ptr(mask_out), _ptr(prev_out))
    augment_apply.launches += 1
    return (img_out, mask_out) if prev is None else (img_out, mask_out, prev_out)


augment_apply.launches = 0


def augment_volume_apply(image: torch.Tensor, mask: torch.Tensor, draws: AugmentDraws,
                         index: Optional[torch.Tensor] = None):
    """K4v: gather rows ``index`` (default: all, in order) of the volume sets
    ``image`` (N, C, Z, S, S) and ``mask`` (N, C', Z, S, S) and apply
    ``draws`` (fields (B, C, Z, S, S)) → ``(image, mask)``, each
    (B, ·, Z, S, S) float32: rot90 and flips in the (X, Y) plane for every z.
    On CUDA tensors one kernel launch; on CPU tensors the plain version."""
    _check(image, mask, None)
    if image.dim() != 5:
        raise ValueError(f"augment_volume_apply takes NCDHW volumes, got {tuple(image.shape)}")
    if image.device.type == "cpu":
        return augment_apply_plain(image, mask, draws, index)
    b = _require_args("augment_volume_apply", image, (("image", image), ("mask", mask)),
                      None, draws, index)
    n_src, ci, z, s = image.shape[0], image.shape[1], image.shape[2], image.shape[-1]
    co = mask.shape[1]
    img_out = torch.empty((b, ci, z, s, s), dtype=torch.float32, device=image.device)
    mask_out = torch.empty((b, co, z, s, s), dtype=torch.float32, device=image.device)
    A = _cuda
    fn = A.function("augment_batch", "k4v_augment_volume",
                    [A.P, A.P, A.P, A.I32, A.I32, A.I32, A.I32, A.I32, A.I32, A.P, A.P, A.P, A.P,
                     A.F32, A.P, A.P, A.P])
    A.launch(fn, image.device, _ptr(image), _ptr(mask), _ptr(index), n_src, b, ci, co, z, s,
             _ptr(draws.flags), _ptr(draws.coef), _ptr(draws.mult), _ptr(draws.gauss),
             float(draws.sigma), _ptr(img_out), _ptr(mask_out))
    augment_volume_apply.launches += 1
    return img_out, mask_out


augment_volume_apply.launches = 0


def augment_batch(generator: torch.Generator, image, mask, prev=None, index=None,
                  brightness_contrast: Tuple[float, float] = (0.25, 0.25),
                  noise_mult: Optional[Tuple[float, float]] = (0.5, 1.2),
                  gauss_sigma: Optional[float] = None, p_pipeline: float = 0.8):
    """One full augmentation draw of a batch (``augment_jax.py:132``): the
    draws from ``generator``, then K4, or K4v for volumes (5-D).  ``index``
    gathers from a resident tile set; without it ``image`` is the batch."""
    b = image.shape[0] if index is None else index.shape[0]
    d = draw(generator, b, (b,) + tuple(image.shape[1:]), prev is not None,
             brightness_contrast, noise_mult, gauss_sigma, p_pipeline)
    return augment_apply(image, mask, d, index, prev)


# --- the multi-head form (augment_jax.py:192) -------------------------------------

# K4h's per-channel codes: a channel that only moves, and the cos and sin
# components of an orientation pair (cos always directly before its sin)
PLAIN, COS, SIN = 0, 1, 2
# cos/sin of k quarter turns (augment_jax.py:174-175)
_COS_K = (1.0, 0.0, -1.0, 0.0)
_SIN_K = (0.0, 1.0, 0.0, -1.0)


def orientation_keys(names) -> Tuple[str, ...]:
    """The heads whose (cos, sin) channels rotate with the tile: every name
    that contains ``"orientation"`` (``trainer.py:491-493``)."""
    return tuple(k for k in names if "orientation" in k)


@dataclass
class HeadLayout:
    """How head targets sit in one tensor concatenated along channels, the
    form K4h takes: the heads' ``names`` and ``channels`` in order, and
    ``codes`` (ΣC,) int32 on the tensors' device (``PLAIN``, ``COS``,
    ``SIN``)."""

    names: Tuple[str, ...]
    channels: Tuple[int, ...]
    codes: torch.Tensor

    @classmethod
    def of(cls, channels: Mapping[str, int], orientation=(), device=None) -> "HeadLayout":
        """The layout of heads with ``channels`` ({head: C}, in order); the
        heads in ``orientation`` must have 2 channels, (cos θ, sin θ)."""
        codes = []
        for name, c in channels.items():
            if name in orientation:
                if c != 2:
                    raise ValueError(f"orientation head {name!r} has {c} channels, "
                                     "want 2 (cos θ, sin θ)")
                codes += [COS, SIN]
            else:
                codes += [PLAIN] * int(c)
        return cls(tuple(channels), tuple(int(c) for c in channels.values()),
                   torch.tensor(codes, dtype=torch.int32, device=device))

    def concat(self, targets: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """{head: (N, C, S, S)} → (N, ΣC, S, S)."""
        return torch.cat([targets[k] for k in self.names], 1).contiguous()

    def split(self, t: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The per-head channel views of a (B, ΣC, S, S) tensor."""
        out, start = {}, 0
        for name, c in zip(self.names, self.channels):
            out[name] = t[:, start:start + c]
            start += c
        return out


def _check_codes(codes: Sequence[int], ct: int) -> None:
    if len(codes) != ct:
        raise ValueError(f"augment_heads_apply: {len(codes)} codes for {ct} target channels")
    for c, code in enumerate(codes):
        if not (code == PLAIN or (code == COS and c + 1 < ct and codes[c + 1] == SIN)
                or (code == SIN and c > 0 and codes[c - 1] == COS)):
            raise ValueError(f"augment_heads_apply: bad codes {list(codes)} (a COS channel "
                             "must be followed by its SIN channel)")


def _orient(t: torch.Tensor, codes: Sequence[int], k: int, fh: bool, fv: bool) -> torch.Tensor:
    """One (ΣC, S, S) target sample, already moved: its orientation pairs
    re-expressed in the output frame (``augment_jax.py:178``)."""
    out = t.clone()
    ck, sk = _COS_K[k], _SIN_K[k]
    for c, code in enumerate(codes):
        if code == COS:
            r = t[c] * ck + t[c + 1] * sk
            out[c] = -r if fh else r
        elif code == SIN:
            r = t[c] * ck - t[c - 1] * sk
            out[c] = -r if fv else r
    return out


def augment_heads_apply_plain(image, targets, codes, draws: AugmentDraws, index=None):
    """Plain PyTorch K4h (``torch.rot90``, ``torch.flip``, ``torch.where``);
    same arguments and results as :func:`augment_heads_apply`."""
    _check(image, targets, None)
    codes = [int(c) for c in torch.as_tensor(codes).tolist()]
    _check_codes(codes, targets.shape[1])
    if index is not None:
        image, targets = image[index], targets[index]
    ks, fhs, fvs = (draws.flag(n).tolist() for n in ("k", "flip_h", "flip_v"))
    spatial_img = torch.stack([_spatial(image[b], ks[b], bool(fhs[b]), bool(fvs[b]))
                               for b in range(image.shape[0])])
    spatial_tgt = torch.stack([_orient(_spatial(targets[b], ks[b], bool(fhs[b]), bool(fvs[b])),
                                       codes, ks[b], bool(fhs[b]), bool(fvs[b]))
                               for b in range(targets.shape[0])])
    gate = draws.flag("gate").bool().view((-1,) + (1,) * (image.dim() - 1))
    return (torch.where(gate, _intensity(spatial_img, draws, draws.mult, draws.gauss), image),
            torch.where(gate, spatial_tgt, targets))


def augment_heads_apply(image: torch.Tensor, targets: torch.Tensor, codes: torch.Tensor,
                        draws: AugmentDraws, index: Optional[torch.Tensor] = None):
    """K4h: gather rows ``index`` (default: all, in order) of the tile set
    ``image`` (N, C, S, S) and of the concatenated head targets ``targets``
    (N, ΣC, S, S) and apply ``draws``; ``codes`` (ΣC,) int32 marks the
    orientation pairs (:class:`HeadLayout`).  → ``(image, targets)``, each
    (B, ·, S, S) float32.  On CUDA tensors one kernel launch; on CPU tensors
    the plain version.  The draws' ``mult_prev``/``gauss_prev`` are unused.
    Volume sets (5-D) go to :func:`augment_heads_volume_apply`."""
    _check(image, targets, None)
    if image.dim() == 5:
        return augment_heads_volume_apply(image, targets, codes, draws, index)
    if image.device.type == "cpu":
        return augment_heads_apply_plain(image, targets, codes, draws, index)
    b = _require_args("augment_heads_apply", image, (("image", image), ("targets", targets)),
                      codes, draws, index)
    n_src, ci, s = image.shape[0], image.shape[1], image.shape[-1]
    ct, dev = targets.shape[1], image.device
    img_out = torch.empty((b, ci, s, s), dtype=torch.float32, device=dev)
    tgt_out = torch.empty((b, ct, s, s), dtype=torch.float32, device=dev)
    A = _cuda
    fn = A.function("augment_batch", "k4h_augment_heads",
                    [A.P, A.P, A.P, A.I32, A.I32, A.I32, A.I32, A.I32, A.P, A.P, A.P, A.P, A.P,
                     A.F32, A.P, A.P, A.P])
    A.launch(fn, dev, _ptr(image), _ptr(targets), _ptr(index), n_src, b, ci, ct, s, _ptr(codes),
             _ptr(draws.flags), _ptr(draws.coef), _ptr(draws.mult), _ptr(draws.gauss),
             float(draws.sigma), _ptr(img_out), _ptr(tgt_out))
    augment_heads_apply.launches += 1
    return img_out, tgt_out


augment_heads_apply.launches = 0


def augment_heads_volume_apply(image: torch.Tensor, targets: torch.Tensor, codes: torch.Tensor,
                               draws: AugmentDraws, index: Optional[torch.Tensor] = None):
    """K4hv: K4h on volume sets, ``image`` (N, C, Z, S, S) and the
    concatenated head targets ``targets`` (N, ΣC, Z, S, S); an orientation
    pair is rotated from both components at the same z and source pixel.
    → ``(image, targets)``, each (B, ·, Z, S, S) float32.  On CUDA tensors one
    kernel launch; on CPU tensors the plain version."""
    _check(image, targets, None)
    if image.dim() != 5:
        raise ValueError("augment_heads_volume_apply takes NCDHW volumes, got "
                         f"{tuple(image.shape)}")
    if image.device.type == "cpu":
        return augment_heads_apply_plain(image, targets, codes, draws, index)
    b = _require_args("augment_heads_volume_apply", image,
                      (("image", image), ("targets", targets)), codes, draws, index)
    n_src, ci, z, s = image.shape[0], image.shape[1], image.shape[2], image.shape[-1]
    ct = targets.shape[1]
    img_out = torch.empty((b, ci, z, s, s), dtype=torch.float32, device=image.device)
    tgt_out = torch.empty((b, ct, z, s, s), dtype=torch.float32, device=image.device)
    A = _cuda
    fn = A.function("augment_batch", "k4hv_augment_heads_volume",
                    [A.P, A.P, A.P, A.I32, A.I32, A.I32, A.I32, A.I32, A.I32, A.P, A.P, A.P, A.P,
                     A.P, A.F32, A.P, A.P, A.P])
    A.launch(fn, image.device, _ptr(image), _ptr(targets), _ptr(index), n_src, b, ci, ct, z, s,
             _ptr(codes), _ptr(draws.flags), _ptr(draws.coef), _ptr(draws.mult),
             _ptr(draws.gauss), float(draws.sigma), _ptr(img_out), _ptr(tgt_out))
    augment_heads_volume_apply.launches += 1
    return img_out, tgt_out


augment_heads_volume_apply.launches = 0


def augment_batch_heads(generator: torch.Generator, image,
                        targets: Union[Mapping[str, torch.Tensor], torch.Tensor],
                        orientation_keys: Sequence[str] = (), index=None,
                        layout: Optional[HeadLayout] = None,
                        brightness_contrast: Tuple[float, float] = (0.25, 0.25),
                        noise_mult: Optional[Tuple[float, float]] = (0.5, 1.2),
                        gauss_sigma: Optional[float] = None, p_pipeline: float = 0.8):
    """One full multi-head augmentation draw (``augment_jax.py:192``): the
    draws from ``generator``, then K4h, or K4hv for volumes (5-D).
    ``targets`` is {head: (N, C, S, S)} (or (N, C, Z, S, S)),
    concatenated here, with ``orientation_keys`` naming the orientation
    heads; or the concatenated (N, ΣC, S, S) tensor itself with its
    ``layout`` (a resident set is concatenated once).  ``index`` gathers from
    a resident tile set; without it ``image`` is the batch.  → ``(image,
    {head: (B, C, S, S)})``, the heads channel views of one tensor."""
    if layout is None:
        layout = HeadLayout.of({k: v.shape[1] for k, v in targets.items()}, orientation_keys,
                               image.device)
        targets = layout.concat(targets)
    b = image.shape[0] if index is None else index.shape[0]
    d = draw(generator, b, (b,) + tuple(image.shape[1:]), False, brightness_contrast,
             noise_mult, gauss_sigma, p_pipeline)
    img, tgt = augment_heads_apply(image, targets, layout.codes, d, index)
    return img, layout.split(tgt)
