"""K6b, the backward of the Siam ``corr`` join's depthwise cross-correlation
(``ops/functional.py``), held against ``jax.vjp`` of JAX's ``depthwise_xcorr``
on the CPU.

- The plain ∂cur and ∂prev against JAX's cotangents at odd, even and 16×16
  kernels and a plane larger than its kernel: float32 within 1e-5 of the sum
  of |a·b| over each output's terms, bf16 within one bf16 ulp of the float32
  result.
- The autograd Function of ``depthwise_xcorr`` equal bit for bit to the
  plain functions, and its forward to the plain forward.
- The kernels' loops (a block a plane, each output's range clipped to the
  plane exactly, in the plain versions' order), emulated on the CPU, equal
  bit for bit to the plain versions: the order-and-rounding claim of
  ``csrc/depthwise_xcorr.cu`` K6b.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread a test process)
from bio_image_unet_tpu.ops.functional import depthwise_xcorr as j_xcorr
from bio_image_unet_tpu_torch.ops import functional
from bio_image_unet_tpu_torch.ops.functional import (depthwise_xcorr,
                                                     depthwise_xcorr_grad_input,
                                                     depthwise_xcorr_grad_input_plain,
                                                     depthwise_xcorr_grad_kernel,
                                                     depthwise_xcorr_grad_kernel_plain,
                                                     depthwise_xcorr_plain)

# cur (B, C, H, W), kernel (kh, kw): odd, even, the trainer's 16x16 on 16²
# planes, a plane larger than its kernel (odd and even), a kernel larger
# than its plane
GRAD_SHAPES = [
    ((2, 3, 5, 5), (5, 5)),
    ((2, 3, 4, 6), (4, 6)),
    ((2, 4, 16, 16), (16, 16)),
    ((3, 2, 9, 11), (3, 4)),
    ((1, 3, 12, 10), (5, 3)),
    ((1, 2, 3, 4), (6, 5)),
]


def _nhwc(a):
    return jnp.asarray(np.ascontiguousarray(a.transpose(0, 2, 3, 1)))


def _jax_grads(cur, prev, g):
    """JAX's cotangents of ``depthwise_xcorr`` w.r.t. (cur, prev), NCHW."""
    _, vjp = jax.vjp(lambda c, p: j_xcorr(c, p, precision=jax.lax.Precision.HIGHEST),
                     _nhwc(cur), _nhwc(prev))
    d_cur, d_prev = vjp(_nhwc(g))
    return (np.asarray(d_cur).transpose(0, 3, 1, 2), np.asarray(d_prev).transpose(0, 3, 1, 2))


def _inputs(shape, kernel, seed):
    rng = np.random.default_rng(seed)
    cur = rng.standard_normal(shape).astype(np.float32)
    prev = rng.standard_normal(shape[:2] + kernel).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    return cur, prev, g


def _ids(v):
    return "x".join(map(str, v))


@pytest.mark.parametrize("shape,kernel", GRAD_SHAPES, ids=_ids)
def test_plain_grads_match_jax_vjp(shape, kernel):
    cur, prev, g = _inputs(shape, kernel, 3 * sum(shape) + sum(kernel))
    ref_cur, ref_prev = _jax_grads(cur, prev, g)
    t = {k: torch.from_numpy(v) for k, v in (("cur", cur), ("prev", prev), ("g", g))}
    d_cur = depthwise_xcorr_grad_input_plain(t["g"], t["prev"])
    d_prev = depthwise_xcorr_grad_kernel_plain(t["g"], t["cur"], kernel)
    assert d_cur.shape == shape and d_prev.shape == shape[:2] + kernel
    # 1e-5 of the sum of |a·b| over each output's terms
    bound_cur = depthwise_xcorr_grad_input_plain(t["g"].abs(), t["prev"].abs()).numpy()
    bound_prev = depthwise_xcorr_grad_kernel_plain(t["g"].abs(), t["cur"].abs(), kernel).numpy()
    assert (np.abs(d_cur.numpy() - ref_cur) <= 1e-5 * bound_cur).all()
    assert (np.abs(d_prev.numpy() - ref_prev) <= 1e-5 * bound_prev).all()
    # bf16 inputs: float32 sums rounded once, within one bf16 ulp of the
    # float32 result on the same (bf16-rounded) inputs
    h = {k: v.to(torch.bfloat16) for k, v in t.items()}
    for half, full in (
            (depthwise_xcorr_grad_input_plain(h["g"], h["prev"]),
             depthwise_xcorr_grad_input_plain(h["g"].float(), h["prev"].float())),
            (depthwise_xcorr_grad_kernel_plain(h["g"], h["cur"], kernel),
             depthwise_xcorr_grad_kernel_plain(h["g"].float(), h["cur"].float(), kernel))):
        assert half.dtype == torch.bfloat16
        ulp = torch.finfo(torch.bfloat16).eps * full.abs()
        assert ((half.float() - full).abs() <= ulp).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,kernel", GRAD_SHAPES[:4], ids=_ids)
def test_autograd_function_equals_plain(shape, kernel, dtype):
    cur, prev, g = (torch.from_numpy(a).to(dtype)
                    for a in _inputs(shape, kernel, sum(shape) * 5 + 1))
    c, p = cur.clone().requires_grad_(), prev.clone().requires_grad_()
    out = depthwise_xcorr(c, p)
    assert out.requires_grad and out.dtype == dtype
    assert torch.equal(out.detach(), depthwise_xcorr_plain(cur, prev))
    d_cur, d_prev = torch.autograd.grad(out, (c, p), g)
    assert torch.equal(d_cur, depthwise_xcorr_grad_input_plain(g, prev))
    assert torch.equal(d_prev, depthwise_xcorr_grad_kernel_plain(g, cur, kernel))
    # the wrappers take their plain versions on CPU tensors, and leave the
    # launch counters alone
    before = (depthwise_xcorr_grad_input.launches, depthwise_xcorr_grad_kernel.launches)
    assert torch.equal(depthwise_xcorr_grad_input(g, prev), d_cur)
    assert torch.equal(depthwise_xcorr_grad_kernel(g, cur, kernel), d_prev)
    assert (depthwise_xcorr_grad_input.launches,
            depthwise_xcorr_grad_kernel.launches) == before


def test_autograd_function_only_where_a_gradient_is_needed():
    cur, prev, g = (torch.from_numpy(a) for a in _inputs((1, 2, 6, 6), (6, 6), 11))
    assert depthwise_xcorr(cur, prev).grad_fn is None
    p = prev.clone().requires_grad_()
    out = depthwise_xcorr(cur, p)
    (d_prev,) = torch.autograd.grad(out, (p,), g)
    assert torch.equal(d_prev, depthwise_xcorr_grad_kernel_plain(g, cur, (6, 6)))
    with torch.no_grad():
        assert depthwise_xcorr(cur, p).grad_fn is None
    # the gradient sums into a leaf shared by both operands, as the twin
    # encoder's parameters are
    x = cur.clone().requires_grad_()
    out = depthwise_xcorr(x, x)
    (dx,) = torch.autograd.grad(out, (x,), g)
    want = depthwise_xcorr_grad_input_plain(g, cur) + depthwise_xcorr_grad_kernel_plain(
        g, cur, (6, 6))
    assert torch.equal(dx, want)


def _grad_input_per_output(g, prev):
    """K6b grad input (``xcorr_grad_input``) emulated in float32 on the CPU:
    each output's taps clipped to the plane exactly, u outer, v inner, a
    product and a sum rounded apiece."""
    b, c, h, w = g.shape
    kh, kw = prev.shape[2:]
    ph, pw = (kh - 1) // 2, (kw - 1) // 2
    x, k = g.float(), prev.float()
    out = torch.empty((b, c, h, w))
    for i in range(h):
        for j in range(w):
            acc = torch.zeros((b, c))
            for u in range(max(0, i + ph - h + 1), min(kh, i + ph + 1)):
                for v in range(max(0, j + pw - w + 1), min(kw, j + pw + 1)):
                    acc = acc + x[:, :, i + ph - u, j + pw - v] * k[:, :, u, v]
            out[:, :, i, j] = acc
    return out.to(g.dtype)


def _grad_kernel_per_tap(g, cur, kernel):
    """K6b grad kernel (``xcorr_grad_kernel``) emulated in float32 on the
    CPU: each tap's outputs clipped to the plane exactly, y outer, x inner."""
    b, c, h, w = g.shape
    kh, kw = kernel
    ph, pw = (kh - 1) // 2, (kw - 1) // 2
    x, gf = cur.float(), g.float()
    out = torch.empty((b, c, kh, kw))
    for u in range(kh):
        for v in range(kw):
            acc = torch.zeros((b, c))
            for y in range(max(0, ph - u), min(h, h + ph - u)):
                for xx in range(max(0, pw - v), min(w, w + pw - v)):
                    acc = acc + gf[:, :, y, xx] * x[:, :, y + u - ph, xx + v - pw]
            out[:, :, u, v] = acc
    return out.to(g.dtype)


@pytest.mark.parametrize("shape,kernel,dtype", [
    ((2, 3, 7, 6), (7, 6), torch.float32), ((1, 2, 9, 13), (2, 8), torch.bfloat16),
    ((1, 2, 8, 8), (5, 4), torch.float32), ((1, 2, 3, 4), (6, 5), torch.bfloat16)],
    ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v)[6:])
def test_grad_kernels_loops_bit_equal_to_plain(shape, kernel, dtype):
    cur, prev, g = (torch.from_numpy(a).to(dtype)
                    for a in _inputs(shape, kernel, 7 * sum(shape) + sum(kernel)))
    assert torch.equal(_grad_input_per_output(g, prev), depthwise_xcorr_grad_input_plain(g, prev))
    assert torch.equal(_grad_kernel_per_tap(g, cur, kernel),
                       depthwise_xcorr_grad_kernel_plain(g, cur, kernel))


def test_grad_staging_limit():
    """K6b stages g and the other operand in float32: up to ~170² planes
    (the forward's plane form reaches as far)."""
    assert functional.xcorr_grad_fits(16, 16, 16, 16)
    assert functional.xcorr_grad_fits(170, 170, 170, 170)
    assert not functional.xcorr_grad_fits(171, 171, 171, 171)
    assert not functional.xcorr_grad_fits(16, 16, 250, 250)
    with pytest.raises(ValueError, match="same B and C"):
        depthwise_xcorr_grad_input(torch.zeros((1, 2, 4, 4)), torch.zeros((1, 3, 4, 4)))
    with pytest.raises(ValueError, match="differ"):
        depthwise_xcorr_grad_kernel(torch.zeros((1, 2, 4, 4)), torch.zeros((1, 2, 5, 4)), (3, 3))
