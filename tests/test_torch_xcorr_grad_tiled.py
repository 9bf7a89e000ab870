"""K6b on K6's register tiles (``csrc/depthwise_xcorr.cu`` ``xcorr_tiles``),
held on the CPU against the plain versions of ``ops/functional.py``.

- The two identities the design rests on, bit for bit on the plain versions:
  the grad input is K6 of the mirrored g, mirrored; the grad kernel is K6 of
  cur with g as the kernel, on a (kh, kw) window of its output (cur
  zero-padded where the window reaches past K6's 'same' output).
- The tile walk emulated in float32 with the staging that
  ``xcorr_grad_geometry`` chooses (g staged and each output stored at the
  mirrored place; the grad kernel's window): bit-equal to the plain
  versions, every read inside the staged planes, every 4-column window
  16-byte aligned.
- The geometry: two blocks an SM at the Siam trainer's shape, the plane
  forms above the tiled staging, ``xcorr_grad_fits``'s reach unchanged.
"""

import pytest
import torch
import torch.nn.functional as F

import torch_parity  # noqa: F401  (one torch thread a test process)
from bio_image_unet_tpu_torch.ops import functional
from bio_image_unet_tpu_torch.ops.functional import (depthwise_xcorr_grad_input_plain,
                                                     depthwise_xcorr_grad_kernel_plain,
                                                     depthwise_xcorr_plain)
from torch_xcorr_tiles import GRAD_SHAPES, grad_inputs, shape_ids, tiled_walk

DTYPES = [torch.float32, torch.bfloat16]
# the H100's streaming multiprocessors, which the wrapper passes on that card
H100_SMS = 132


def _operands(shape, kernel, dtype, seed):
    return (torch.from_numpy(a).to(dtype) for a in grad_inputs(shape, kernel, seed))


def _grad_kernel_by_k6(g, cur, kernel):
    """The grad kernel as K6 of cur with g as the kernel: output (i, j) of
    K6 with g's 'same' padding ((H-1)//2, (W-1)//2) is tap (i - oy, j - ox)
    of the grad kernel; cur is zero-padded so that the window lies inside
    K6's output."""
    h, w = g.shape[2:]
    kh, kw = kernel
    top, left = max(0, (kh - 1) // 2 - (h - 1) // 2), max(0, (kw - 1) // 2 - (w - 1) // 2)
    oy, ox = (h - 1) // 2 - (kh - 1) // 2 + top, (w - 1) // 2 - (kw - 1) // 2 + left
    x = F.pad(cur, (left, max(0, ox + kw - w - left), top, max(0, oy + kh - h - top)))
    return depthwise_xcorr_plain(x, g)[:, :, oy:oy + kh, ox:ox + kw]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,kernel", GRAD_SHAPES, ids=shape_ids)
def test_grads_are_k6_in_disguise(shape, kernel, dtype):
    cur, prev, g = _operands(shape, kernel, dtype, 5 * sum(shape) + sum(kernel))
    assert torch.equal(depthwise_xcorr_plain(g.flip(2, 3), prev).flip(2, 3),
                       depthwise_xcorr_grad_input_plain(g, prev))
    assert torch.equal(_grad_kernel_by_k6(g, cur, kernel),
                       depthwise_xcorr_grad_kernel_plain(g, cur, kernel))
    # the trainer's case, a kernel as large as its plane: no window
    full = depthwise_xcorr_grad_kernel_plain(g, cur, shape[2:])
    assert torch.equal(depthwise_xcorr_plain(cur, g), full)


def _k6b_tiled(g, other, kernel, kernel_grad, sms=H100_SMS, planes=None):
    """K6b's two forms on ``tiled_walk`` with the staging
    ``xcorr_grad_geometry`` chooses for ``planes`` planes (by default g's
    B·C; a plane's walk depends on the count only through the block's planes
    and a warp's tiles): ``other`` is prev (grad input: g mirrored) or cur
    (grad kernel: g the walk's kernel, (kh, kw) outputs)."""
    b, c, h, w = g.shape
    geo = functional.xcorr_grad_geometry(planes or b * c, h, w, *kernel, kernel_grad,
                                         g.element_size(), sms)
    if kernel_grad:
        return tiled_walk(other, g, kernel, kernel, geo)
    return tiled_walk(g, other, kernel, (h, w), geo, mirrored=True)


# sms 1: the largest block that fits (one warp across 32 planes, n = 1);
# the H100's 132: as the wrapper chooses at these plane counts (n = 4 or as
# many as the output's tile columns)
@pytest.mark.parametrize("sms", [1, H100_SMS], ids=["sms1", "h100"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,kernel", GRAD_SHAPES, ids=shape_ids)
def test_k6b_tiling_bit_equal_to_plain(shape, kernel, dtype, sms):
    cur, prev, g = _operands(shape, kernel, dtype, 11 * sum(shape) + sum(kernel))
    assert torch.equal(_k6b_tiled(g, prev, kernel, False, sms),
                       depthwise_xcorr_grad_input_plain(g, prev))
    assert torch.equal(_k6b_tiled(g, cur, kernel, True, sms),
                       depthwise_xcorr_grad_kernel_plain(g, cur, kernel))


# chip_smoke.py's four shapes (the Siam trainer's (12, 256, 16, 16) bf16, the
# facade's float32 (4, 256, 16, 16), the timing-only 15² k 15² and 32² k 16²)
# cut to a few planes, at the geometry of their real plane counts (8 planes
# a block, 4 tiles a warp)
@pytest.mark.parametrize("shape,kernel,dtype,planes", [
    ((1, 32, 16, 16), (16, 16), torch.bfloat16, 3072),
    ((1, 32, 16, 16), (16, 16), torch.float32, 1024),
    ((1, 16, 15, 15), (15, 15), torch.bfloat16, 3072),
    ((1, 8, 32, 32), (16, 16), torch.bfloat16, 3072)],
    ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v).replace("torch.", ""))
def test_k6b_tiling_at_the_path_shapes(shape, kernel, dtype, planes):
    cur, prev, g = _operands(shape, kernel, dtype, sum(shape))
    assert torch.equal(_k6b_tiled(g, prev, kernel, False, planes=planes),
                       depthwise_xcorr_grad_input_plain(g, prev))
    assert torch.equal(_k6b_tiled(g, cur, kernel, True, planes=planes),
                       depthwise_xcorr_grad_kernel_plain(g, cur, kernel))


def test_k6b_geometry():
    # the trainer's 3072 planes: 8 a block, 384 blocks, at least two an SM
    # of the H100 in both forms (K6's forward stages 32: 96 blocks)
    assert functional.xcorr_geometry(16, 16, 16, 16, 2).cg == 32
    for kernel_grad in (False, True):
        geo = functional.xcorr_grad_geometry(12 * 256, 16, 16, 16, 16, kernel_grad, 2, H100_SMS)
        assert geo.cg == 8 and geo.n == 4 and geo.threads == 128
        assert -(-12 * 256 // geo.cg) >= 2 * H100_SMS
        # 32² planes, kernel 16²: the grad kernel's output is 16², the
        # input's 32²
        geo = functional.xcorr_grad_geometry(12 * 256, 32, 32, 16, 16, kernel_grad, 2, H100_SMS)
        assert geo.cg == 8 and geo.tiles == (16 if kernel_grad else 64)
    # fewer planes than two blocks an SM: the smallest block whose warps
    # stay on the output's tiles
    geo = functional.xcorr_grad_geometry(4 * 256, 16, 16, 16, 16, False, 4, H100_SMS)
    assert geo.cg == 8 and -(-4 * 256 // geo.cg) < 2 * H100_SMS
    assert functional.xcorr_grad_geometry(3, 4, 5, 7, 6, True, 4, H100_SMS).n <= 2
    # above ~112² the staging does not fit: the plane forms take over, as
    # far as xcorr_grad_fits reaches (170²), and the wrapper refuses beyond
    assert functional.xcorr_grad_geometry(2, 112, 112, 112, 112, False, 4, H100_SMS) is not None
    for n in (113, 128, 170):
        assert functional.xcorr_grad_geometry(2, n, n, n, n, False, 4, H100_SMS) is None
        assert functional.xcorr_grad_geometry(2, n, n, n, n, True, 4, H100_SMS) is None
        assert functional.xcorr_grad_fits(n, n, n, n)
    assert functional.xcorr_grad_geometry(2, 170, 170, 9, 9, False, 4, H100_SMS) is None
    assert not functional.xcorr_grad_fits(171, 171, 171, 171)
