"""Shared helpers of the K6 / K6b tests (``test_torch_xcorr_grad.py``,
``test_torch_xcorr_grad_tiled.py``, ``test_torch_siam.py``): the backward's
test shapes and inputs, and ``tiled_walk``, the CPU emulation of
``xcorr_tiles`` (``csrc/depthwise_xcorr.cu``) that K6 and both K6b forms
share.  Imports neither JAX nor the JAX package.
"""

import numpy as np
import torch

from bio_image_unet_tpu_torch.ops import functional

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


def grad_inputs(shape, kernel, seed):
    rng = np.random.default_rng(seed)
    cur = rng.standard_normal(shape).astype(np.float32)
    prev = rng.standard_normal(shape[:2] + kernel).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    return cur, prev, g


def shape_ids(v):
    return "x".join(map(str, v))


def tiled_walk(inp, ker, kernel, out_size, geo, mirrored=False):
    """``xcorr_tiles`` (K6 and K6b, ``csrc/depthwise_xcorr.cu``) emulated in
    float32 on the CPU with the staging ``geo``: the (h, w) planes of
    ``inp`` zero-haloed, the walk's kernel ``ker`` padded to ``kwp``
    columns, the forward's padding from ``kernel`` ((kh-1)//2, (kw-1)//2),
    R×S output tiles of ``out_size``; each warp region's tap range (rows
    exact, columns rounded out to 4) walked u outer, v inner, a product and
    a sum rounded apiece; ``mirrored``: ``inp`` staged and each output
    stored at the mirrored place (K6b's grad input).  Every read is checked
    to lie in the staged plane and every 4-column window start to be
    16-byte aligned."""
    b, c, h, w = inp.shape
    wkh, wkw = ker.shape[2:]
    oh, ow = out_size
    r_, s_ = functional.XCORR_R, functional.XCORR_S
    ph, pw = (kernel[0] - 1) // 2, (kernel[1] - 1) // 2
    rows = h + 2 * geo.pad_t
    x = torch.zeros((b * c, rows, geo.xp))
    staged = inp.float().reshape(b * c, h, w)
    x[:, geo.pad_t:geo.pad_t + h, geo.pad_l:geo.pad_l + w] = (
        staged.flip(1, 2) if mirrored else staged)
    k = torch.zeros((b * c, wkh, geo.kwp))
    k[:, :, :wkw] = ker.float().reshape(b * c, wkh, wkw)
    out = torch.empty((b * c, oh, ow))
    assert geo.xp % 4 == 0 and geo.xplane % 32 == 4 and geo.cg * geo.n == 32
    assert geo.tpr % geo.n == 0 and geo.tpr * s_ >= ow and geo.tiles == -(-oh // r_) * geo.tpr
    assert geo.xplane >= rows * geo.xp and geo.smem <= functional._SMEM_BYTES
    for tr in range(-(-oh // r_)):
        for tc in range(geo.tpr):
            i0, j0, jr = tr * r_, tc * s_, (tc - tc % geo.n) * s_
            u_lo, u_hi = max(0, ph - (i0 + r_ - 1)), min(wkh, h + ph - i0)
            v_lo = max(0, pw - (jr + geo.n * s_ - 1)) // 4 * 4
            v_end = -(-min(wkw, w + pw - jr) // 4) * 4
            if v_end <= v_lo:  # only a grad kernel window reaches past the plane so
                u_hi = u_lo
            y0, x0 = geo.pad_t + i0 - ph, geo.pad_l + j0 - pw
            if u_lo < u_hi:
                assert y0 + u_lo >= 0 and y0 + r_ - 1 + u_hi - 1 < rows
                assert x0 + v_lo >= 0 and x0 + v_end + 3 < geo.xp and v_end <= geo.kwp
                assert (x0 + v_lo) % 4 == 0
            acc = torch.zeros((b * c, r_, s_))
            for u in range(u_lo, u_hi):
                for v in range(v_lo, v_end):
                    win = x[:, y0 + u:y0 + u + r_, x0 + v:x0 + v + s_]
                    acc = acc + win * k[:, u, v][:, None, None]
            out[:, i0:i0 + r_, j0:j0 + s_] = acc[:, :min(r_, oh - i0), :max(0, min(s_, ow - j0))]
    if mirrored:
        out = out.flip(1, 2)
    return out.reshape(b, c, oh, ow).to(inp.dtype)
