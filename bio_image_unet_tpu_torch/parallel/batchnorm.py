"""Training across ranks: BatchNorm over the global batch and an autograd
gather of per-rank outputs.

The JAX package has no module for this.  A jitted step that sees a batch
split over the mesh's ``data`` axis is still the computation on the whole
batch, so XLA takes the BatchNorm statistics over the global batch and the
loss over the global outputs; that is why JAX's replicated training mode has
"loss trajectory identical to single-chip" (``train/trainer.py:382-386``).
Here each rank runs its slice, so :class:`CrossRankBatchNorm` reduces the
statistics (forward) and the two gradient sums (backward) over the data
group, and :func:`gather_rows` hands every rank the global outputs for the
loss.  ``torch.nn.SyncBatchNorm`` is not used: its ``forward`` refuses CPU
tensors, and the gloo worlds on the CPU must run this too.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn
from torch.nn.modules.batchnorm import _BatchNorm


def _acc_dtype(device: torch.device) -> torch.dtype:
    """The type ``nn.BatchNorm`` accumulates its float32 statistics in on
    ``device``: float32 on the card, float64 on the CPU."""
    return torch.float32 if device.type == "cuda" else torch.float64


class _CrossRankBN(torch.autograd.Function):
    """Train-mode batch normalization of (N, C, *S) float32 ``x`` with the
    per-channel statistics of every rank of ``group``: sum, sum of squares
    and count reduced in the accumulation type ``nn.BatchNorm`` uses on the
    device (:func:`_acc_dtype`), mean and biased variance as ``E[x²] − E[x]²``
    (JAX's ``TorchBatchNorm``).  Backward: Σdy and Σdy·x̂ reduced over the
    group for the input's gradient; the weight's and bias's gradients stay
    this rank's sums (the gradient average adds them up)."""

    @staticmethod
    def forward(ctx, x, weight, bias, group, eps, stats_out):
        c, acc = x.shape[1], _acc_dtype(x.device)
        dims = [0] + list(range(2, x.dim()))
        count = torch.full((1,), x.numel() // c, dtype=acc, device=x.device)
        xa = x.to(acc)
        red = torch.cat([xa.sum(dims), (xa * xa).sum(dims), count])
        dist.all_reduce(red, group=group)
        n = red[2 * c]
        mean = red[:c] / n
        var = (red[c:2 * c] / n - mean * mean).to(x.dtype)
        mean = mean.to(x.dtype)
        invstd = torch.rsqrt(var + eps)
        shape = (1, c) + (1,) * (x.dim() - 2)
        xhat = (x - mean.view(shape)) * invstd.view(shape)
        stats_out.extend([mean, var, float(n)])
        ctx.save_for_backward(xhat, invstd, weight)
        ctx.group, ctx.dims, ctx.shape = group, dims, shape
        return xhat * weight.view(shape) + bias.view(shape)

    @staticmethod
    def backward(ctx, dy):
        xhat, invstd, weight = ctx.saved_tensors
        c, shape, acc = xhat.shape[1], ctx.shape, _acc_dtype(dy.device)
        dya = dy.to(acc)
        sum_dy = dya.sum(ctx.dims)
        sum_dy_xhat = (dya * xhat.to(acc)).sum(ctx.dims)
        count = torch.full((1,), xhat.numel() // c, dtype=acc, device=dy.device)
        red = torch.cat([sum_dy, sum_dy_xhat, count])
        dist.all_reduce(red, group=ctx.group)
        n = red[2 * c]
        mean_dy = (red[:c] / n).to(dy.dtype)
        mean_dy_xhat = (red[c:2 * c] / n).to(dy.dtype)
        dx = (dy - mean_dy.view(shape) - xhat * mean_dy_xhat.view(shape)) \
            * (invstd * weight).view(shape)
        return dx, sum_dy_xhat.to(dy.dtype), sum_dy.to(dy.dtype), None, None, None


class CrossRankBatchNorm(_BatchNorm):
    """``nn.BatchNorm2d``/``3d`` with train-mode statistics over every rank
    of ``group`` (the mesh's data group).  It keeps the module's parameters,
    buffers and state-dict keys, updates the running statistics as
    ``nn.BatchNorm`` does (momentum, unbiased variance from the global count)
    and is the plain eval-mode affine map, with no collective, outside
    training."""

    def __init__(self, bn: _BatchNorm, group):
        super().__init__(bn.num_features, bn.eps, bn.momentum, bn.affine,
                         bn.track_running_stats)
        self.weight, self.bias = bn.weight, bn.bias
        self.running_mean, self.running_var = bn.running_mean, bn.running_var
        self.num_batches_tracked = bn.num_batches_tracked
        self.group = group
        self.training = bn.training

    def _check_input_dim(self, x):
        if x.dim() not in (4, 5):
            raise ValueError(f"expected a 4-D or 5-D input, got {x.dim()}-D")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._check_input_dim(x)
        if not self.training:
            return super().forward(x)
        stats = []
        y = _CrossRankBN.apply(x, self.weight, self.bias, self.group, self.eps, stats)
        if self.track_running_stats:
            mean, var, n = stats
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1 - m).add_(mean, alpha=m)
                self.running_var.mul_(1 - m).add_(var * (n / (n - 1)), alpha=m)
                self.num_batches_tracked.add_(1)
        return y


def convert_batchnorm(module: nn.Module, group) -> nn.Module:
    """Swap every ``BatchNorm2d``/``BatchNorm3d`` under ``module`` for a
    :class:`CrossRankBatchNorm` over ``group`` sharing its tensors (the
    parameters stay the same objects, so an optimizer made before or after
    sees them); returns ``module``."""
    for name, child in module.named_children():
        if isinstance(child, (nn.BatchNorm2d, nn.BatchNorm3d)):
            setattr(module, name, CrossRankBatchNorm(child, group))
        else:
            convert_batchnorm(child, group)
    return module


class _GatherRows(torch.autograd.Function):
    """All-gather along dim 0 over a mesh axis; the backward keeps this
    rank's rows of the gradient (every rank computes the same loss on the
    gathered whole, so its gradient there is already the whole's)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.n, ctx.at = x.shape[0], mesh.index(axis)
        return mesh.all_gather(x, axis, 0)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(0, ctx.at * ctx.n, ctx.n), None, None


def gather_rows(tree, mesh, axis: str = "data"):
    """Every tensor of ``tree`` (a tensor, tuple, list or dict) gathered
    along dim 0 over ``axis``, differentiably."""
    if isinstance(tree, torch.Tensor):
        return _GatherRows.apply(tree, mesh, axis)
    if isinstance(tree, dict):
        return {k: gather_rows(v, mesh, axis) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(gather_rows(v, mesh, axis) for v in tree)
    return tree
