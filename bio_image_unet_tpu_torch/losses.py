"""The loss zoo as pure tensor functions plus thin class wrappers
(counterpart of ``bio_image_unet_tpu/losses.py``).

Each function computes what its JAX twin computes, term for term, so that a
value and its gradient agree with ``jax.grad`` of the JAX function on the
same inputs.  Layout is the torch idiom, channels first:

- segmentation and regression losses are layout-free (whole-tensor means and
  per-sample flattening), so they take the same arguments as in JAX;
- the structural losses default to the spatial axes ``(-2, -1)`` of NCHW and
  the vector-field loss to ``channel_axis=1`` (JAX: ``(-3, -2)`` of NHWC and
  ``-1``);
- the temporal losses default to ``time_axis=2`` of (B, C, Z, X, Y), the
  reference's layout (JAX: ``1`` of (B, Z, X, Y, C)).

The Trainer picks logits per channel as ``logits[:, ch]`` (JAX:
``logits[..., ch]``).
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = [
    "bce_loss", "weighted_bce_loss", "soft_dice_loss", "bce_dice_loss",
    "logcosh_dice_loss", "tversky_loss", "logcosh_tversky_loss",
    "mse_loss", "mae_loss", "huber_loss", "smooth_l1_loss",
    "gradient_loss", "distance_gradient_loss",
    "weighted_distance_gradient_loss", "weighted_vector_field_loss",
    "temporal_consistency_loss", "bce_dice_temporal_loss", "BCELoss2d",
    "SoftDiceLoss", "BCEDiceLoss", "BCEDiceLossProb", "BCEDiceLossProb3D",
    "logcoshDiceLoss", "TverskyLoss", "logcoshTverskyLoss", "weightedBCELoss",
    "MSELoss", "MAELoss", "HuberLoss", "DistanceGradientLoss",
    "WeightedDistanceGradientLoss", "WeightedVectorFieldLoss",
    "TemporalConsistencyLoss", "BCEDiceTemporalLoss", "BCELoss",
    "get_head_loss", "get_loss", "LOSS_REGISTRY", "HEAD_LOSS_REGISTRY",
    "HEAD_LOSS_REGISTRY_3D",
]

# ---------------------------------------------------------------------------
# functional core (losses.py:49-243)
# ---------------------------------------------------------------------------


def _as_probs(x, from_logits: bool):
    return torch.sigmoid(x) if from_logits else x


def _clip(x, lo: float, hi: float):
    """``jnp.clip``'s values and gradient: an input exactly on a bound gets
    half the gradient, as JAX's max/min split a tie (``torch.clamp`` passes
    it whole), and a saturated sigmoid lands on 1 − 1e-7 often enough to
    matter."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def bce_loss(inputs, targets, from_logits: bool = True, eps: float = 1e-7):
    """Mean binary cross-entropy; ``from_logits=True`` is the stable
    BCE-with-logits form ``max(x, 0) − x·t + log1p(exp(−|x|))``
    (``losses.py:53``)."""
    if from_logits:
        loss = (torch.clamp(inputs, min=0) - inputs * targets
                + torch.log1p(torch.exp(-torch.abs(inputs))))
    else:
        p = _clip(inputs, eps, 1.0 - eps)
        loss = -(targets * torch.log(p) + (1.0 - targets) * torch.log(1.0 - p))
    return torch.mean(loss)


def weighted_bce_loss(logits, targets, alpha: float = 1.0, beta: float = 0.1):
    """Per-pixel weighted BCE: ``alpha`` where target ≥ 0.5, else ``beta``
    (``losses.py:70``)."""
    probs = _clip(torch.sigmoid(logits), 1e-7, 1.0 - 1e-7)
    pixel_bce = -(targets * torch.log(probs) + (1.0 - targets) * torch.log(1.0 - probs))
    weights = torch.where(targets >= 0.5, alpha, beta)
    return torch.mean(pixel_bce * weights)


def soft_dice_loss(inputs, targets, smooth: float = 1.0, from_logits: bool = True,
                   per_sample: bool = True):
    """Soft Dice loss (``losses.py:79``).  ``per_sample=True``: per batch row
    ``2·(intersection + smooth) / (Σm1 + Σm2 + smooth)``, smooth inside the
    ×2; ``per_sample=False``: the global ``(2·I + smooth) / (Σ + smooth)``."""
    probs = _as_probs(inputs, from_logits)
    if per_sample:
        n = probs.shape[0]
        m1 = probs.reshape(n, -1)
        m2 = targets.reshape(n, -1)
        intersection = torch.sum(m1 * m2, dim=1)
        score = 2.0 * (intersection + smooth) / (torch.sum(m1, 1) + torch.sum(m2, 1) + smooth)
        return 1.0 - torch.mean(score)
    intersection = torch.sum(probs * targets)
    dice = (2.0 * intersection + smooth) / (torch.sum(probs) + torch.sum(targets) + smooth)
    return 1.0 - dice


def bce_dice_loss(inputs, targets, alpha: float = 1.0, beta: float = 1.0,
                  from_logits: bool = True, smooth: float = 1.0, per_sample: bool = True):
    """``alpha``·BCE + ``beta``·Dice (``losses.py:102``)."""
    return alpha * bce_loss(inputs, targets, from_logits) + beta * soft_dice_loss(
        inputs, targets, smooth=smooth, from_logits=from_logits, per_sample=per_sample)


def logcosh_dice_loss(inputs, targets, from_logits: bool = True):
    """log((eˣ + e⁻ˣ)/2) of the soft-Dice loss (``losses.py:116``)."""
    x = soft_dice_loss(inputs, targets, from_logits=from_logits)
    return torch.log((torch.exp(x) + torch.exp(-x)) / 2.0)


def tversky_loss(inputs, targets, alpha: float = 0.5, beta: float = 0.5,
                 smooth: float = 1.0, from_logits: bool = True):
    """1 − Tversky with FP weight ``alpha``, FN weight ``beta``
    (``losses.py:122``)."""
    probs = _as_probs(inputs, from_logits).reshape(-1)
    t = targets.reshape(-1)
    tp = torch.sum(probs * t)
    fp = torch.sum((1.0 - t) * probs)
    fn = torch.sum(t * (1.0 - probs))
    return 1.0 - (tp + smooth) / (tp + alpha * fp + beta * fn + smooth)


def logcosh_tversky_loss(inputs, targets, alpha: float = 0.5, beta: float = 0.5,
                         smooth: float = 1.0, from_logits: bool = True):
    """log(cosh(1 − Tversky)) (``losses.py:136``)."""
    return torch.log(torch.cosh(tversky_loss(inputs, targets, alpha, beta, smooth,
                                             from_logits)))


# --- regression ---------------------------------------------------------------


def mse_loss(inputs, targets):
    return torch.mean((inputs - targets) ** 2)


def mae_loss(inputs, targets):
    return torch.mean(torch.abs(inputs - targets))


def huber_loss(inputs, targets, delta: float = 1.0):
    diff = torch.abs(inputs - targets)
    return torch.mean(torch.where(diff < delta, 0.5 * diff ** 2, delta * (diff - 0.5 * delta)))


def smooth_l1_loss(inputs, targets, beta: float = 1.0):
    """torch ``nn.SmoothL1Loss`` semantics (``losses.py:164``)."""
    diff = torch.abs(inputs - targets)
    return torch.mean(torch.where(diff < beta, 0.5 * diff ** 2 / beta, diff - 0.5 * beta))


# --- structural (spatial-derivative) losses -------------------------------------


def gradient_loss(pred, target, axes: Tuple[int, int] = (-2, -1)):
    """MSE between spatial derivatives (central differences, one-sided at the
    edges: ``torch.gradient`` = ``jnp.gradient``) of pred and target
    (``losses.py:180``); default axes are NCHW's (H, W)."""
    (dy_t, dx_t) = (torch.gradient(target, dim=ax)[0] for ax in axes)
    (dy_p, dx_p) = (torch.gradient(pred, dim=ax)[0] for ax in axes)
    return torch.mean((dy_p - dy_t) ** 2) + torch.mean((dx_p - dx_t) ** 2)


def distance_gradient_loss(pred, target, alpha: float = 1.0, axes=(-2, -1)):
    """MSE + α·gradient loss (``losses.py:189``)."""
    return mse_loss(pred, target) + alpha * gradient_loss(pred, target, axes)


def weighted_distance_gradient_loss(pred, target, alpha: float = 1.0, beta: float = 0.5,
                                    axes=(-2, -1)):
    """Foreground-weighted MSE + MAE + α·gradient loss (``losses.py:194``)."""
    weights = torch.where(target > 0, beta, 1.0 - beta)
    pw, tw = pred * weights, target * weights
    distance = torch.mean((pw - tw) ** 2) + torch.mean(torch.abs(pw - tw))
    return distance + alpha * gradient_loss(pw, tw, axes)


def weighted_vector_field_loss(pred_vectors, true_vectors, beta: float = 0.5,
                               magnitude_weight: float = 0.3, channel_axis: int = 1):
    """Masked MSE + MAE + magnitude MSE for 2-component orientation fields
    (``losses.py:204``); channels on axis 1, the reference's (B, 2, H, W)."""
    u = torch.select(true_vectors, channel_axis, 0)
    v = torch.select(true_vectors, channel_axis, 1)
    mask = ~((u == 0) & (v == 0))
    weights = torch.where(mask, beta, 1.0 - beta)
    w_full = weights.unsqueeze(channel_axis)
    mse = torch.mean((pred_vectors * w_full - true_vectors * w_full) ** 2)
    mae = torch.mean(torch.abs(pred_vectors * w_full - true_vectors * w_full))
    pred_mag = torch.sum(pred_vectors ** 2, dim=channel_axis)
    true_mag = torch.sum(true_vectors ** 2, dim=channel_axis)
    magnitude = torch.mean((pred_mag * weights - true_mag * weights) ** 2)
    return mse + mae + magnitude_weight * magnitude


# --- temporal -------------------------------------------------------------------


def temporal_consistency_loss(predictions, time_axis: int = 2):
    """Mean L1 between consecutive frames along ``time_axis``
    (``losses.py:225``); default: Z of (B, C, Z, X, Y)."""
    n = predictions.shape[time_axis]
    a = predictions.narrow(time_axis, 1, n - 1)
    b = predictions.narrow(time_axis, 0, n - 1)
    return torch.mean(torch.abs(a - b))


def bce_dice_temporal_loss(predictions, targets, loss_params=(1.0, 0.1),
                           from_logits: bool = True, time_axis: int = 2):
    """BCEDice(1, 1) + λ·temporal consistency (``losses.py:235``)."""
    seg = bce_dice_loss(predictions, targets, 1.0, 1.0, from_logits=from_logits)
    return loss_params[0] * seg + loss_params[1] * temporal_consistency_loss(predictions,
                                                                             time_axis)


# ---------------------------------------------------------------------------
# class wrappers (losses.py:249-416)
# ---------------------------------------------------------------------------


class _Loss:
    def __repr__(self):
        return f"{type(self).__name__}({self.__dict__})"


class BCELoss2d(_Loss):
    def __init__(self, from_logits: bool = True):
        self.from_logits = from_logits

    def __call__(self, inputs, targets):
        return bce_loss(inputs, targets, self.from_logits)


BCELoss = BCELoss2d


class SoftDiceLoss(_Loss):
    def __init__(self, smooth: float = 1.0, from_logits: bool = True):
        self.smooth, self.from_logits = smooth, from_logits

    def __call__(self, inputs, targets):
        return soft_dice_loss(inputs, targets, self.smooth, self.from_logits)


class BCEDiceLoss(_Loss):
    """Logits-space α·BCE + β·Dice, per-sample Dice."""

    def __init__(self, alpha: float = 1.0, beta: float = 1.0):
        self.alpha, self.beta = alpha, beta

    def __call__(self, inputs, targets):
        return bce_dice_loss(inputs, targets, self.alpha, self.beta, from_logits=True)


class BCEDiceLossProb(_Loss):
    """Probability-space BCE + Dice, global Dice, smooth 1e-5."""

    def __init__(self, bce_weight: float = 0.5, dice_weight: float = 0.5):
        self.bce_weight, self.dice_weight = bce_weight, dice_weight

    def __call__(self, inputs, targets):
        return bce_dice_loss(inputs, targets, self.bce_weight, self.dice_weight,
                             from_logits=False, smooth=1e-5, per_sample=False)


class BCEDiceLossProb3D(_Loss):
    """Probability-space BCE + Dice of the 3D multi-output family: per-sample
    Dice, smooth 1.0."""

    def __init__(self, alpha: float = 1.0, beta: float = 1.0):
        self.alpha, self.beta = alpha, beta

    def __call__(self, inputs, targets):
        return bce_dice_loss(inputs, targets, self.alpha, self.beta,
                             from_logits=False, smooth=1.0, per_sample=True)


class logcoshDiceLoss(_Loss):
    def __init__(self, from_logits: bool = True):
        self.from_logits = from_logits

    def __call__(self, inputs, targets):
        return logcosh_dice_loss(inputs, targets, self.from_logits)


class TverskyLoss(_Loss):
    def __init__(self, alpha: float = 0.5, beta: float = 0.5, smooth: float = 1.0,
                 from_logits: bool = True):
        self.alpha, self.beta, self.smooth, self.from_logits = alpha, beta, smooth, from_logits

    def __call__(self, inputs, targets):
        return tversky_loss(inputs, targets, self.alpha, self.beta, self.smooth,
                            self.from_logits)


class logcoshTverskyLoss(_Loss):
    def __init__(self, alpha: float = 0.5, beta: float = 0.5, smooth: float = 1.0,
                 from_logits: bool = True):
        self.alpha, self.beta, self.smooth, self.from_logits = alpha, beta, smooth, from_logits

    def __call__(self, inputs, targets):
        return logcosh_tversky_loss(inputs, targets, self.alpha, self.beta, self.smooth,
                                    self.from_logits)


class weightedBCELoss(_Loss):
    def __init__(self, alpha: float = 1.0, beta: float = 0.1):
        self.alpha, self.beta = alpha, beta

    def __call__(self, logits, targets):
        return weighted_bce_loss(logits, targets, self.alpha, self.beta)


class MSELoss(_Loss):
    def __call__(self, inputs, targets):
        return mse_loss(inputs, targets)


class MAELoss(_Loss):
    def __call__(self, inputs, targets):
        return mae_loss(inputs, targets)


class HuberLoss(_Loss):
    def __init__(self, delta: float = 1.0):
        self.delta = delta

    def __call__(self, inputs, targets):
        return huber_loss(inputs, targets, self.delta)


class DistanceGradientLoss(_Loss):
    def __init__(self, alpha: float = 1.0):
        self.alpha = alpha

    def __call__(self, pred, target):
        return distance_gradient_loss(pred, target, self.alpha)


class WeightedDistanceGradientLoss(_Loss):
    def __init__(self, alpha: float = 1.0, beta: float = 0.5):
        self.alpha, self.beta = alpha, beta

    def __call__(self, pred, target):
        return weighted_distance_gradient_loss(pred, target, self.alpha, self.beta)


class WeightedVectorFieldLoss(_Loss):
    def __init__(self, beta: float = 0.5, magnitude_weight: float = 0.3):
        self.beta, self.magnitude_weight = beta, magnitude_weight

    def __call__(self, pred, target):
        return weighted_vector_field_loss(pred, target, self.beta, self.magnitude_weight)


class TemporalConsistencyLoss(_Loss):
    def __init__(self, time_axis: int = 2):
        self.time_axis = time_axis

    def __call__(self, predictions):
        return temporal_consistency_loss(predictions, self.time_axis)


class BCEDiceTemporalLoss(_Loss):
    def __init__(self, loss_params=(1.0, 0.1), from_logits: bool = True):
        self.loss_params, self.from_logits = tuple(loss_params), from_logits

    def __call__(self, predictions, targets):
        return bce_dice_temporal_loss(predictions, targets, self.loss_params,
                                      self.from_logits)


# registry of the Trainer's string-based loss selection (losses.py:418)
LOSS_REGISTRY = {
    "BCE": BCELoss2d,
    "BCEDice": BCEDiceLoss,
    "BCEDiceProb": BCEDiceLossProb,
    "Dice": SoftDiceLoss,
    "logcoshDice": logcoshDiceLoss,
    "Tversky": TverskyLoss,
    "logcoshTversky": logcoshTverskyLoss,
    "weightedBCE": weightedBCELoss,
    "MSE": MSELoss,
    "MAE": MAELoss,
    "Huber": HuberLoss,
    "DistanceGradient": DistanceGradientLoss,
    "WeightedDistanceGradient": WeightedDistanceGradientLoss,
    "WeightedVectorField": WeightedVectorFieldLoss,
    "BCEDiceTemporal": BCEDiceTemporalLoss,
}

# per-head loss names of ``output_heads`` configs, all in probability space
# (losses.py:440)
HEAD_LOSS_REGISTRY = {
    "BCEDiceLoss": lambda: BCEDiceLossProb(),
    "DiceLoss": lambda: BCEDiceLossProb(bce_weight=0, dice_weight=1),
    "TverskyLoss": lambda: TverskyLoss(from_logits=False),
    "logcoshTverskyLoss": lambda: logcoshTverskyLoss(from_logits=False),
    "MSELoss": MSELoss,
    "MAELoss": MAELoss,
    "HuberLoss": HuberLoss,
    "DistanceGradientLoss": DistanceGradientLoss,
    "WeightedDistanceGradientLoss": WeightedDistanceGradientLoss,
    "WeightedVectorFieldLoss": WeightedVectorFieldLoss,
    "BCEDiceTemporalLoss": lambda: BCEDiceTemporalLoss(from_logits=False),
}

# the 3D multi-output family's parameterization (losses.py:460)
HEAD_LOSS_REGISTRY_3D = {
    **HEAD_LOSS_REGISTRY,
    "BCEDiceLoss": lambda: BCEDiceLossProb3D(),
    "DiceLoss": lambda: BCEDiceLossProb3D(alpha=0.0, beta=1.0),
}


def get_head_loss(name: str, family: str = "2d"):
    """A per-head loss by its ``output_heads`` config name (``losses.py:467``)."""
    if callable(name) and not isinstance(name, str):
        return name
    registry = HEAD_LOSS_REGISTRY_3D if family == "3d" else HEAD_LOSS_REGISTRY
    if name not in registry:
        raise ValueError(f'Loss "{name}" not defined! Available: {sorted(registry)}')
    return registry[name]()


def get_loss(name: str, **kwargs):
    """A loss by registry name (``losses.py:479``)."""
    if callable(name) and not isinstance(name, str):
        return name
    if name not in LOSS_REGISTRY:
        raise ValueError(f"unknown loss '{name}'; available: {sorted(LOSS_REGISTRY)}")
    return LOSS_REGISTRY[name](**kwargs)
