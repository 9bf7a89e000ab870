"""The generic Trainer (counterpart of ``bio_image_unet_tpu/train/trainer.py:114
Trainer``) for the 2D ``Unet`` and ``AttentionUnet``, the legacy ``Unet_v0``
and ``BabyUnet``, the siamese ``Siam_UNet`` (``mode=``), the multi-output
family (``MultiOutputUnet``, ``MultiOutputNestedUNet``,
``MultiOutputNestedUNet_3Levels``) and the 3D networks (``UNet3D``,
``MultiOutputUnet3D``).

What it keeps of the JAX Trainer, so that one seed and one set of initial
weights give the same ``metrics.csv`` rows:

- the split and batch order: ``random_split``/``DataLoader`` with
  ``np.random.default_rng`` (``trainer.py:249-255``), and with
  ``device_cache`` the ``seed + 1`` permutation per epoch (``:627-632``);
- the loss: per-channel ``criterion(logits[:, ch], mask[:, ch])`` weighted by
  ``channel_weights`` (``:460-467``); with heads (``output_heads``, or the
  model's default single sigmoid head, ``:208-221``) the weighted sum of
  each head's loss (``get_head_loss``, ``:229-243``; the 3D head family for a
  ``MultiOutputUnet3D``, chosen by the built model's class), with deep
  supervision over every level's output weighted [0.5, 0.75, 1.0] or
  [0.5, 0.75, 0.875, 1.0] in training and on the deepest output in
  validation (``:436-458``); ``time_loss_weight`` adds SmoothL1 between
  batch-adjacent logits of a single-output model, skipped at batch 1
  (``:468-472``);
- the 3D input: a sample's ``volume`` if it has one, else its ``image``
  (``:288``); ``use_interpolation`` goes to the model (``:204``) and, with
  ``time_loss_weight``, into the checkpoint (``:341-348``);
- the siamese pairs (``mode``, ``:290-291, 341-342, 431-433, 496-502``): the
  model takes ``(image, prev_image)`` in training and validation, the
  device cache holds the prev tiles too, K4's pair form augments image and
  prev with one draw, and the checkpoint records ``mode``; the twin encoder
  runs cur first, then prev, so the BatchNorm running statistics update in
  flax's order;
- Adam (``torch.optim.Adam``, the optax Adam of ``:275-280``; ``grad_clip``
  through ``clip_grad_norm_``) and the torch-semantics ``ReduceLROnPlateau``
  (``:76``) stepped on the validation loss after every epoch, the train loss
  standing in when there is no validation batch (``:784-789``);
- ``metrics.csv`` (``:365-371, 798-801``), the best-validation save, the
  ``save_iter`` saves, the emergency checkpoint on an interrupt (``:759-771``),
  ``start(test_data_path=...)`` through the port's ``Predict``, and the
  TensorBoard scalars ``Loss/train``/``Loss/val`` and validation image grids
  (``tensorboard``, ``log_images``: ``:357-364, 689-734, 802-804``; a volume's
  grid shows its middle z slice; the grids need matplotlib and are skipped
  quietly without it, as in JAX).

How it runs on the card: an eager PyTorch step (autograd through cuDNN and
PyTorch ops stands in for XLA's autodiff; the JAX package has no hand-written
backward).  ``half_precision`` runs the convs in bf16 with float32
parameters, BatchNorm, heads and logits (``models.*(dtype=...)``); an
``AttentionUnet``'s gates compute in float32, as flax promotes them; the
legacy models train in float32 whatever ``half_precision`` says, as in JAX.
Their bottleneck's channel dropout draws from a ``torch.Generator`` of the
Trainer seeded from (seed, epoch) (Philox on the card; the draws differ from
JAX's threefry ones, as every random draw of the port does).
``device_cache`` keeps the training tiles on the card, the head targets
concatenated along channels into one tensor (``HeadLayout``), and takes one
index row per step; ``device_augment`` draws on a ``torch.Generator`` and
gathers and augments each batch in one launch: K4 for a single target, K4h
for heads, orientation heads (names containing ``"orientation"``) rotated
with the tile, and K4v / K4hv for volumes (``data/augment_device.py``).  On
the card, weights and activations are channels-last (``channels_last_3d``
for the 3D networks).  The ``corr`` join's forward and backward are K6 and
K6b (``ops/functional.py``).

Checkpoints are reference-schema ``.pt`` files (``checkpoint.save``) that
both packages' ``Predict``/``PredictMultiOutput`` read (with heads they carry
``output_heads`` and ``deep_supervision``, ``:349-354``).  One divergence:
``epoch`` in every checkpoint is the number of epochs completed, the epoch a
resume continues from (the JAX package stores that only in its emergency
checkpoint and the finished epoch's index elsewhere).  A resume restores
weights, BatchNorm statistics, Adam and scheduler state and best loss, and
advances the shuffle streams past the completed epochs, so one epoch, a
resume and one more equal two epochs straight.

Runs on CUDA unless ``device="cpu"`` is passed (``"auto"`` means CUDA);
raises without a card.  Not ported yet, each raising NotImplementedError:
``mesh`` and ``device_cache="sharded"`` (multi-GPU), ``remat``, ``profile_dir``.
"""

from __future__ import annotations

import csv
import glob
import os
import time
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import checkpoint
from ..data import tiff
from ..data.augment_device import (HeadLayout, augment_batch, augment_batch_heads,
                                   orientation_keys)
from ..data.pipelines import DataLoader, random_split
from ..losses import get_head_loss, get_loss, smooth_l1_loss
from ..models import MODEL_REGISTRY, MultiOutputUnet3D, get_model
from ..models.legacy import ChannelDropout2d
from ..ops.blocks import init_weights_
from ..utils.device import resolve_device

__all__ = ["ReduceLROnPlateau", "Trainer"]


def _model_name(model) -> str:
    """The registry name of ``model``'s class (``trainer.py:69-73``)."""
    for name, cls in MODEL_REGISTRY.items():
        if type(model) is cls:
            return name
    return type(model).__name__


class ReduceLROnPlateau:
    """torch ``ReduceLROnPlateau(mode='min')`` semantics with its relative
    threshold 1e-4 (``trainer.py:76``).  Its state (``best``, ``num_bad``,
    ``scale``) is the ``scheduler_state`` of the checkpoints."""

    def __init__(self, factor=0.1, patience=4, min_lr=0.0,
                 threshold=1e-4, threshold_mode="rel"):
        if threshold_mode not in ("rel", "abs"):
            raise ValueError(f"threshold_mode {threshold_mode!r} not in ('rel', 'abs')")
        self.factor, self.patience, self.min_lr = factor, patience, min_lr
        self.threshold, self.threshold_mode = threshold, threshold_mode
        self.best = float("inf")
        self.num_bad = 0
        self.scale = 1.0

    def _is_better(self, metric: float) -> bool:
        if self.best == float("inf"):
            return True
        if self.threshold_mode == "rel":
            return metric < self.best * (1.0 - self.threshold)
        return metric < self.best - self.threshold

    def step(self, metric: float) -> float:
        if self._is_better(metric):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.scale = max(self.scale * self.factor, self.min_lr)
                self.num_bad = 0
        return self.scale

    def state(self) -> Dict[str, float]:
        return {"best": self.best, "num_bad": self.num_bad, "scale": self.scale}

    def load(self, state: Dict[str, float]) -> None:
        self.best = float(state["best"])
        self.num_bad = int(state["num_bad"])
        self.scale = float(state["scale"])


def _not_ported(what: str, slice_name: str):
    raise NotImplementedError(f"{what} is not ported to PyTorch yet (the {slice_name} "
                              "slice of the port); single-device training of every model is")


class Trainer:
    """``Trainer(dataset, num_epochs, ...).start()`` for the 2D ``Unet``,
    ``AttentionUnet``, ``Unet_v0`` and ``BabyUnet``, the siamese
    ``Siam_UNet``, the multi-output family and the 3D networks; the
    dataset yields ``{'image': (C, H, W), 'mask': (C', H, W)}`` float32
    numpy items (``DataProcess2D``), with ``mode`` also ``'prev_image': (C,
    H, W)`` (``DataProcessSiam``), or, with heads, ``{'image': ..., <head>:
    (C_head, H, W), ...}`` (``DataProcessMultiOutput``); for the 3D networks
    the same with (C, Z, X, Y) arrays, the input under ``volume`` or
    ``image`` (``DataProcess3D``, ``DataProcessMultiOutput3D``)."""

    def __init__(
        self,
        dataset,
        num_epochs: int,
        network: Union[str, type] = "Unet",
        batch_size: int = 4,
        lr: float = 1e-3,
        in_channels: int = 1,
        out_channels: int = 1,
        channel_weights: Optional[Sequence[float]] = None,
        n_filter: int = 64,
        dilation: Union[int, bool, Sequence[int]] = 1,
        val_split: float = 0.2,
        save_dir: str = "./",
        save_name: str = "model.pt",
        save_iter: bool = False,
        load_weights: Union[bool, str, None] = False,
        loss_function: str = "BCEDice",
        loss_params: Tuple[float, float] = (0.5, 0.5),
        mode: Optional[str] = None,
        use_interpolation: bool = False,
        time_loss_weight: Optional[float] = None,
        output_heads: Optional[Dict[str, dict]] = None,
        deep_supervision: bool = False,
        levels: int = 4,
        grad_clip: Optional[float] = None,
        scheduler_patience: int = 4,
        scheduler_factor: float = 0.1,
        mesh=None,
        seed: int = 0,
        half_precision: bool = False,
        remat: bool = False,
        device_cache: Union[bool, str] = False,
        device_augment: bool = False,
        tensorboard: bool = False,
        log_images: bool = False,
        profile_dir: Optional[str] = None,
        device=None,
    ):
        if mesh is not None or device_cache == "sharded":
            _not_ported("mesh=/device_cache='sharded' (multi-GPU training)", "multi-GPU")
        if remat:
            _not_ported("remat=True (activation checkpointing)", "trainer-options")
        if profile_dir:
            _not_ported("profile_dir= (a profiler trace per run)", "trainer-observability")
        self.device = resolve_device(None if device == "auto" else device)
        self.num_epochs = num_epochs
        self.batch_size = batch_size
        self.lr = lr
        self.out_channels = out_channels
        self.loss_function = loss_function
        self.loss_params = tuple(loss_params)
        self.save_dir = save_dir
        self.save_name = save_name
        self.save_iter = save_iter
        self.device_augment = device_augment
        self.grad_clip = grad_clip
        self.deep_supervision = deep_supervision
        self.time_loss_weight = time_loss_weight
        self.log_images = log_images
        self.seed = seed
        self.mode = mode
        self.best_loss = float("inf")
        self.epoch_start = 0
        # one dict per epoch run: the metrics.csv row plus the training
        # pass's own wall time (``train_seconds``, validation excluded)
        self.history = []
        os.makedirs(save_dir, exist_ok=True)

        # --- model: seeded init, float32 parameters ---
        self.model = get_model(network, n_filter=n_filter, in_channels=in_channels,
                               out_channels=out_channels, dilation=dilation, mode=mode,
                               use_interpolation=use_interpolation, output_heads=output_heads,
                               deep_supervision=deep_supervision,
                               dtype=torch.bfloat16 if half_precision else None)
        if mode is not None and getattr(self.model, "mode", None) != mode:
            raise ValueError(f"mode={mode!r} needs a network with a siamese join (Siam_UNet, "
                             f"Unet), got {network!r}")
        init_weights_(self.model, torch.Generator().manual_seed(seed))
        self.multi_output = output_heads is not None or bool(getattr(self.model, "heads", None))
        # the deep-supervision weights follow the model's grid depth (:214)
        self.levels = getattr(self.model, "levels", levels)
        if deep_supervision and not hasattr(self.model, "levels"):
            raise ValueError(f"deep_supervision needs a UNet++ network, got {network!r}")
        self.output_heads = output_heads
        if self.multi_output:
            if self.output_heads is None:
                # the model's default single sigmoid head with BCEDice (:215-221)
                self.output_heads = {name: {"loss": "BCEDiceLoss", **dict(cfg)}
                                     for name, cfg in self.model.heads.items()}
            # the 3D multi-output losses are parameterized otherwise (:230-235)
            family = "3d" if isinstance(self.model, MultiOutputUnet3D) else "2d"
            self.head_losses = {name: get_head_loss(cfg["loss"], family=family)
                                for name, cfg in self.output_heads.items()}
            self.head_weights = {name: cfg.get("weight", 1.0)
                                 for name, cfg in self.output_heads.items()}
            self.criterion = None
        else:
            self.criterion = get_loss(loss_function, **self._loss_kwargs())
        self.channel_weights = torch.as_tensor(
            np.ones(out_channels, np.float32) if channel_weights is None
            else np.asarray(channel_weights, np.float32))

        # --- data: the input key, the targets' layout in one
        # channel-concatenated tensor ---
        sample = dataset[0]
        self.input_key = "volume" if "volume" in sample else "image"
        # the model's inputs: the frame, and with a join its previous frame
        self.input_keys = [self.input_key] + (["prev_image"] if mode is not None else [])
        if any(k not in sample for k in self.input_keys):
            raise ValueError(f"mode={mode!r} trains on (image, prev_image) pairs: the dataset's "
                             f"items hold {sorted(sample)} (DataProcessSiam makes pairs)")
        keys = list(self.output_heads) if self.multi_output else ["mask"]
        self.layout = HeadLayout.of({k: sample[k].shape[0] for k in keys},
                                    orientation_keys(keys), self.device)
        train_data, val_data = random_split(dataset, val_split, seed=seed)
        self.train_loader = DataLoader(train_data, batch_size, shuffle=True,
                                       drop_last=True, seed=seed)
        self.val_loader = DataLoader(val_data, batch_size, shuffle=False, drop_last=False)

        # --- init / resume ---
        load_path = None
        if load_weights:
            load_path = load_weights if isinstance(load_weights, str) else os.path.join(
                save_dir, save_name)
            state = checkpoint.load(load_path)
            self.model.load_state_dict(state["state_dict"], strict=True)
        self.model.to(self.device)
        self.volumetric = any(p.dim() == 5 for p in self.model.parameters())
        if self.device.type == "cuda":
            self.model.to(memory_format=self._memory_format())
        self.channel_weights = self.channel_weights.to(self.device)
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=lr)
        self.scheduler = ReduceLROnPlateau(scheduler_factor, scheduler_patience)
        if load_path is not None:
            if state["optimizer_state_dict"] is not None:
                self.optimizer.load_state_dict(state["optimizer_state_dict"])
            if state["epoch"] is not None:
                self.epoch_start = int(state["epoch"])
            if state["best_loss"] is not None:
                self.best_loss = float(state["best_loss"])
            sched = state["hyperparams"].get("scheduler_state")
            if sched:
                self.scheduler.load(sched)

        # --- self-describing checkpoint hyperparams (trainer.py:324-354) ---
        self.params_meta = {
            "model_name": _model_name(self.model), "lr": lr, "loss_function": loss_function,
            "loss_params": self.loss_params, "n_filter": n_filter, "dilation": dilation,
            "batch_size": batch_size, "in_channels": in_channels,
            "out_channels": out_channels,
        }
        for attr in ("aug_factor", "clip_threshold", "noise_lims", "noise_amp",
                     "brightness_contrast", "shiftscalerotate", "gauss_noise_lims",
                     "shot_noise_lims", "random_rotate"):
            if hasattr(dataset, attr):
                key = "augmentation" if attr == "aug_factor" else attr
                self.params_meta[key] = getattr(dataset, attr)
        if mode is not None:
            self.params_meta["mode"] = mode
        if time_loss_weight is not None:
            self.params_meta["time_loss_weight"] = time_loss_weight
        self.params_meta["use_interpolation"] = use_interpolation
        if self.multi_output:
            # the resolved heads: PredictMultiOutput rebuilds the model from them
            self.params_meta["output_heads"] = self.output_heads
            self.params_meta["deep_supervision"] = deep_supervision

        # --- observability ---
        self.writer = None
        if tensorboard:
            from ..utils.tboard import SummaryWriter

            self.writer = SummaryWriter(log_dir=os.path.join(save_dir, "logs"))
        self.metrics_path = os.path.join(save_dir, "metrics.csv")
        if not load_weights or not os.path.exists(self.metrics_path):
            with open(self.metrics_path, "w", newline="") as fh:
                csv.writer(fh).writerow(["epoch", "train_loss", "val_loss", "lr", "seconds"])

        # --- shuffle streams, advanced past the epochs a resume skips ---
        self.train_loader.skip_epochs(self.epoch_start)
        self._device_data = None
        if device_cache:
            # the training tiles live on the card, the targets concatenated
            # along channels; one index row per step
            self._train_rng = np.random.default_rng(seed + 1)
            samples = [train_data[i] for i in range(len(train_data))]
            self._n_train = len(samples)
            for _ in range(self.epoch_start):
                self._train_rng.permutation(self._n_train)
            # (input, targets[, prev])
            groups = [[self.input_key], self.layout.names] + [[k] for k in self.input_keys[1:]]
            self._device_data = tuple(
                torch.from_numpy(np.concatenate([np.stack([s_[k] for s_ in samples])
                                                 for k in ks], 1)).to(self.device)
                for ks in groups)

    def _loss_kwargs(self):
        if self.loss_function in ("BCEDice", "Tversky", "logcoshTversky", "weightedBCE"):
            return {"alpha": self.loss_params[0], "beta": self.loss_params[1]}
        return {}

    # ------------------------------------------------------------------
    # steps
    # ------------------------------------------------------------------

    def _compute_loss(self, outputs, batch: Dict[str, torch.Tensor], train: bool) -> torch.Tensor:
        """The loss of one batch (``trainer.py:436-473``): ``batch`` maps each
        target name to its (B, C, H, W) or (B, C, Z, X, Y) tensor."""
        if self.multi_output:
            total = 0.0
            if self.deep_supervision and train:
                if self.levels == 3:
                    sup_w = [0.5, 0.75, 1.0]
                elif self.levels == 4:
                    sup_w = [0.5, 0.75, 0.875, 1.0]
                else:
                    raise ValueError(f"N = {self.levels} levels not valid. Choose N=3 or N=4.")
                for name in self.output_heads:
                    for level, w in enumerate(sup_w, 1):
                        total += w * self.head_weights[name] * self.head_losses[name](
                            outputs[f"{name}_{level}"], batch[name])
            else:
                for name in self.output_heads:
                    total += self.head_weights[name] * self.head_losses[name](
                        outputs[name], batch[name])
            return total
        _, logits = outputs
        target, w = batch["mask"], self.channel_weights
        total = sum(self.criterion(logits[:, ch], target[:, ch]) * w[ch]
                    for ch in range(self.out_channels))
        loss = total / torch.sum(w)
        if self.time_loss_weight is not None and logits.shape[0] > 1:
            # SmoothL1 between batch-adjacent logits; a batch of one has no pair
            loss = loss + self.time_loss_weight * smooth_l1_loss(logits[1:], logits[:-1])
        return loss

    def _memory_format(self) -> torch.memory_format:
        return torch.channels_last_3d if self.volumetric else torch.channels_last

    def _input(self, x: torch.Tensor) -> torch.Tensor:
        if self.device.type == "cuda":
            return x.contiguous(memory_format=self._memory_format())
        return x

    def _forward(self, inputs: Sequence[torch.Tensor]):
        """The model on a batch's inputs: (image,), or (image, prev) with a
        join."""
        return self.model(*(self._input(x) for x in inputs))

    def _train_step(self, inputs: Sequence[torch.Tensor],
                    batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        outputs = self._forward(inputs)
        with torch.profiler.record_function("loss"):
            loss = self._compute_loss(outputs, batch, train=True)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if self.grad_clip is not None:
            torch.nn.utils.clip_grad_norm_(self.model.parameters(), self.grad_clip)
        self.optimizer.step()
        return loss.detach()

    def _augment_generator(self, epoch: int) -> torch.Generator:
        """The epoch's augmentation stream: seeded from (seed, epoch), so a
        resumed run draws what the uninterrupted run would have."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed * 1_000_003 + epoch)
        return gen

    def _seed_dropout(self, epoch: int) -> None:
        """Hand each ``ChannelDropout2d`` (the legacy models' bottleneck) the
        epoch's dropout stream: seeded from (seed, epoch) apart from the
        augmentation's, so a resumed run draws what the uninterrupted run
        would have."""
        drops = [m for m in self.model.modules() if isinstance(m, ChannelDropout2d)]
        if drops:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(self.seed * 1_000_003 + epoch + (1 << 40))
            for m in drops:
                m.generator = gen

    def _upload(self, batch: dict):
        """A loader batch on the device: the image, the targets concatenated
        along channels and, with a join, the prev image."""
        target = np.concatenate([batch[k] for k in self.layout.names], 1)
        return tuple(torch.from_numpy(a).to(self.device) for a in
                     [batch[self.input_key], target] + [batch[k] for k in self.input_keys[1:]])

    def _batches(self, epoch: int):
        """((image[, prev]), {target: tensor}) training batches of one epoch,
        on the device."""
        gen = self._augment_generator(epoch) if self.device_augment else None

        def augment(image, target, *prev, index=None):
            with torch.profiler.record_function("augment"):
                if self.multi_output:
                    image, targets = augment_batch_heads(gen, image, target, index=index,
                                                         layout=self.layout)
                    return (image,), targets
                if prev:  # K4's pair form: image and prev take one draw
                    image, mask, p = augment_batch(gen, image, target, index=index,
                                                   prev=prev[0])
                    return (image, p), {"mask": mask}
                image, mask = augment_batch(gen, image, target, index=index)
                return (image,), {"mask": mask}

        def plain(image, target, *prev, index=None):
            if index is not None:
                image, target, *prev = (t.index_select(0, index) for t in (image, target, *prev))
            return (image, *prev), self.layout.split(target)

        step = augment if gen is not None else plain
        if self._device_data is not None:
            n_steps = self._n_train // self.batch_size
            perm = self._train_rng.permutation(self._n_train)[: n_steps * self.batch_size]
            rows = torch.from_numpy(perm.reshape(n_steps, self.batch_size)).to(self.device)
            for idx in rows:
                yield step(*self._device_data, index=idx)
            return
        for batch in self.train_loader:
            yield step(*self._upload(batch))

    def _iterate_train(self, epoch: int) -> float:
        print(f"\nStarting training epoch {epoch} ...")
        self.model.train()
        self._seed_dropout(epoch)
        losses = [self._train_step(inputs, batch) for inputs, batch in self._batches(epoch)]
        if not losses:
            return float("nan")
        return float(torch.stack(losses).mean())

    @torch.no_grad()
    def _iterate_val(self, epoch: int) -> float:
        print(f"\nStarting validation epoch {epoch} ...")
        self.model.eval()
        losses, last = [], None
        for batch in self.val_loader:
            image, target, *prev = self._upload(batch)
            targets = self.layout.split(target)
            outputs = self._forward((image, *prev))
            losses.append(self._compute_loss(outputs, targets, train=False))
            last = (image, targets, outputs)
        if self.log_images and last is not None:
            self._plot_validation(epoch, *last)
        return float(torch.stack(losses).mean()) if losses else float("nan")

    def _plot_validation(self, epoch: int, image, targets, outputs) -> None:
        """Per-epoch validation image grids of the last batch's first sample
        (``trainer.py:689-734``); without matplotlib nothing is written."""
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except Exception:
            return
        out_dir = os.path.join(self.save_dir, "val_results")
        os.makedirs(out_dir, exist_ok=True)

        def first(t):  # channel 0 of the first sample (a volume's middle z), float32 numpy
            t = t[0, 0]
            return (t[t.shape[0] // 2] if t.dim() == 3 else t).float().cpu().numpy()

        if self.multi_output:
            names = list(self.output_heads)
            preds = {k: first(outputs[k]) for k in names}
        else:
            names = ["mask"]
            preds = {"mask": first(outputs[0])}
        fig, axes = plt.subplots(2, len(names) + 1, figsize=(3 * (len(names) + 1), 6))
        axes = np.atleast_2d(axes)
        for row in range(2):
            axes[row, 0].imshow(first(image), cmap="gray")
            axes[row, 0].set_title("Input" if row == 0 else "")
            axes[row, 0].axis("off")
        for i, name in enumerate(names):
            axes[0, i + 1].imshow(preds[name], cmap="viridis")
            axes[0, i + 1].set_title(f"{name} (Pred)")
            axes[0, i + 1].axis("off")
            axes[1, i + 1].imshow(first(targets[name]), cmap="viridis")
            axes[1, i + 1].set_title(f"{name} (True)")
            axes[1, i + 1].axis("off")
        fig.savefig(os.path.join(out_dir, f"epoch_{epoch}.png"), dpi=120)
        plt.close(fig)
        if self.writer is not None:
            self.writer.add_image(f"val/{names[0]}", preds[names[0]][None], epoch)

    # ------------------------------------------------------------------
    # epoch loop
    # ------------------------------------------------------------------

    def _save(self, path: str, epoch: int) -> None:
        meta = {**self.params_meta, "scheduler_state": self.scheduler.state()}
        checkpoint.save(path, self.model.state_dict(), meta, epoch=epoch,
                        best_loss=self.best_loss, optimizer_state=self.optimizer.state_dict())

    def start(self, test_data_path=None, result_path=None, test_resize_dim=(512, 512)):
        """Run training; optionally predict a folder of test tifs after each
        epoch.  Returns the best validation loss."""
        save_path = os.path.join(self.save_dir, self.save_name)
        self._epoch_reached = self.epoch_start
        try:
            self._run_epochs(save_path, test_data_path, result_path, test_resize_dim)
        except (KeyboardInterrupt, Exception):
            emergency = os.path.join(self.save_dir, "model_interrupted.pt")
            try:
                self._save(emergency, self._epoch_reached)
                print(f"\nInterrupted — state saved to {emergency}")
            except Exception as save_err:
                print(f"\nInterrupted — emergency checkpoint failed: {save_err}")
            raise
        finally:
            if self.writer is not None:
                self.writer.flush()
        return self.best_loss

    def _run_epochs(self, save_path, test_data_path, result_path, test_resize_dim):
        for epoch in range(self.epoch_start, self.epoch_start + self.num_epochs):
            t0 = time.time()
            train_loss = self._iterate_train(epoch)  # returns after the device is done
            train_seconds = time.time() - t0
            val_loss = self._iterate_val(epoch)
            if np.isnan(val_loss):
                val_loss = train_loss
            lr_scale = self.scheduler.step(val_loss)
            for group in self.optimizer.param_groups:
                group["lr"] = self.lr * lr_scale
            dt = time.time() - t0
            print(f"\nEpoch {epoch} completed in {dt:.2f} seconds "
                  f"(train {train_loss:.5f}, val {val_loss:.5f})")
            with open(self.metrics_path, "a", newline="") as fh:
                csv.writer(fh).writerow([epoch, train_loss, val_loss, self.lr * lr_scale,
                                         round(dt, 2)])
            if self.writer is not None:
                self.writer.add_scalar("Loss/train", train_loss, epoch)
                self.writer.add_scalar("Loss/val", val_loss, epoch)
            self.history.append({"epoch": epoch, "train_loss": train_loss,
                                 "val_loss": val_loss, "lr": self.lr * lr_scale,
                                 "seconds": dt, "train_seconds": train_seconds})
            self._epoch_reached = epoch + 1
            if val_loss < self.best_loss:
                print(f"\nValidation loss improved from {self.best_loss:.5f} "
                      f"to {val_loss:.5f} - saving model state")
                self.best_loss = val_loss
                self._save(save_path, epoch + 1)
            if self.save_iter:
                self._save(os.path.join(self.save_dir, f"model_epoch_{epoch}.pt"), epoch + 1)
            if test_data_path is not None:
                self._predict_test_folder(epoch, test_data_path, result_path, test_resize_dim)

    def _predict_test_folder(self, epoch, test_data_path, result_path, resize_dim):
        from ..predict import Predict

        print("\nPredicting test data...")
        ckpt = os.path.join(self.save_dir, f"model_epoch_{epoch}.pt")
        if not os.path.exists(ckpt):
            self._save(ckpt, epoch + 1)
        os.makedirs(result_path, exist_ok=True)
        for file in glob.glob(os.path.join(test_data_path, "*.tif")):
            Predict(tiff.imread(file),
                    os.path.join(result_path, os.path.basename(file) + f"epoch_{epoch}.tif"),
                    ckpt, resize_dim=resize_dim, show_progress=False, device=self.device)
