"""The 2D training-data pipeline and its loader (the port's copy of the 2D
part of ``bio_image_unet_tpu/data/pipelines.py``: helpers :54-183,
``DataProcess2D`` :191-352, ``Subset`` :971, ``random_split`` :983,
``DataLoader`` :993).

The on-disk layout, the tiling rule and the augmentation stream are the JAX
package's, so the same source TIFFs and seed give bit-equal tiles.  One
difference, the torch idiom: items are channels-first float32 numpy arrays,
``{'image': (C, H, W), 'mask': (C, H, W)}`` in [0, 1] (JAX: HWC), and the
loader stacks them to (B, C, H, W).  Shuffles keep ``np.random.default_rng``,
so a seed gives the JAX Trainer's split and batch order.
"""

from __future__ import annotations

import glob
import os
import queue
import shutil
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np

from . import morphology, tiff
from .augment import (Blur, Compose, MultiplicativeNoise, RandomBrightnessContrast,
                      RandomRotate90, ShiftScaleRotate)

__all__ = ["clip_and_normalize", "edit_mask", "tile_starts", "DataProcess2D", "Subset",
           "random_split", "DataLoader"]


def clip_and_normalize(img: np.ndarray, clip_threshold=(0.2, 99.8), scale=255.0):
    """Percentile clip + min-max normalize to [0, scale] (``pipelines.py:54``)."""
    img = img.astype(np.float32)
    img = np.clip(img, a_min=np.nanpercentile(img, clip_threshold[0]),
                  a_max=np.nanpercentile(img, clip_threshold[1]))
    lo, hi = np.nanmin(img), np.nanmax(img)
    if hi > lo:
        img = (img - lo) / (hi - lo) * scale
    else:
        img = np.zeros_like(img)
    return img


def edit_mask(mask: np.ndarray, skeletonize=False, dilate_mask=0,
              dilate_kernel="disk", invert=False) -> np.ndarray:
    """Per-slice mask editing (``pipelines.py:71``): positive ``dilate_mask``
    dilates, negative erodes."""
    if dilate_kernel == "disk":
        kernel = morphology.disk
    elif dilate_kernel == "square":
        kernel = morphology.square
    else:
        raise ValueError(f"Dilate kernel {dilate_kernel} unknown!")
    mask = np.asarray(mask)
    if skeletonize:
        mask = morphology.skeletonize(mask > 1).astype(np.uint8) * 255
    if dilate_mask > 0:
        mask = morphology.dilation(mask, kernel(dilate_mask))
    elif dilate_mask < 0:
        mask = morphology.erosion(mask, kernel(-dilate_mask))
    if invert:
        mask = 255 - mask
    return mask.astype(np.uint8)


def tile_starts(extent: int, tile: int, n_extra: int = 0) -> np.ndarray:
    """``ceil(extent/tile)`` patches (+``n_extra`` when > 1) at linspace
    starts (``pipelines.py:99``)."""
    n = int(np.ceil(extent / tile))
    n += n_extra if n > 1 else 0
    return np.linspace(0, extent - tile, n).astype(int)


def _tif_files(directory: str, exts=(".tif", ".tiff")) -> List[str]:
    if isinstance(exts, str):
        exts = (exts,)
    exts = tuple(e.lower() for e in exts)
    return [f for f in sorted(glob.glob(os.path.join(directory, "*")))
            if f.lower().endswith(exts) and not os.path.basename(f).startswith(".")]


def _fresh_dirs(base: str, subdirs: Sequence[str], wipe: bool) -> Dict[str, str]:
    if wipe and os.path.exists(base):
        shutil.rmtree(base, ignore_errors=True)
    paths = {}
    for sub in subdirs:
        p = os.path.join(base, sub)
        os.makedirs(p, exist_ok=True)
        paths[sub] = p
    return paths


class _TileDataset:
    """``__len__``/``__getitem__`` with a RAM tile cache (``pipelines.py:130``)."""

    def __init__(self, cache: bool = True):
        self._cache_enabled = cache
        self._cache: Dict[int, dict] = {}

    def _load_item(self, idx: int) -> dict:  # pragma: no cover - overridden
        raise NotImplementedError

    def __getitem__(self, idx: int) -> dict:
        if idx < 0:
            idx += len(self)
        if not 0 <= idx < len(self):
            raise IndexError(idx)
        if self._cache_enabled and idx in self._cache:
            return self._cache[idx]
        item = self._load_item(idx)
        if self._cache_enabled:
            self._cache[idx] = item
        return item


def _read_chw(path: str) -> np.ndarray:
    """An augmented tile, saved as (C, H, W) or (H, W), as float32 CHW in
    [0, 1] (``pipelines.py:167 _read_hwc``, channels first)."""
    arr = tiff.imread(path).astype(np.float32) / 255.0
    return arr[None] if arr.ndim == 2 else arr


def _read_split_chw(path: str) -> np.ndarray:
    """A split tile, saved as one (H, W[, C]) page, as float32 CHW in [0, 1]
    (``pipelines.py:175 _read_split_hwc``, channels first)."""
    return np.moveaxis(np.atleast_3d(tiff.imread(path).astype(np.float32) / 255.0), -1, 0)


class DataProcess2D(_TileDataset):
    """Disk-staged 2D training-data pipeline (``pipelines.py:191``; reference
    unet/data.py:15-266): preprocess and mask edit → merge (mask ‖ image
    channels) → reflect pad and linspace tiling → ``aug_factor`` augmented
    copies per tile, written under ``data_path`` (image/ mask/ merge/ split/
    augmentation/)."""

    def __init__(self, source_dir, dim_out=(256, 256), aug_factor=10,
                 data_path="../data/", in_channels=1, out_channels=1,
                 dilate_mask=0, dilate_kernel="disk", add_tile=0, val_split=0.2,
                 invert=False, skeletonize=False, clip_threshold=(0.2, 99.8),
                 shiftscalerotate=(0, 0, 0), noise_lims=(0.5, 1.2),
                 brightness_contrast=(0.25, 0.25), blur_limit=(3, 7),
                 create=True, cache=True, seed: Optional[int] = None):
        super().__init__(cache)
        self.source_dir = source_dir
        self.data_path = data_path
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.dim_out = tuple(dim_out)
        self.aug_factor = aug_factor
        self.add_tile = add_tile
        self.val_split = val_split
        self.clip_threshold = clip_threshold
        self.skeletonize = skeletonize
        self.invert = invert
        self.dilate_mask = dilate_mask
        self.dilate_kernel = dilate_kernel
        self.shiftscalerotate = shiftscalerotate
        self.noise_lims = noise_lims
        self.brightness_contrast = brightness_contrast
        self.blur_limit = blur_limit
        self.mode = "train"
        self.params = dict(
            dim_out=self.dim_out, aug_factor=aug_factor, clip_threshold=clip_threshold,
            shiftscalerotate=shiftscalerotate, noise_lims=noise_lims,
            brightness_contrast=brightness_contrast, blur_limit=blur_limit,
        )
        d = _fresh_dirs(data_path, [
            "image", "mask", "merge", "split/merge", "split/image", "split/mask",
            "augmentation/aug_image", "augmentation/aug_mask",
        ], wipe=create)
        self.image_path, self.mask_path, self.merge_path = d["image"], d["mask"], d["merge"]
        self.split_merge_path = d["split/merge"]
        self.split_image_path, self.split_mask_path = d["split/image"], d["split/mask"]
        self.aug_image_path = d["augmentation/aug_image"]
        self.aug_mask_path = d["augmentation/aug_mask"]
        if create:
            rng = np.random.default_rng(seed)
            self._move_and_edit()
            self._merge_images()
            self._split()
            if self.aug_factor is not None:
                self._augment(rng)

    def _move_and_edit(self):
        for file_i in _tif_files(self.source_dir[0]):
            img = clip_and_normalize(tiff.imread(file_i), self.clip_threshold).astype(np.uint8)
            if img.ndim == 2:
                img = img[None]
            name = os.path.splitext(os.path.basename(file_i))[0].replace(" ", "_")
            tiff.imwrite(os.path.join(self.image_path, name + ".tif"), img)
        files_mask = _tif_files(self.source_dir[1])
        print(f"{len(files_mask)} files found")
        for file_i in files_mask:
            mask = tiff.imread(file_i)
            if mask.ndim == 2:
                mask = mask[None]
            mask = np.stack([edit_mask(ch, self.skeletonize, self.dilate_mask,
                                       self.dilate_kernel, self.invert) for ch in mask])
            name = os.path.splitext(os.path.basename(file_i))[0].replace(" ", "_")
            tiff.imwrite(os.path.join(self.mask_path, name + ".tif"), mask.astype(np.uint8))

    def _merge_images(self):
        mask_files = _tif_files(self.mask_path)
        image_files = _tif_files(self.image_path)
        if len(mask_files) != len(image_files):
            raise ValueError("Number of ground truth does not match number of image stacks")
        for i, file_i in enumerate(mask_files):
            base = os.path.basename(file_i)
            mask = np.atleast_3d(tiff.imread(os.path.join(self.mask_path, base)).T).T
            img = np.atleast_3d(tiff.imread(os.path.join(self.image_path, base)).T).T
            merge = np.concatenate([np.moveaxis(mask, 0, 2), np.moveaxis(img, 0, 2)],
                                   axis=2).astype(np.uint8)
            tiff.imwrite(os.path.join(self.merge_path, f"{i}.tif"), merge)

    def _split(self):
        n = 0
        for i in range(len(_tif_files(self.merge_path))):
            merge = tiff.imread(os.path.join(self.merge_path, f"{i}.tif"))
            x_gap = max(0, self.dim_out[0] - merge.shape[0])
            y_gap = max(0, self.dim_out[1] - merge.shape[1])
            merge = np.pad(merge, ((0, x_gap), (0, y_gap), (0, 0)), "reflect")
            xs = tile_starts(merge.shape[0], self.dim_out[0], self.add_tile)
            ys = tile_starts(merge.shape[1], self.dim_out[1], self.add_tile)
            for x0 in xs:
                for y0 in ys:
                    patch = merge[x0:x0 + self.dim_out[0], y0:y0 + self.dim_out[1]]
                    tiff.imwrite(os.path.join(self.split_merge_path, f"{n}.tif"), patch)
                    tiff.imwrite(os.path.join(self.split_mask_path, f"{n}.tif"),
                                 patch[:, :, :self.out_channels])
                    tiff.imwrite(os.path.join(self.split_image_path, f"{n}.tif"),
                                 patch[:, :, self.out_channels:])
                    n += 1

    def _augment(self, rng, p=0.8):
        pipeline = Compose([
            RandomRotate90(p=1.0),
            ShiftScaleRotate(*self.shiftscalerotate),
            RandomBrightnessContrast(self.brightness_contrast[0],
                                     self.brightness_contrast[1], p=0.5),
            Blur(blur_limit=self.blur_limit, p=0.2),
            MultiplicativeNoise(multiplier=self.noise_lims, elementwise=True, p=0.3),
        ], p=p)
        k = 0
        for i in range(len(_tif_files(self.split_image_path))):
            image = tiff.imread(os.path.join(self.split_image_path, f"{i}.tif"))
            mask = tiff.imread(os.path.join(self.split_mask_path, f"{i}.tif"))
            for _ in range(self.aug_factor):
                out = pipeline(rng, image=image, mask=mask)
                img_a, mask_a = np.atleast_3d(out["image"]), np.atleast_3d(out["mask"])
                tiff.imwrite(os.path.join(self.aug_image_path, f"{k}.tif"),
                             np.moveaxis(img_a, 2, 0))
                tiff.imwrite(os.path.join(self.aug_mask_path, f"{k}.tif"),
                             np.moveaxis(mask_a, 2, 0))
                k += 1
        print(f"Number of training images: {k}")

    def __len__(self):
        path = self.aug_image_path if self.aug_factor is not None else self.split_image_path
        return len(_tif_files(path))

    def _load_item(self, idx):
        if self.aug_factor is not None:
            image = _read_chw(os.path.join(self.aug_image_path, f"{idx}.tif"))
            mask = _read_chw(os.path.join(self.aug_mask_path, f"{idx}.tif"))
        else:
            image = _read_split_chw(os.path.join(self.split_image_path, f"{idx}.tif"))
            mask = _read_split_chw(os.path.join(self.split_mask_path, f"{idx}.tif"))
        return {"image": image, "mask": mask}


class Subset:
    def __init__(self, dataset, indices: Sequence[int]):
        self.dataset = dataset
        self.indices = list(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.dataset[self.indices[i]]


def random_split(dataset, val_split: float, seed: Optional[int] = None):
    """(train, val) split; val gets ``ceil`` of the fraction
    (``pipelines.py:983``)."""
    n = len(dataset)
    n_val = int(np.ceil(n * val_split)) if val_split > 0 else 0
    perm = np.random.default_rng(seed).permutation(n)
    return Subset(dataset, perm[n_val:]), Subset(dataset, perm[:n_val])


class DataLoader:
    """Shuffle, drop_last and dict collation into stacked numpy arrays, with a
    background prefetch thread (``pipelines.py:993``).  The shuffle stream
    advances once per epoch; ``skip_epochs`` advances it without loading, so
    a resumed run draws the batch order the uninterrupted run would have."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, seed: Optional[int] = None,
                 prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = prefetch
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else int(np.ceil(n / self.batch_size))

    def _order(self) -> np.ndarray:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(order)
        return order

    def skip_epochs(self, n: int) -> None:
        for _ in range(n):
            self._order()

    def _batches(self):
        order = self._order()
        stop = (len(order) // self.batch_size) * self.batch_size if self.drop_last else len(order)
        for start in range(0, stop, self.batch_size):
            idxs = order[start:start + self.batch_size]
            if len(idxs) == 0:
                return
            samples = [self.dataset[int(i)] for i in idxs]
            yield {k: np.stack([s[k] for s in samples]) for k in samples[0]}

    def __iter__(self):
        if self.prefetch <= 0:
            yield from self._batches()
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        error: list = []
        stop = threading.Event()

        def put(item) -> bool:
            # poll the stop flag so an abandoned iteration releases the thread
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for batch in self._batches():
                    if not put(batch):
                        return
            except BaseException as e:  # surfaced in the consumer
                error.append(e)
            finally:
                put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    if error:
                        raise error[0]
                    break
                yield item
        finally:
            stop.set()
            t.join(timeout=5.0)
