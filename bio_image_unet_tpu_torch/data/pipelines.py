"""The training-data pipelines and their loader (the port's copy of
``bio_image_unet_tpu/data/pipelines.py`` but its Siam pipeline: helpers
:54-183, ``DataProcess2D`` :191-352, ``DataProcess3D`` :538-683,
``DataProcessMultiOutput`` :686-843, ``DataProcessMultiOutput3D`` :851-968,
``Subset`` :971, ``random_split`` :983, ``DataLoader`` :993).

The on-disk layout, the tiling rule and the augmentation stream are the JAX
package's, so the same source TIFFs and seed give bit-equal tiles.  One
difference, the torch idiom: items are channels-first float32 numpy arrays,
``{'image': (C, H, W), 'mask': (C, H, W)}`` in [0, 1] (JAX: HWC), or for
volumes ``{'volume': (1, Z, X, Y), 'mask': (1, Z, X, Y)}`` (JAX: ZXYC), and
the loader stacks them to (B, C, ...).  Shuffles keep
``np.random.default_rng``, so a seed gives the JAX Trainer's split and batch
order.
"""

from __future__ import annotations

import glob
import os
import queue
import shutil
import threading
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from . import morphology, tiff
from .augment import (Blur, Compose, GaussNoise, MultiplicativeNoise, PadIfNeeded,
                      RandomBrightnessContrast, RandomCrop, RandomCrop3D, RandomRotate90,
                      RandomScale, ShiftScaleRotate, ShiftScaleRotate3D, ShotNoise,
                      rotate_array, rotate_array_90)

__all__ = ["clip_and_normalize", "edit_mask", "tile_starts", "DataProcess2D", "DataProcess3D",
           "DataProcessMultiOutput", "DataProcessMultiOutput3D", "Subset", "random_split",
           "DataLoader"]


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


class DataProcess3D(_TileDataset):
    """Volumetric pipeline (``pipelines.py:538``; reference unet3d/data.py:
    15-260): each (Z, X, Y) volume clip-normalized to uint8 and its mask
    edited slice by slice → merge (volume ‖ mask, (Z, X, Y, 2)) → reflect pad
    and linspace tiling on all three axes → ``aug_factor`` augmented copies
    per tile, the 2D pipeline run on the (X, Y, Z) transposed stack (2.5D),
    written under ``data_path`` (volume/ mask/ merge/ split/ augmentation/).

    ``add_patch`` adds patches on every axis with more than one tile, the
    JAX package's reading of the reference rule (``:621-626``).  Items are
    ``{'volume': (1, Z, X, Y), 'mask': (1, Z, X, Y)}`` float32 in [0, 1]."""

    def __init__(self, source_dir, dim_out=(128, 128, 128), aug_factor=10,
                 data_path="../data/", dilate_mask=0, dilate_kernel="disk",
                 add_patch=0, val_split=0.2, invert=False, skeletonize=False,
                 clip_threshold=(0.2, 99.8), shiftscalerotate=(0, 0, 0),
                 noise_amp=10, brightness_contrast=(0.25, 0.25), create=True,
                 cache=True, seed: Optional[int] = None):
        super().__init__(cache)
        self.source_dir = source_dir
        self.data_path = data_path
        self.dim_out = tuple(dim_out)
        self.aug_factor = aug_factor
        self.add_patch = add_patch
        self.val_split = val_split
        self.skeletonize = skeletonize
        self.invert = invert
        self.clip_threshold = clip_threshold
        self.shiftscalerotate = shiftscalerotate
        self.noise_amp = noise_amp
        self.brightness_contrast = brightness_contrast
        self.dilate_mask = dilate_mask
        self.dilate_kernel = dilate_kernel
        self.mode = "train"
        d = _fresh_dirs(data_path, [
            "volume", "mask", "merge", "split/merge", "split/volume", "split/mask",
            "augmentation/aug_volume", "augmentation/aug_mask",
        ], wipe=create)
        self.volume_path, self.mask_path, self.merge_path = d["volume"], d["mask"], d["merge"]
        self.split_merge_path = d["split/merge"]
        self.split_volume_path, self.split_mask_path = d["split/volume"], d["split/mask"]
        self.aug_volume_path = d["augmentation/aug_volume"]
        self.aug_mask_path = d["augmentation/aug_mask"]
        if create:
            rng = np.random.default_rng(seed)
            self._move_and_edit()
            self._merge_volumes()
            self._split()
            if self.aug_factor is not None:
                self._augment(rng)

    def _move_and_edit(self):
        for file_i in _tif_files(self.source_dir[0]):
            vol = clip_and_normalize(tiff.imread(file_i), self.clip_threshold).astype(np.uint8)
            name = os.path.splitext(os.path.basename(file_i))[0].replace(" ", "_")
            tiff.imwrite(os.path.join(self.volume_path, name + ".tif"), vol)
        files_mask = _tif_files(self.source_dir[1])
        print(f"{len(files_mask)} files found")
        for file_i in files_mask:
            mask = np.stack([edit_mask(sl, self.skeletonize, self.dilate_mask,
                                       self.dilate_kernel, self.invert)
                             for sl in tiff.imread(file_i)])
            name = os.path.splitext(os.path.basename(file_i))[0].replace(" ", "_")
            tiff.imwrite(os.path.join(self.mask_path, name + ".tif"), mask.astype(np.uint8))

    def _merge_volumes(self):
        mask_files = _tif_files(self.mask_path)
        volume_files = _tif_files(self.volume_path)
        if len(mask_files) != len(volume_files):
            raise ValueError("Number of ground truth does not match number of volume stacks")
        for i, file_i in enumerate(mask_files):
            base = os.path.basename(file_i)
            mask = tiff.imread(os.path.join(self.mask_path, base))
            vol = tiff.imread(os.path.join(self.volume_path, base))
            merge = np.stack([vol, mask], axis=3).astype(np.uint8)  # (Z, X, Y, 2)
            tiff.imwrite(os.path.join(self.merge_path, f"{i}.tif"), merge)

    def _split(self):
        n = 0
        for i in range(len(_tif_files(self.merge_path))):
            merge = tiff.imread(os.path.join(self.merge_path, f"{i}.tif"))
            gaps = [max(0, self.dim_out[a] - merge.shape[a]) for a in range(3)]
            merge = np.pad(merge, [(0, g) for g in gaps] + [(0, 0)], "reflect")
            zs, xs, ys = (tile_starts(merge.shape[a], self.dim_out[a], self.add_patch)
                          for a in range(3))
            dz, dx, dy = self.dim_out
            for z0 in zs:
                for x0 in xs:
                    for y0 in ys:
                        patch = merge[z0:z0 + dz, x0:x0 + dx, y0:y0 + dy]
                        tiff.imwrite(os.path.join(self.split_merge_path, f"{n}.tif"), patch)
                        tiff.imwrite(os.path.join(self.split_volume_path, f"{n}.tif"),
                                     patch[..., 0])
                        tiff.imwrite(os.path.join(self.split_mask_path, f"{n}.tif"),
                                     patch[..., 1])
                        n += 1

    def _augment(self, rng, p=0.8):
        pipeline = Compose([
            RandomRotate90(p=1.0),
            ShiftScaleRotate(*self.shiftscalerotate),
            GaussNoise(var_limit=(self.noise_amp, self.noise_amp), p=0.3),
            RandomBrightnessContrast(self.brightness_contrast[0],
                                     self.brightness_contrast[1], p=0.5),
        ], p=p)
        k = 0
        for i in range(len(_tif_files(self.split_volume_path))):
            vol = tiff.imread(os.path.join(self.split_volume_path, f"{i}.tif"))
            mask = tiff.imread(os.path.join(self.split_mask_path, f"{i}.tif"))
            # 2.5D: the 2D pipeline on the (X, Y, Z) transposed stack
            vol_t, mask_t = vol.transpose(1, 2, 0), mask.transpose(1, 2, 0)
            for _ in range(self.aug_factor):
                out = pipeline(rng, image=vol_t, mask=mask_t)
                tiff.imwrite(os.path.join(self.aug_volume_path, f"{k}.tif"),
                             out["image"].transpose(2, 0, 1))
                tiff.imwrite(os.path.join(self.aug_mask_path, f"{k}.tif"),
                             out["mask"].transpose(2, 0, 1))
                k += 1
        print(f"Number of training volumes: {k}")

    def __len__(self):
        path = self.aug_volume_path if self.aug_factor is not None else self.split_volume_path
        return len(_tif_files(path))

    def _load_item(self, idx):
        root = ((self.aug_volume_path, self.aug_mask_path) if self.aug_factor is not None
                else (self.split_volume_path, self.split_mask_path))
        vol, mask = (tiff.imread(os.path.join(d, f"{idx}.tif")).astype(np.float32)[None] / 255.0
                     for d in root)
        return {"volume": vol, "mask": mask}


class DataProcessMultiOutput(_TileDataset):
    """Multi-target 2D pipeline (``pipelines.py:686``; reference
    multi_output_unet/data.py:19-349): images and their targets read into
    memory, target dicts keyed by the basename of each target directory;
    ``reps = max(int(area / tile area · aug_factor), 2)`` augmented patches
    per image, each first rotated (with p 0.5 by a uniform angle, NaN-aware,
    orientation targets shifted by ``−angle``; else by 0..2 quarter turns,
    orientation shifted by ``−π/2·factor``, both mod 2π) and then sent
    through the host pipeline; written as float32 TIFFs under ``data_dir``
    (``image/image_<n>.tif``, ``<key>/<key>_<n>.tif``).

    Items are CHW float32: ``image`` (1, S, S); a target named
    ``orientation`` as (cos θ, sin θ), (2, S, S); every other target (C, S,
    S); NaNs replaced by ``nan_to_val`` (``:827-843``)."""

    def __init__(self, image_dir: str, target_dirs: List[str],
                 target_types: Dict[str, str], data_dir: str = "../data/",
                 dim_out=(256, 256), in_channels=1, out_channels=1, add_tile=0,
                 nan_to_val: float = 0, val_split=0.2,
                 clip_threshold=(0.0, 99.99), aug_factor: float = 2,
                 gauss_noise_lims=(0.01, 0.1), shot_noise_lims=(0.001, 0.01),
                 brightness_contrast=(0.1, 0.1), blur_limit=(3, 5),
                 random_rotate=True, scale_limit=(0, 0), create=True,
                 file_filter: Optional[Callable[[str], bool]] = None,
                 cache=True, seed: Optional[int] = None):
        super().__init__(cache)
        self.image_dir = image_dir
        self.target_dirs = list(target_dirs)
        self.target_keys = [os.path.basename(os.path.normpath(d)) for d in target_dirs]
        self.target_types = target_types
        self.data_dir = data_dir
        self.data: List[dict] = []
        self.dim_out = tuple(dim_out)
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.nan_to_val = nan_to_val
        self.clip_threshold = clip_threshold
        self.add_tile = add_tile
        self.aug_factor = aug_factor
        self.brightness_contrast = brightness_contrast
        self.gauss_noise_lims = gauss_noise_lims
        self.shot_noise_lims = shot_noise_lims
        self.blur_limit = blur_limit
        self.random_rotate = random_rotate
        self.scale_limit = scale_limit
        self.file_filter = file_filter
        self.val_split = val_split
        self.mode = "train"
        if create:
            _fresh_dirs(self.data_dir, [""], wipe=True)
            rng = np.random.default_rng(seed)
            self._read_and_edit()
            self._augment(rng)

    def _read_and_edit(self):
        files = _tif_files(self.image_dir)
        if self.file_filter:
            files = [f for f in files if self.file_filter(f)]
        for file_i in files:
            img = clip_and_normalize(tiff.imread(file_i).astype(np.float32),
                                     self.clip_threshold, scale=1.0)
            data_i = {"image": img}
            for target_dir, key in zip(self.target_dirs, self.target_keys):
                path = os.path.join(target_dir, os.path.basename(file_i))
                if not os.path.exists(path):
                    print(f"Warning: Target file {path} does not exist.")
                    break
                data_i[key] = tiff.imread(path)
            else:
                shapes = [v.shape[-2:] for v in data_i.values()]
                if any(sh != shapes[0] for sh in shapes):
                    raise ValueError(f"File: {file_i}. Shape mismatch across targets: {shapes}")
                self.data.append(data_i)

    @staticmethod
    def _chw_to_hwc(x):
        return np.transpose(x, (1, 2, 0)) if x.ndim == 3 else x

    @staticmethod
    def _hwc_to_chw(x):
        return np.transpose(x, (2, 0, 1)) if x.ndim == 3 else x

    def _augment(self, rng):
        pipeline = Compose([
            RandomScale(scale_limit=self.scale_limit, p=0.75),
            Blur(blur_limit=self.blur_limit, p=0.25),
            PadIfNeeded(self.dim_out[0], self.dim_out[1]),
            RandomCrop(self.dim_out[0], self.dim_out[1], p=1),
            ShotNoise(scale_range=self.shot_noise_lims, p=0.25),
            GaussNoise(std_range=self.gauss_noise_lims, p=0.25),
            RandomBrightnessContrast(self.brightness_contrast[0],
                                     self.brightness_contrast[1], p=0.5),
        ], targets={k: self.target_types.get(k, "mask") for k in self.target_keys})
        n = 0
        image_out = os.path.join(self.data_dir, "image")
        os.makedirs(image_out, exist_ok=True)
        for data_i in self.data:
            image = data_i["image"].astype(np.float32)
            targets = {k: data_i[k].astype(np.float32) for k in data_i if k != "image"}
            reps = max(int(image.shape[0] * image.shape[1]
                           / (self.dim_out[0] * self.dim_out[1]) * self.aug_factor), 2)
            for _ in range(reps):
                aug_image, aug_targets = image.copy(), dict(targets)
                if self.random_rotate:
                    if rng.random() < 0.5:
                        angle = float(rng.uniform(0, 360))
                        aug_image = rotate_array(aug_image, angle, order=0)
                        for key in aug_targets:
                            aug_targets[key] = rotate_array(aug_targets[key], angle, order=3)
                            if "orientation" in key:
                                aug_targets[key] = (aug_targets[key] - np.radians(angle)) % (
                                    2 * np.pi)
                    else:
                        # quarter turns 0..2, as in the JAX package
                        factor = int(rng.integers(0, 3))
                        aug_image = rotate_array_90(aug_image, factor)
                        for key in aug_targets:
                            if "orientation" in key:
                                aug_targets[key] = (aug_targets[key] - (np.pi / 2 * factor)) % (
                                    2 * np.pi)
                            aug_targets[key] = rotate_array_90(aug_targets[key], factor)
                sample = {"image": np.clip(aug_image, 0, 1)}
                sample.update({k: self._chw_to_hwc(v) for k, v in aug_targets.items()})
                out = pipeline(rng, **sample)
                tiff.imwrite(os.path.join(image_out, f"image_{n}.tif"),
                             np.asarray(self._hwc_to_chw(out["image"]), dtype=np.float32))
                for key in targets:
                    tdir = os.path.join(self.data_dir, key)
                    os.makedirs(tdir, exist_ok=True)
                    tiff.imwrite(os.path.join(tdir, f"{key}_{n}.tif"),
                                 np.asarray(self._hwc_to_chw(out[key]), dtype=np.float32))
                n += 1
        print(f"Augmentation completed for {n} patches.")

    def __len__(self):
        image_dir = os.path.join(self.data_dir, "image")
        return len([f for f in os.listdir(image_dir)
                    if os.path.isfile(os.path.join(image_dir, f))])

    def _load_item(self, idx):
        image = tiff.imread(os.path.join(self.data_dir, "image", f"image_{idx}.tif"))
        image = image.astype(np.float32)
        sample = {"image": image[None] if image.ndim == 2 else image}
        for key in self.target_keys:
            path = os.path.join(self.data_dir, key, f"{key}_{idx}.tif")
            if not os.path.exists(path):
                raise FileNotFoundError(f"Target file {path} not found.")
            t = tiff.imread(path).astype(np.float32)
            if key == "orientation":
                t = np.stack([np.cos(t), np.sin(t)])
            elif t.ndim == 2:
                t = t[None]
            sample[key] = np.nan_to_num(t, nan=self.nan_to_val)
        return sample


class DataProcessMultiOutput3D(_TileDataset):
    """Multi-target 3D pipeline (``pipelines.py:851``; reference
    multi_output_unet3d/data.py:15-267): volumes (clip-normalized to [0, 1])
    and their targets read into memory, target dicts keyed by the basename of
    each target directory; ``aug_factor`` patches per volume, each through a
    spatial stage (``ShiftScaleRotate3D`` with p 0.8, then ``RandomCrop3D``
    to ``dim_out``, on the volume and every target) and an intensity stage
    on the volume under p 0.8 (brightness/contrast, in-plane ``Blur``, shot
    noise, Gaussian noise); written as float32 TIFFs under ``data_dir``
    (``volume/volume_<n>.tif``, ``<key>/<key>_<n>.tif``).

    Items are channels-first float32: ``volume`` (1, Z, X, Y); a target named
    ``orientation`` (an angle volume) as (cos θ, sin θ), (2, Z, X, Y); every
    other target (1, Z, X, Y); NaNs replaced by ``nan_to_val``."""

    def __init__(self, volume_dir: str, target_dirs: List[str],
                 data_dir: str = "../data/", dim_out=(128, 128, 128),
                 in_channels=1, add_tile=0, nan_to_val: float = 0,
                 val_split=0.2, clip_threshold=(0.0, 99.99), aug_factor=10,
                 scale_limit=(-0.75, 0), rotate_limit=(0, 360),
                 gauss_noise_lims=(0.01, 0.1), shot_noise_lims=(0.005, 0.01),
                 brightness_contrast=(0.1, 0.1), blur_limit=(3, 7),
                 random_rotate=True, create=True, cache=True,
                 seed: Optional[int] = None):
        super().__init__(cache)
        self.volume_dir = volume_dir
        self.target_dirs = list(target_dirs)
        self.target_keys = [os.path.basename(os.path.normpath(d)) for d in target_dirs]
        self.data_dir = data_dir
        self.data: List[dict] = []
        self.dim_out = tuple(dim_out)
        self.in_channels = in_channels
        self.add_tile = add_tile
        self.nan_to_val = nan_to_val
        self.clip_threshold = clip_threshold
        self.aug_factor = aug_factor
        self.scale_limit = scale_limit
        self.rotate_limit = rotate_limit
        self.gauss_noise_lims = gauss_noise_lims
        self.shot_noise_lims = shot_noise_lims
        self.brightness_contrast = brightness_contrast
        self.blur_limit = blur_limit
        self.random_rotate = random_rotate
        self.val_split = val_split
        self.mode = "train"
        if create:
            _fresh_dirs(self.data_dir, [""], wipe=True)
            rng = np.random.default_rng(seed)
            self._read_and_edit()
            if self.aug_factor is not None:
                self._augment(rng)

    def _read_and_edit(self):
        for file_i in _tif_files(self.volume_dir):
            vol = clip_and_normalize(tiff.imread(file_i).astype(np.float32),
                                     self.clip_threshold, scale=1.0)
            data_i = {"volume": vol}
            for target_dir, key in zip(self.target_dirs, self.target_keys):
                path = os.path.join(target_dir, os.path.basename(file_i))
                if not os.path.exists(path):
                    print(f"Warning: Target file {path} does not exist.")
                    break
                data_i[key] = tiff.imread(path)
            else:
                self.data.append(data_i)

    def _augment(self, rng, p=0.8):
        targets = {k: "mask" for k in self.target_keys}
        spatial = Compose([
            ShiftScaleRotate3D(0, self.scale_limit, self.rotate_limit, p=0.8),
            RandomCrop3D(self.dim_out),
        ], targets=targets)
        intensity = Compose([
            RandomBrightnessContrast(self.brightness_contrast[0],
                                     self.brightness_contrast[1], p=0.5),
            Blur(blur_limit=self.blur_limit, p=0.3, volumetric=True),
            ShotNoise(scale_range=self.shot_noise_lims, p=0.5),
            GaussNoise(std_range=self.gauss_noise_lims, p=0.5),
        ], p=p, targets=targets)
        n = 0
        vol_out = os.path.join(self.data_dir, "volume")
        os.makedirs(vol_out, exist_ok=True)
        for data_i in self.data:
            sample = {"image": data_i["volume"].astype(np.float32)}
            sample.update({k: data_i[k].astype(np.float32) for k in self.target_keys})
            for _ in range(self.aug_factor):
                out = intensity(rng, **spatial(rng, **sample))
                tiff.imwrite(os.path.join(vol_out, f"volume_{n}.tif"),
                             np.asarray(out["image"], dtype=np.float32))
                for key in self.target_keys:
                    tdir = os.path.join(self.data_dir, key)
                    os.makedirs(tdir, exist_ok=True)
                    tiff.imwrite(os.path.join(tdir, f"{key}_{n}.tif"),
                                 np.asarray(out[key], dtype=np.float32))
                n += 1
        print(f"Augmentation completed for {n} patches.")

    def __len__(self):
        vol_dir = os.path.join(self.data_dir, "volume")
        return len([f for f in os.listdir(vol_dir)
                    if os.path.isfile(os.path.join(vol_dir, f))])

    def _load_item(self, idx):
        vol = tiff.imread(os.path.join(self.data_dir, "volume", f"volume_{idx}.tif"))
        sample = {"volume": vol.astype(np.float32)[None]}
        for key in self.target_keys:
            path = os.path.join(self.data_dir, key, f"{key}_{idx}.tif")
            if not os.path.exists(path):
                raise FileNotFoundError(f"Target file {path} not found.")
            t = tiff.imread(path).astype(np.float32)
            t = np.stack([np.cos(t), np.sin(t)]) if key == "orientation" else t[None]
            sample[key] = np.nan_to_num(t, nan=self.nan_to_val)
        return sample


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
