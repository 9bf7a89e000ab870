"""Movie export & frame extraction (counterpart of
``bio_image_unet_tpu/tools/movie.py``; reference
siam_unet/helpers/tif_to_mp4.py, extract_frame_of_movie.py, util.py ffmpeg
comparisons).  Host only; ffmpeg is invoked via subprocess and gated, cv2 is
imported when frames are rendered."""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
from typing import Optional, Sequence

import numpy as np

from ..data import morphology, tiff


def _require_ffmpeg() -> str:
    path = shutil.which("ffmpeg")
    if path is None:
        raise RuntimeError("ffmpeg not found on PATH — movie export unavailable")
    return path


def tif_to_mp4(tif_path, mp4_path, fps: int = 12, threshold: Optional[float] = None,
               invert: bool = False, normalize: bool = True,
               opening: bool = False, crf: int = 17) -> None:
    """Render a tif movie to H.264 mp4 (reference tif_to_mp4.py:19-57):
    optional threshold/invert/normalize/morphological-opening per frame,
    frames dumped as PNGs, encoded with libx264."""
    import cv2

    ffmpeg = _require_ffmpeg()
    tmp = tempfile.mkdtemp(prefix="tif2mp4_")
    try:
        with tiff.TiffReader(tif_path) as reader:
            for i, frame in enumerate(reader.iter_pages()):
                # reference op order (tif_to_mp4.py:37-46): invert as the
                # 255-complement FIRST, then threshold, then min-max
                # normalize, then morphological opening
                frame = np.asarray(frame, dtype=np.float32)
                if invert:
                    frame = 255.0 - frame
                if threshold is not None:
                    frame = np.where(frame >= threshold, 255.0, 0.0)
                if normalize and frame.max() > frame.min():
                    frame = (frame - frame.min()) / (frame.max() - frame.min()) * 255
                if opening:
                    frame = morphology.binary_opening(frame > 0).astype(np.float32) * 255
                cv2.imwrite(os.path.join(tmp, f"{i:06d}.png"), frame.astype(np.uint8))
        subprocess.run(
            [ffmpeg, "-y", "-framerate", str(fps), "-i",
             os.path.join(tmp, "%06d.png"), "-c:v", "libx264", "-crf", str(crf),
             "-pix_fmt", "yuv420p", str(mp4_path)],
            check=True, capture_output=True,
        )
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def extract_frames(movie_path, frames: Sequence[int], output_dir,
                   prefix: str = "frame") -> list:
    """Dump selected frames of a movie as single tifs
    (reference extract_frame_of_movie.py)."""
    os.makedirs(output_dir, exist_ok=True)
    written = []
    with tiff.TiffReader(movie_path) as reader:
        for f in frames:
            arr = reader.read_page(f)
            path = os.path.join(output_dir, f"{prefix}_{f}.tif")
            tiff.imwrite(path, arr)
            written.append(path)
    return written


def compare_videos_vstack(inputs: Sequence[str], output: str) -> None:
    """Stack 2 videos vertically / 4 or 6 in a grid for visual comparison
    (reference util.py:54-98)."""
    ffmpeg = _require_ffmpeg()
    n = len(inputs)
    if n == 2:
        filter_ = "vstack=inputs=2"
    elif n == 4:
        filter_ = "[0:v][1:v]hstack[top];[2:v][3:v]hstack[bottom];[top][bottom]vstack"
    elif n == 6:
        filter_ = ("[0:v][1:v][2:v]hstack=inputs=3[top];"
                   "[3:v][4:v][5:v]hstack=inputs=3[bottom];[top][bottom]vstack")
    else:
        raise ValueError("compare_videos_vstack supports 2, 4 or 6 inputs")
    cmd = [ffmpeg, "-y"]
    for p in inputs:
        cmd += ["-i", str(p)]
    cmd += ["-filter_complex", filter_, str(output)]
    subprocess.run(cmd, check=True, capture_output=True)


def crop_zoom(input_video, output_video, w: str, h: str,
              x: str = None, y: str = None) -> None:
    """ffmpeg crop+scale-back zoom (reference util.py:39-43); ``x``/``y``
    omitted crops centered, like the reference's ``zoom_in``."""
    ffmpeg = _require_ffmpeg()
    crop = (f"crop={w}:{h}" if x is None or y is None
            else f"crop={w}:{h}:{x}:{y}")
    subprocess.run(
        [ffmpeg, "-y", "-i", str(input_video), "-vf",
         f"{crop},scale=iw:ih", str(output_video)],
        check=True, capture_output=True,
    )


def create_zoomed_in_comparison(video1, video2, w: str, h: str,
                                x: str = None, y: str = None,
                                output: str = "compare.mp4") -> None:
    """Crop the same region out of two videos and stack them vertically
    (reference util.py:45-52, which wrote ``temp_*`` files into the CWD and
    ``rm``'d them via the shell — here a private temp dir)."""
    with tempfile.TemporaryDirectory() as td:
        t1 = os.path.join(td, "zoom1.mp4")
        t2 = os.path.join(td, "zoom2.mp4")
        crop_zoom(video1, t1, w, h, x, y)
        crop_zoom(video2, t2, w, h, x, y)
        compare_videos_vstack([t1, t2], output)
