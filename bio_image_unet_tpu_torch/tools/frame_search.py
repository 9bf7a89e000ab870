"""Locate which movie/frame a label was drawn on (counterpart of
``bio_image_unet_tpu/tools/frame_search.py``; reference
siam_unet/helpers/find_frame_of_image.py).  Host only, on the port's TIFF
codec."""

from __future__ import annotations

import os
from typing import Iterator, List, Sequence

import numpy as np

from ..data import tiff


def mse(a: np.ndarray, b: np.ndarray) -> float:
    """Mean squared error between two equal-shaped images (reference :68-77)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.mean((a - b) ** 2))


def frame_generator(tiff_movie) -> Iterator[np.ndarray]:
    """Stream each frame of a movie (reference :57-66)."""
    with tiff.TiffReader(tiff_movie) as reader:
        yield from reader.iter_pages()


def find_frame_of_image(query_image, search_space: Sequence[str] = (),
                        save_machine_readable_output: bool = True,
                        machine_readable_output_filename: str = "search_result_mr.txt",
                        mse_threshold: float = 1000.0) -> List[dict]:
    """Find the best-matching frame of ``query_image`` in each candidate movie:
    exact match if any, else minimum MSE (reference :8-55).

    Returns one record per searched candidate:
    ``{'candidate', 'frame', 'mse', 'exact'}``.  When
    ``save_machine_readable_output`` and the best frame number equals the
    query's numeric basename with MSE < ``mse_threshold``, a tab-separated
    line ``label  movie  frame`` is appended to the output file (the format
    consumed by :func:`..tools.utilize_search_result`).
    """
    query = tiff.imread(query_image)
    if query.ndim == 3:
        query = query.mean(axis=-1).astype(query.dtype)
    results = []
    for candidate in search_space:
        with tiff.TiffReader(candidate) as reader:
            if reader.page_shape(0) != query.shape:
                print(f"Shape of query {query.shape} differs with shape of "
                      f"{candidate} {reader.page_shape(0)}")
                continue
            best = None
            for frame_nbr, img in enumerate(reader.iter_pages()):
                if np.array_equal(img, query):
                    print(f"Found exact match in frame {frame_nbr} of {candidate}.")
                    best = {"candidate": candidate, "frame": frame_nbr,
                            "mse": 0.0, "exact": True}
                    break
                err = mse(query, img)
                if best is None or err < best["mse"]:
                    best = {"candidate": candidate, "frame": frame_nbr,
                            "mse": err, "exact": False}
        if best is None:
            continue
        if not best["exact"]:
            print(f"No exact match was found in {candidate}. The closest "
                  f"matching frame was {best['frame']} with MSE of {best['mse']}")
        results.append(best)

        if save_machine_readable_output:
            base = os.path.basename(str(query_image)).split(".")[0]
            if base.isdigit() and best["frame"] == int(base) and best["mse"] < mse_threshold:
                with open(machine_readable_output_filename, "a") as fh:
                    fh.write(f"{os.path.basename(str(query_image))}\t"
                             f"{os.path.basename(candidate)}\t{best['frame']}\n")
    return results


def fetch_frame(tif_file) -> Iterator[np.ndarray]:
    """Streaming frame generator for a tif movie
    (reference siam_unet/helpers/low_mem_tif_utils.py:4-17; alias of
    :func:`frame_generator`)."""
    yield from frame_generator(tif_file)


def individual_tif_generator(directory, tif_len: int) -> Iterator[np.ndarray]:
    """Yield ``{directory}/{i}.tif`` for i in range(tif_len)
    (reference low_mem_tif_utils.py:19-24)."""
    for i in range(tif_len):
        yield tiff.imread(os.path.join(str(directory), f"{i}.tif"))


def stream_write(path, frames) -> int:
    """Write an iterable of frames to a multipage tif with bounded memory
    (the reference streams via tifffile's iterable-data support,
    low_mem_tif_utils.py:26-32).  Returns the number of frames written."""
    n = 0
    with tiff.TiffWriter(path) as writer:
        for frame in frames:
            writer.write(np.asarray(frame))
            n += 1
    return n
