"""Build and bind the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface.  On first use it is compiled
by ``nvcc`` for Hopper (``sm_90a``) into a shared library under the package's
``build/`` directory (listed in ``.gitignore``) and loaded with ``ctypes``.
Libraries are named by a hash of their source and flags, so an edited source
is rebuilt and an unchanged one is reused.  Nothing here runs at import: the
CPU tests import every module and never build.

``-fmad=false`` keeps nvcc from contracting ``a + b*c`` into an FMA: the clip
bounds blend and the normalization must round every step exactly as the JAX
reference does.  ``--use_fast_math`` is never used.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "build"
SOURCES = {
    "clip_bounds": "clip_bounds.cu",
    "normalize_tile": "normalize_tile.cu",
    "sigmoid_stitch": "sigmoid_stitch.cu",
    "augment_batch": "augment_batch.cu",
    "margin_stitch": "margin_stitch.cu",
    "depthwise_xcorr": "depthwise_xcorr.cu",
    "int8_trunk": "int8_trunk.cu",
    "int8_resample": "int8_resample.cu",
}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# the C interface's dtype argument of the kernels that take several
DTYPE_CODE = {torch.uint8: 0, torch.uint16: 1, torch.float32: 2}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built on "
                       "the machine with the card (CUDA toolkit required)")


def _lib_path(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD / f"lib{name}-{h}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile the named kernels (all by default) that are not built yet, one
    ``nvcc`` per source, all started together.  Returns each new build's
    ptxas summary; raises with the compiler's output on failure."""
    names = list(SOURCES if names is None else names)
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return {}
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        out = _lib_path(n)
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    logs, errors = {}, []
    for n, (p, tmp, out) in procs.items():
        text, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"nvcc failed for {SOURCES[n]} (rc {p.returncode}):\n{text}")
            continue
        os.replace(tmp, out)
        logs[n] = text
    if errors:
        raise RuntimeError("\n".join(errors))
    return logs


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    with _LOCK:
        if name not in _LIBS:
            build([name])
            _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
        return _LIBS[name]


def function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """A C entry point of kernel ``name`` with its argument types set (every
    pointer and the stream as ``c_void_p``); it returns a ``cudaError_t``."""
    fn = getattr(lib(name), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def launch(fn, device: torch.device, *args) -> None:
    """Call C entry point ``fn`` with ``device`` current, appending that
    device's current stream as the last argument, and raise when it returns
    a CUDA error (a refused launch never runs, and a later synchronize would
    not report it).  The argument count must match ``fn``'s argument types,
    the stream included: ctypes would pass a surplus pointer as a C int."""
    if len(args) + 1 != len(fn.argtypes):
        raise TypeError(f"{fn.__name__}: {len(args)} arguments and the stream for "
                        f"{len(fn.argtypes)} parameters")
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__}: CUDA error {err}")


def require_cuda(t: torch.Tensor, what: str, device=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor (on ``device`` if given)."""
    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{what}: expected a tensor on {device}, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")


P = ctypes.c_void_p
I32 = ctypes.c_int
I64 = ctypes.c_longlong
F32 = ctypes.c_float
