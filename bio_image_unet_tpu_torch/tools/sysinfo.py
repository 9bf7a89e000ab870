"""Host/device introspection & experiment provenance (counterpart of
``bio_image_unet_tpu/tools/sysinfo.py``; reference
siam_unet/helpers/cuda_test.py, __cpu_count__.py, __md5sum__.py,
util.py:11-37 info-file writers)."""

from __future__ import annotations

import hashlib
import multiprocessing
import os
import platform
import time
from typing import Optional


def device_test(verbose: bool = True) -> list:
    """List the visible CUDA devices, as the reference's cuda_test.py did:
    one ``{'index', 'name', 'memory_bytes'}`` record a card.  With no card
    it says so and returns ``[]``; the CPU is never listed as the
    accelerator."""
    import torch

    devices = []
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            props = torch.cuda.get_device_properties(i)
            devices.append({"index": i, "name": props.name,
                            "memory_bytes": int(props.total_memory)})
    if verbose:
        if not devices:
            print("no CUDA device is visible (torch.cuda.is_available() is False)")
        else:
            print(f"CUDA devices: {len(devices)} (torch {torch.__version__}, "
                  f"CUDA {torch.version.cuda})")
            for d in devices:
                print(f"  {d['index']}: {d['name']} ({d['memory_bytes'] / 2**30:.1f} GiB)")
    return devices


def cpu_count() -> int:
    """(reference __cpu_count__.py)"""
    return multiprocessing.cpu_count()


def md5sum(path, chunk_size: int = 1 << 20) -> str:
    """md5 of a file without shelling out (the reference pipes through the
    ``md5sum`` binary, __md5sum__.py)."""
    h = hashlib.md5()
    with open(path, "rb") as fh:
        while True:
            chunk = fh.read(chunk_size)
            if not chunk:
                break
            h.update(chunk)
    return h.hexdigest()


def md5sum_folder(path) -> str:
    """One digest for a whole directory tree (reference __md5sum__.py:16-21
    pipes ``tar -cf - <dir> | md5sum``). Documented divergences: tar output
    embeds mtimes/uids/ordering, so the reference's digest changes across
    hosts for identical content — here the digest hashes the sorted relative
    paths plus entry contents, so equal trees always hash equal. Like tar,
    symlinks are hashed by their target string (a dangling link is an entry,
    not an error) and empty directories are entries too, so trees differing
    only by an empty subdir or a retargeted link hash differently."""
    h = hashlib.md5()
    root = os.path.abspath(path)
    entries = []
    for dirpath, dirnames, filenames in os.walk(root):
        if dirpath != root and not dirnames and not filenames:
            entries.append((os.path.relpath(dirpath, root) + "/", None))
        for name in filenames:
            full = os.path.join(dirpath, name)
            entries.append((os.path.relpath(full, root), full))
    for rel, full in sorted(entries):
        h.update(rel.encode("utf-8") + b"\0")
        if full is None:  # empty directory entry
            h.update(b"dir\0")
        elif os.path.islink(full):
            h.update(b"link:" + os.readlink(full).encode("utf-8",
                                                         "surrogateescape")
                     + b"\0")
        else:
            h.update(md5sum(full).encode("ascii") + b"\0")
    return h.hexdigest()


def get_info_file_header(job_name: str = "") -> str:
    """Experiment provenance header: host, time, scheduler job info if any
    (reference util.py:22-31 reads SLURM env vars)."""
    lines = [
        f"job_name: {job_name}",
        f"host: {platform.node()}",
        f"platform: {platform.platform()}",
        f"time: {time.strftime('%Y-%m-%d %H:%M:%S')}",
        f"cpu_count: {cpu_count()}",
    ]
    for var in ("SLURM_JOB_ID", "SLURM_JOB_NODELIST", "SLURM_NTASKS",
                "TPU_WORKER_ID", "MEGASCALE_SLICE_ID"):
        if os.environ.get(var):
            lines.append(f"{var}: {os.environ[var]}")
    return "\n".join(lines) + "\n"


def write_info_file(path, job_name: str = "", extra: Optional[str] = None) -> None:
    """(reference util.py:33-37)"""
    with open(path, "w") as fh:
        fh.write(get_info_file_header(job_name))
        if extra:
            fh.write(extra if extra.endswith("\n") else extra + "\n")
