"""Device resolution for the port.

The JAX package picks TPU → GPU → CPU and warns when it lands on the CPU
(``bio_image_unet_tpu/utils/utils.py:79 get_device``).  The port's entry
points run on the card: with no ``device`` they take CUDA, and where there is
no card they raise instead of carrying on silently on the CPU.  The CPU runs
only when the caller asks for it by name (the tests do).
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda``; anything else is taken as given.  Raises when a
    CUDA device is asked for (explicitly or by default) and none exists."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the GPU by "
            "default — pass device='cpu' to run on the CPU explicitly")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def get_device(print_device: bool = False) -> torch.device:
    """The card the port runs on (raises when there is none)."""
    dev = resolve_device(None)
    if print_device:
        print(f"Using device: {dev} ({torch.cuda.get_device_name(dev)})")
    return dev
