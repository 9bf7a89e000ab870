"""Progress reporting decoupled from compute (counterpart of
``bio_image_unet_tpu/progress.py``).

Same surface as the JAX package's ProgressNotifier: a long-lived notifier that
GUIs subscribe to via ``set_progress_report`` / ``set_progress_detail``, and a
short-lived ``iterator`` wrapper per work loop.  tqdm is optional here: where
it is not installed the console notifier prints plain-text progress lines.
"""

from __future__ import annotations

import math
import sys
import time
from typing import Callable, Iterable, Optional

__all__ = ["ProgressNotifier"]


class ProgressNotifier:
    """Progress hub: drives a console bar (tqdm when installed, plain text
    otherwise) or fans progress out to callbacks."""

    def __init__(self) -> None:
        self._task_progress: Optional[Callable] = None
        self._task_progress_details: Optional[Callable] = None
        self._console = False

    @staticmethod
    def progress_notifier_tqdm() -> "ProgressNotifier":
        """Console notifier: a tqdm bar, or plain-text lines without tqdm."""
        notifier = ProgressNotifier()
        notifier._console = True
        return notifier

    @staticmethod
    def silent_notifier() -> "ProgressNotifier":
        """Notifier that reports nothing."""
        return ProgressNotifier()

    def iterator(self, iterable: Iterable, total: Optional[int] = None):
        """Wrap ``iterable`` so each step reports progress."""
        try:
            iter(iterable)
        except TypeError:
            raise TypeError("object is not possible to iterate")
        if self._console:
            try:
                from tqdm import tqdm
            except ImportError:
                return _IteratorWrapper(iterable, _print_fraction, None, total)
            return tqdm(iterable, total=total)
        return _IteratorWrapper(iterable, self._task_progress,
                                self._task_progress_details, total)

    def set_progress_report(self, task: Callable) -> None:
        """Register a 1-argument callback receiving the progress fraction
        (or raw iteration count when the total is unknown)."""
        try:
            task(0)
        except Exception:
            raise Exception(
                "The given variable is not a function with 1 numeric parameter (or similar constructs)"
            )
        self._task_progress = task

    def set_progress_detail(self, task: Callable) -> None:
        """Register a 6-argument callback receiving
        (hh_elapsed, mm_elapsed, ss_elapsed, hh_eta, mm_eta, ss_eta)."""
        try:
            task(0, 0, 0, 0, 0, 0)
        except Exception:
            raise Exception(
                "The given variable is not a function with 6 numeric parameters (or similar constructs)"
            )
        self._task_progress_details = task


def _print_fraction(value) -> None:
    """Plain-text console progress (the fallback when tqdm is absent)."""
    if isinstance(value, float):
        print(f"  {100.0 * value:5.1f}%", file=sys.stderr, flush=True)
    else:
        print(f"  step {value}", file=sys.stderr, flush=True)


class _IteratorWrapper:
    """Per-loop iterator that times steps and emits fraction + ETA callbacks."""

    def __init__(self, iterable, task_progress, task_progress_details=None, total=None):
        self._iterator = iter(iterable)
        self._task_progress = task_progress
        self._task_progress_details = task_progress_details
        self._t0 = time.monotonic()
        self._current = 0
        if total is None:
            try:
                total = len(iterable)
            except (TypeError, AttributeError):
                total = None
        self._total = total
        if task_progress_details is not None:
            task_progress_details(0, 0, 0, 0, 0, 0)

    def __iter__(self):
        return self

    def __next__(self):
        value = next(self._iterator)  # StopIteration propagates before reporting
        self._current += 1
        elapsed = time.monotonic() - self._t0
        if self._task_progress is not None:
            if self._total is not None:
                self._task_progress(self._current / self._total)
            else:
                self._task_progress(self._current)
        if self._task_progress_details is not None and self._total is not None:
            eta = elapsed / self._current * self._total
            self._task_progress_details(*_hms(elapsed), *_hms(eta))
        return value


def _hms(seconds: float):
    hh = math.floor(seconds / 3600)
    mm = math.floor(seconds / 60) - hh * 60
    ss = math.floor(seconds) - hh * 3600 - mm * 60
    return hh, mm, ss
