"""Named wall-clock timer registry (reference ``utils/tiktok.py:10-77``).

Counterpart of ``deformationpyramid_tpu/utils/timers.py``: the same tic /
toc API on the host clock. PyTorch returns from a CUDA call before the
device has finished, so a ``toc`` that is to mean device time passes
``sync=True`` and waits for the current stream first.
"""
from __future__ import annotations

import contextlib
import time

import torch


class Timer:
    def __init__(self):
        self.total = 0.0
        self.count = 0
        self._t0 = None

    def tic(self):
        self._t0 = time.perf_counter()

    def toc(self, sync: bool = False) -> float:
        if sync and torch.cuda.is_available():
            torch.cuda.current_stream().synchronize()
        if self._t0 is None:
            return 0.0
        dt = time.perf_counter() - self._t0
        self.total += dt
        self.count += 1
        self._t0 = None
        return dt

    @property
    def avg(self) -> float:
        return self.total / max(self.count, 1)


class Timers:
    """Registry of named timers, one object threaded through a whole eval
    (reference ``eval_nolearned.py:57,91-93``)."""

    def __init__(self):
        self.timers: dict[str, Timer] = {}

    def tic(self, name: str):
        self.timers.setdefault(name, Timer()).tic()

    def toc(self, name: str, sync: bool = False) -> float:
        return self.timers.setdefault(name, Timer()).toc(sync)

    @contextlib.contextmanager
    def span(self, name: str, sync: bool = False):
        self.tic(name)
        try:
            yield
        finally:
            self.toc(name, sync=sync)

    def get_strings(self) -> list[str]:
        return [f"{k}: avg {v.avg * 1000:.2f} ms over {v.count} calls "
                f"(total {v.total:.3f} s)" for k, v in self.timers.items()]
