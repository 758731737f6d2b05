"""Named wall-clock timer registry (reference ``utils/tiktok.py:10-77``).

Counterpart of ``deformationpyramid_tpu/utils/timers.py``: the same tic /
toc API on the host clock. PyTorch returns from a CUDA call before the
device has finished, so a ``toc`` that is to mean device time passes
``sync=True`` and waits for the current stream first. For kernel-level
profiles, :func:`trace` writes a ``torch.profiler`` Chrome trace where the
JAX package writes a ``jax.profiler`` one.

Inside the port, :func:`span` marks a layer boundary and :func:`count`
adds to a named counter, both only while ``torch.profiler`` records on the
calling thread: a span is then a host range on the profiler's own clock,
so that each device operation in the trace can be tied to the span open
at its launch. With the profiler off each call is one check of the
profiler's state and nothing else. Span names begin with ``dp::`` and are
passed as literals, so that the off path formats nothing.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time

import torch

_OFF = contextlib.nullcontext()
_counters: dict[str, float] = {}
_counters_lock = threading.Lock()


def span(name: str):
    """A context manager: a host range ``name`` in the trace while the
    profiler records on this thread, else a shared no-op.

    The range is a plain function range and not a ``record_function`` user
    annotation: an annotation is mirrored onto the device's timeline as an
    event of its own, which a trace reader that tells kinds of events by
    name would take for a device operation."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch._C._profiler._RecordFunctionFast(name)


def recording() -> bool:
    """Whether ``torch.profiler`` records on the calling thread: the switch
    of :func:`span` and :func:`count`. A caller whose count needs a host
    read of the device asks this first, so that the read is made only
    while the profiler records."""
    return torch.autograd._profiler_enabled()


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to the counter ``name`` while the profiler records on this
    thread (see :func:`counters`)."""
    if recording():
        with _counters_lock:
            _counters[name] = _counters.get(name, 0) + n


def counters() -> dict[str, float]:
    """A copy of the counters added since the last :func:`reset_counters`."""
    with _counters_lock:
        return dict(_counters)


def reset_counters() -> None:
    with _counters_lock:
        _counters.clear()


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


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over the block (host ops with the port's ``dp::``
    spans, and the device's kernels where CUDA is available), written on
    exit as a Chrome trace, ``<log_dir>/trace.json``, with the block's
    counters beside it in ``<log_dir>/counters.json``. Yields the profiler
    (``key_averages()`` for sums by kernel)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    reset_counters()
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "counters.json"), "w") as f:
        json.dump(counters(), f, indent=1, sort_keys=True)
