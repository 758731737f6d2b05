"""What the port's own spans and counters say in a traced run's slice.

While the profiler records, the port opens a ``dp::<layer>`` range at each
of its layer boundaries (``deformationpyramid_tpu_torch/utils/timers.py``
``span``) and adds to named counters what the trace cannot show (``count``,
read back through ``counters()``). A ``dp::`` range is a plain function range, which
``tracing.DeviceTrace`` files among the slice's host operators; only the
main thread's are read (the slice's own thread, ``window.tid``).

Two readings of a range, each per range (a pair or a step):

- idle inside it: the part of the slice that no device operation covers
  (the holes in ``DeviceTrace``'s union of device intervals) and that lies
  inside a range of that name;
- device work under it: the device operations whose launch lies inside a
  range of that name, launched from any thread (the rule of
  ``DeviceTrace.under``: an autograd backward launches from the engine's
  own thread while the step's range is open).

Each reading is None where the slice holds no such range: a program
without the spans (the port before it had them) reads nothing.
"""
from __future__ import annotations

import bisect

NS_PER_MS = 1e6


def ranges(trace, name: str) -> list[tuple[int, int]]:
    """The main thread's ``name`` ranges, as (start, end) in ns, sorted."""
    if trace.window is None:
        return []
    tid = trace.window.tid
    return sorted((op.start, op.end) for op in trace.host_ops
                  if op.name == name and op.tid == tid)


def _covered(busy: list[tuple[int, int]], starts: list[int], lo: int,
             hi: int) -> int:
    """ns of [lo, hi] that the sorted, disjoint intervals ``busy`` cover."""
    i = max(bisect.bisect_right(starts, lo) - 1, 0)
    total = 0
    while i < len(busy) and busy[i][0] < hi:
        total += max(0, min(busy[i][1], hi) - max(busy[i][0], lo))
        i += 1
    return total


def idle_ms(trace, name: str) -> float | None:
    """Device idle time inside the ``name`` ranges, ms a range."""
    spans = ranges(trace, name)
    if not spans:
        return None
    busy = trace._intervals()
    starts = [s for s, _ in busy]
    lo_w, hi_w = trace.window.start, trace.window.end
    idle = 0
    for s, e in spans:
        s, e = max(s, lo_w), min(e, hi_w)
        if e > s:
            idle += (e - s) - _covered(busy, starts, s, e)
    return idle / NS_PER_MS / len(spans)


def _launched_under(trace, name: str):
    """(the ``name`` ranges, the device operations launched inside them)."""
    spans = ranges(trace, name)
    starts = [s for s, _ in spans]
    ops = []
    for op in trace.device:
        if op.launch is None:
            continue
        i = bisect.bisect_right(starts, op.launch) - 1
        if i >= 0 and op.launch <= spans[i][1]:
            ops.append(op)
    return spans, ops


def device_ms(trace, name: str) -> float | None:
    """Device time of what was launched inside the ``name`` ranges, ms a
    range."""
    spans, ops = _launched_under(trace, name)
    if not ops:
        return None
    return sum(op.end - op.start for op in ops) / NS_PER_MS / len(spans)


def launches(trace, name: str, kernel: str | None = None) -> float | None:
    """Device operations launched inside the ``name`` ranges, a range;
    with ``kernel``, only those whose name holds it."""
    spans, ops = _launched_under(trace, name)
    if kernel is not None:
        ops = [op for op in ops if kernel in op.name]
    if not ops:
        return None
    return len(ops) / len(spans)


def counter_per_range(trace, counter: str, name: str) -> float | None:
    """The port's counter ``counter`` over the number of ``name`` ranges.
    The counter (``timers.counters()``) holds what the program counted
    while the profiler recorded, which is the slice: the same calls as the
    ranges."""
    from deformationpyramid_tpu_torch.utils import timers

    read = getattr(timers, "counters", None)
    counts = read() if read is not None else {}
    spans = ranges(trace, name)
    if not spans or counter not in counts:
        return None
    return counts[counter] / len(spans)
