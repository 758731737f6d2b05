"""The profiled slice of a traced run, reduced to what the metrics read.

``torch.profiler`` records the host (ops and the benchmark's ``bench::``
ranges) and the card (kernels, copies, sets) over a slice of the window
that the driver chooses. The slice is itself a ``bench::window`` range,
closed after a synchronise, so its length is the host's wall time of that
slice. Each device operation is tied to the host range that launched it
through the runtime call that shares its correlation id: the device time
"under" a range is that of every operation launched while the range was
open, whatever kernel implements it.

Device busy time is the union of the device operations' intervals inside
the slice (``scripts/profile_torch_*.py``'s arithmetic); idle gaps are the
holes in that union, each named by what the host was doing at its middle.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses

import torch

WINDOW = "bench::window"


class Tracer:
    """Starts and stops the profiler around a slice of the window."""

    def __init__(self):
        self.active = False
        self._prof = None
        self._range = None

    def start(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self._range = torch.profiler.record_function(WINDOW)
        self._range.__enter__()
        self.active = True

    def stop(self) -> None:
        """Close the slice; its events are reduced by :meth:`result`,
        after the window, so that the reduction takes none of its time."""
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._range.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self.active = False

    def result(self) -> "DeviceTrace | None":
        if self._prof is None:
            return None
        trace = DeviceTrace.from_events(
            self._prof.profiler.kineto_results.events())
        self._prof = None
        return trace


@dataclasses.dataclass
class HostRange:
    name: str
    start: int
    end: int
    tid: int


@dataclasses.dataclass
class DeviceOp:
    name: str
    start: int
    end: int
    launch: int | None      # host time of the runtime call that launched it
    tid: int | None


def _kind(ev) -> str:
    """The event's activity type; where this torch's events do not carry
    it, told from the name: a runtime or driver call is ``cuda*`` or
    ``cu[A-Z]*``."""
    kind = getattr(ev, "activity_type", None)
    if kind is not None:
        kind = kind()
        return kind if isinstance(kind, str) else str(kind)
    name = ev.name()
    if name.startswith("cuda") or (name.startswith("cu") and len(name) > 2
                                   and name[2].isupper()):
        return "cuda_runtime"
    if name.startswith("bench::"):
        return "user_annotation"
    return "cpu_op"


class DeviceTrace:
    """Host ranges and device operations of one profiled slice (times in
    ns on the profiler's clock)."""

    def __init__(self, ranges: list[HostRange], ops: list[HostRange],
                 device: list[DeviceOp], window: HostRange | None):
        self.ranges = ranges          # bench:: ranges
        self.host_ops = ops           # host operators (cpu_op)
        self.device = sorted(device, key=lambda d: d.start)
        self.window = window

    @classmethod
    def from_events(cls, events) -> "DeviceTrace":
        ranges, ops, launches, device = [], [], {}, []
        window = None
        for ev in events:
            on_device = ev.device_type() != torch.autograd.DeviceType.CPU
            kind = _kind(ev)
            start = int(ev.start_ns())
            end = start + int(ev.duration_ns())
            if on_device:
                if "annotation" in kind:
                    continue
                device.append(DeviceOp(ev.name(), start, end,
                                       ev.correlation_id(),
                                       ev.linked_correlation_id()))
                continue
            tid = int(ev.start_thread_id())
            if "runtime" in kind or "driver" in kind:
                launches[ev.correlation_id()] = (start, tid)
            elif ev.name() == WINDOW:
                window = HostRange(ev.name(), start, end, tid)
            elif ev.name().startswith("bench::"):
                ranges.append(HostRange(ev.name()[7:], start, end, tid))
            elif kind == "cpu_op":
                ops.append(HostRange(ev.name(), start, end, tid))
        for op in device:
            corr, linked = op.launch, op.tid
            found = launches.get(corr) or launches.get(linked)
            op.launch, op.tid = found if found else (None, None)
        return cls(ranges, ops, device, window)

    # -- the slice ---------------------------------------------------------

    @property
    def window_s(self) -> float:
        if self.window is None:
            return 0.0
        return (self.window.end - self.window.start) * 1e-9

    def _intervals(self) -> list[tuple[int, int]]:
        """The union of the device operations' intervals, clipped to the
        slice."""
        lo = self.window.start if self.window else -(1 << 62)
        hi = self.window.end if self.window else 1 << 62
        merged: list[list[int]] = []
        for op in self.device:
            s, e = max(op.start, lo), min(op.end, hi)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self._intervals()) * 1e-9

    @property
    def n_device_ops(self) -> int:
        return len(self.device)

    def under(self, name: str) -> list[DeviceOp]:
        """Device operations launched while a range ``name`` was open on
        the launching thread."""
        spans = sorted((r.start, r.end) for r in self.ranges
                       if r.name == name)
        if not spans:
            return []
        starts = [s for s, _ in spans]
        out = []
        for op in self.device:
            if op.launch is None:
                continue
            i = bisect.bisect_right(starts, op.launch) - 1
            if i >= 0 and op.launch <= spans[i][1]:
                out.append(op)
        return out

    def under_op(self, part: str) -> list[DeviceOp]:
        """Device operations launched from inside a host operator whose
        name holds ``part`` (an autograd node's backward runs on the
        engine's own thread, under the node's name)."""
        spans: dict[int, list[tuple[int, int]]] = {}
        for op in self.host_ops:
            if part in op.name:
                spans.setdefault(op.tid, []).append((op.start, op.end))
        for v in spans.values():
            v.sort()
        out = []
        for op in self.device:
            if op.launch is None or op.tid not in spans:
                continue
            v = spans[op.tid]
            i = bisect.bisect_right(v, (op.launch, 1 << 62)) - 1
            if i >= 0 and op.launch <= v[i][1]:
                out.append(op)
        return out

    def device_s_under(self, name: str) -> float:
        return sum(op.end - op.start for op in self.under(name)) * 1e-9

    def count(self, name: str) -> int:
        """How many ``name`` ranges the slice holds."""
        return sum(1 for r in self.ranges if r.name == name)

    def attributed_share(self) -> float:
        """Share of device operations tied to their launching call."""
        if not self.device:
            return 0.0
        return sum(op.launch is not None for op in self.device) \
            / len(self.device)

    # -- the breakdown -----------------------------------------------------

    def _host_at(self, t: int) -> str:
        """What the host's main thread was doing at ``t``: the innermost
        ``bench::`` range, then the outermost host operator, open at that
        time."""
        rng = [r for r in self.ranges if r.start <= t <= r.end]
        name = min(rng, key=lambda r: r.end - r.start).name if rng \
            else "outside the benchmark's ranges"
        i = bisect.bisect_right(self._top_starts, t) - 1
        if i >= 0 and t <= self._top_ops[i].end:
            name += " / " + self._top_ops[i].name
        return name

    def _top_level_ops(self) -> None:
        """The main thread's outermost host operators (disjoint, sorted)."""
        tid = self.window.tid if self.window else None
        top: list[HostRange] = []
        for op in sorted((o for o in self.host_ops
                          if tid is None or o.tid == tid),
                         key=lambda o: (o.start, -o.end)):
            if not top or op.start >= top[-1].end:
                top.append(op)
        self._top_ops = top
        self._top_starts = [o.start for o in top]

    def breakdown(self, top: int = 10) -> dict:
        by_op: dict[str, float] = collections.defaultdict(float)
        for op in self.device:
            by_op[op.name[:160]] += (op.end - op.start) * 1e-9
        device_ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
        gaps = []
        iv = self._intervals()
        if self.window is not None:
            edges = [self.window.start] + [x for se in iv for x in se] \
                + [self.window.end]
            for s, e in zip(edges[0::2], edges[1::2]):
                if e > s:
                    gaps.append((s, e))
        # the longest gaps first; each named by the host's work at its middle
        gaps.sort(key=lambda g: g[0] - g[1])
        self._top_level_ops()
        by_cause: dict[str, float] = collections.defaultdict(float)
        for s, e in gaps[:2000]:
            by_cause[self._host_at((s + e) // 2)] += (e - s) * 1e-9
        idle = sorted(by_cause.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in device_ops],
                "idle_gaps": [[k, v] for k, v in idle]}
