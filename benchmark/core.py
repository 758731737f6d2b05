"""The harness: one run of one cell.

``BENCHMARK.json`` names the cells, the configurations and the metrics;
the files of each are found by name (see the package docstring). A run
makes its inputs and weights from ``--seed``, warms up every shape its
traffic uses (``setup_s``), drives the port for ``--seconds``, then checks
what the window produced against the plain reference and prints one JSON
line: with ``--trace 0`` the cell's end-to-end metrics, with ``--trace 1``
its per-layer metrics, read from a profiled slice of the window.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Any, Callable

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"
# What may not be loaded in the process that prints a result, by whole
# top-level module name: the port's own name begins with the last one.
FORBIDDEN = ("jax", "jaxlib", "flax", "deformationpyramid_tpu")
PROGRAM = "deformationpyramid_tpu_torch"


class NoDevice(RuntimeError):
    """No card, or fewer than the cell asks for: the run prints no result."""


@dataclasses.dataclass
class Check:
    """One number compared with the reference and its limit (lower is
    better; a number that is not finite fails)."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


class Spec:
    """``BENCHMARK.json`` and the files its names point at."""

    def __init__(self, path: Path = ROOT / "BENCHMARK.json"):
        with open(path) as f:
            self.data = json.load(f)

    def cell(self, name: str) -> dict:
        for cell in self.data["workloads"]:
            if cell["name"] == name:
                return cell
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for cfg in self.data["configs"]:
            if cfg["name"] == name:
                with open(ROOT / cfg["file"]) as f:
                    return json.load(f)
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    @staticmethod
    def traffic(name: str) -> dict:
        with open(BENCH / "traffic" / f"{name}.json") as f:
            return json.load(f)

    def metrics(self, kind: str, cell: str) -> list[dict]:
        """The ``end_to_end`` or ``per_layer`` metrics that ``cell``
        reports: those that list it, and those that list no cells."""
        return [m for m in self.data[kind]
                if cell in m.get("workloads", [cell])]


def load_file(path: Path, name: str):
    """A module of the benchmark by its file path (metric readers are
    named after metrics, whose names hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def driver_class(kind: str):
    return load_file(BENCH / "drivers" / f"{kind}.py",
                     f"benchmark_driver_{kind}").Driver


def metric_reader(name: str) -> Callable[["Run"], float | None]:
    return load_file(BENCH / "metrics" / f"{name}.py",
                     "benchmark_metric_" + name.replace(".", "_")).read


def forbidden_modules() -> list[str]:
    """Top-level names in ``sys.modules`` that a run may not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Run:
    """What a run hands its driver and its metric readers: host spans,
    counters, and (``--trace 1``) the device trace of the profiled slice.

    A span is timed on the host clock; while the profiler records, it is
    also a ``bench::<name>`` range, so that the trace can say which device
    work each range launched.
    """

    def __init__(self, trace: bool):
        self.trace_requested = trace
        self.spans: dict[str, list[float]] = {}
        self.counters: dict[str, float] = {}
        self.trace = None          # tracing.DeviceTrace of the slice
        self.tracer = None         # tracing.Tracer while a slice records
        self.setup_s = 0.0
        self.window_s = 0.0

    @property
    def tracing(self) -> bool:
        return self.tracer is not None and self.tracer.active

    @contextlib.contextmanager
    def span(self, name: str):
        """A host span named ``name`` (seconds kept in ``spans``)."""
        rng = None
        if self.tracing:
            import torch
            rng = torch.profiler.record_function(f"bench::{name}")
            rng.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans.setdefault(name, []).append(time.perf_counter() - t0)
            if rng is not None:
                rng.__exit__(None, None, None)

    def count(self, name: str, value: float = 1.0) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + value

    def start_trace(self) -> None:
        """Start the profiled slice (no-op unless ``--trace 1``, and only
        once a run)."""
        if self.trace_requested and self.tracer is None:
            from . import tracing
            self.tracer = tracing.Tracer()
            self.tracer.start()

    def stop_trace(self) -> None:
        if self.tracing:
            self.tracer.stop()

    def reduce_trace(self) -> None:
        """The profiled slice's events, reduced once the window is over."""
        if self.tracer is not None:
            self.stop_trace()
            self.trace = self.tracer.result()


def require_device(chips: int):
    """The card the cell runs on; raises :class:`NoDevice` without one."""
    import torch

    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is false: the benchmark "
                       "measures the card and never falls back to the CPU")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"the cell asks for {chips} cards, "
                       f"{torch.cuda.device_count()} are visible")
    torch.cuda.set_device(0)
    # The CUDA context is the runtime's, made once a process whatever it
    # runs; it is made here, with the look for the card, and not timed as
    # the cell's set-up (it took 7-10 s of host time, moving with the
    # host's load).
    torch.zeros(1, device="cuda:0")
    torch.cuda.synchronize(0)
    return torch.device("cuda", 0)


def device_info(device, chips: int, run: Run) -> dict:
    import torch

    if device.type != "cuda":
        info = {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    else:
        info = {"platform": "gpu",
                "kind": torch.cuda.get_device_name(device),
                "count": chips,
                "memory_peak_bytes": max(
                    torch.cuda.max_memory_allocated(d)
                    for d in range(chips))}
    if run.trace is not None:
        info["busy_s"] = run.trace.busy_s
        info["window_s"] = run.trace.window_s
    return info


def power_line(device) -> str:
    """The card's name and power limit, beside every number."""
    import subprocess

    if device.type != "cuda":
        return "cpu"
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", str(device.index or 0)],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable: {exc}"


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool,
             device=None, traffic_overrides: dict | None = None,
             control: str | None = None, spec: Spec | None = None,
             config_overrides: dict | None = None) -> dict:
    """One run of one cell; returns the result dict (the JSON line).

    ``device`` None looks for the card (and raises :class:`NoDevice`
    without one); the tests pass ``torch.device("cpu")`` with
    ``traffic_overrides`` (and ``config_overrides``) that shrink the
    work, to drive the rest of a run. ``control`` puts the reference, at
    the precision one step below the configuration's, in the program's
    place for the compared stages (never in the benchmark's own runs).
    """
    import torch

    spec = spec or Spec()
    cell = spec.cell(cell_name)
    chips = int(cell["chips"])
    if device is None:
        device = require_device(chips)
    cfg = dict(spec.config(cell["config"]), **(config_overrides or {}))
    traffic = dict(spec.traffic(cell["traffic"]), **(traffic_overrides or {}))
    run = Run(trace)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    driver = driver_class(traffic["driver"])(run, cfg, traffic, int(seed),
                                             device, control=control)
    driver.setup()
    sync()
    run.setup_s = time.perf_counter() - t0
    driver.window(float(seconds))
    sync()
    run.stop_trace()
    dev_peak = device_info(device, chips, run)["memory_peak_bytes"]
    run.reduce_trace()
    driver.after_window()
    dev = dict(device_info(device, chips, run), memory_peak_bytes=dev_peak)
    loaded = forbidden_modules()
    if loaded:
        raise RuntimeError("the run loaded " + ", ".join(loaded)
                           + ": the benchmark measures the port alone")
    checks = driver.check()
    correct = bool(checks) and all(c.ok for c in checks)

    metrics: dict[str, dict] = {}
    if not trace:
        values = dict(driver.end_to_end(), setup_s=run.setup_s)
        for m in spec.metrics("end_to_end", cell_name):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        for m in spec.metrics("per_layer", cell_name):
            value = metric_reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result: dict[str, Any] = {
        "correct": correct,
        "attempted": driver.attempted,
        "failed": driver.failed,
        "metrics": metrics,
        "device": dev,
    }
    if run.trace is not None:
        result["breakdown"] = run.trace.breakdown()
    result["power"] = power_line(device)
    result["diag"] = dict(driver.diagnostics(), setup_s=run.setup_s)
    if run.trace is not None:
        result["diag"]["attributed_share"] = run.trace.attributed_share()
        result["diag"]["device_ops"] = run.trace.n_device_ops
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in checks}
    return result


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", default=None,
                    help="the reference one precision below the "
                         "configuration's in the program's place (the "
                         "control of the comparison; never a measurement)")
    args = ap.parse_args(argv)
    try:
        result = run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace), control=args.control)
    except NoDevice as exc:
        print(f"benchmark: {exc}", file=sys.stderr)
        return 2
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(_finite(result), allow_nan=False), flush=True)
    return 0


def _finite(obj):
    """The result with every number that is not finite (a check with no
    answer to compare reads inf) as null: JSON has no infinity."""
    if isinstance(obj, dict):
        return {k: _finite(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_finite(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    return obj
