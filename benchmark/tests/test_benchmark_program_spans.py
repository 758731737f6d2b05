"""The readers of the port's ``dp::`` spans and counters
(``benchmark/program_spans.py`` and the metrics on it) against a
hand-built slice whose idle, device time and launches are worked out by
hand, times in ms:

    device ops (start-end, launched at, thread):
        d1 1-3 @0.5 main (C5), d2 2-4 @1.5 main, d3 6-7 @5.5 engine,
        d4 9-12 @8.5 main (C5; past the slice's end at 10),
        d5 7.5-8 (no launch)
    busy, clipped to the slice [0, 10]: 1-4, 6-7, 7.5-8, 9-10
"""
import pytest

from benchmark import core, program_spans
from benchmark.tracing import DeviceOp, DeviceTrace, HostRange
from deformationpyramid_tpu_torch.utils import timers

MS = 1_000_000
MAIN, ENGINE, OTHER = 1, 2, 3

PORT_METRICS = ("to_device_idle_ms", "landmark_idle_ms", "matching_ms",
                "neco_ms", "solve_idle_ms", "solve_launches_per_pair",
                "update_idle_ms", "train_launches_per_step",
                "solve_noops_per_pair", "attention_ms")
C5 = "void ldmk_iteration_kernel<0, 0>(float*, float*)"


def _r(name, a, b, tid=MAIN):
    return HostRange(name, round(a * MS), round(b * MS), tid)


def _d(a, b, launch, tid, name="kernel"):
    return DeviceOp(name, round(a * MS), round(b * MS),
                    None if launch is None else round(launch * MS), tid)


def _slice(with_spans=True):
    device = [_d(1, 3, 0.5, MAIN, C5), _d(2, 4, 1.5, MAIN),
              _d(6, 7, 5.5, ENGINE), _d(9, 12, 8.5, MAIN, C5),
              _d(7.5, 8, None, None)]
    ops = [_r("aten::to", 0.2, 0.4), _r("aten::add", 5.5, 5.6)]
    if with_spans:
        ops += [
            # two pairs' copies; the gap 4-6 straddles the second's start
            _r("dp::collate.to_device", 0, 2.5),
            _r("dp::collate.to_device", 5, 6.5),
            _r("dp::landmark", 0, 8.2),
            _r("dp::landmark.matching", 1, 2),
            _r("dp::attention", 1.2, 1.8),
            _r("dp::landmark.neco", 5, 6),
            # the second range runs past the slice's end
            _r("dp::solve", 8.2, 9.5),
            _r("dp::solve", 9.5, 11),
            # another thread's range of the same name is not the main's
            _r("dp::solve", 0, 10, tid=OTHER),
            _r("dp::train.update", 3.5, 6.2),
            _r("dp::train.step", 0, 9),
        ]
    return DeviceTrace([], ops, device, _r("bench::window", 0, 10))


def _run(trace):
    run = core.Run(trace=True)
    run.trace = trace
    return run


@pytest.fixture
def port_counters(monkeypatch):
    counts = {"early_stop.noops": 70}
    monkeypatch.setattr(timers, "counters", lambda: dict(counts))
    return counts


# idle: to_device 0-2.5 is idle over 0-1 and 5-6.5 over 5-6 (the gap 4-6
# straddles its start), 1.0 a range; landmark 0-8.2: 8.2 - (3 + 1 + 0.5).
# solve: 8.2-9.5 holds 0.8 (9-9.5 busy), 9.5-11 clipped to 9.5-10, busy.
# update 3.5-6.2: 2.7 - (0.5 + 0.2). matching: d2 (launched at 1.5), 2 ms;
# neco: d3, launched from the engine's thread, 1 ms; step 0-9: d1-d4.
# attention 1.2-1.8: d2 again. C5 under the main thread's dp::solve: d4
# alone (d1 launched under the other thread's range), over 2 pairs; the
# 70 no-ops over the same 2.
EXPECTED = {"to_device_idle_ms": 1.0, "landmark_idle_ms": 3.7,
            "matching_ms": 2.0, "neco_ms": 1.0, "solve_idle_ms": 0.4,
            "solve_launches_per_pair": 0.5, "update_idle_ms": 2.0,
            "train_launches_per_step": 4.0, "solve_noops_per_pair": 35.0,
            "attention_ms": 2.0}


@pytest.mark.parametrize("name", PORT_METRICS)
def test_reader_by_hand(name, port_counters):
    value = core.metric_reader(name)(_run(_slice()))
    assert value == pytest.approx(EXPECTED[name], abs=1e-9)


@pytest.mark.parametrize("name", PORT_METRICS)
def test_reader_finds_nothing_without_the_spans(name, monkeypatch):
    """The port before it had spans and counters: no ``dp::`` range, no
    ``timers.counters``; each reader gives None and raises nothing."""
    monkeypatch.delattr(timers, "counters")
    assert core.metric_reader(name)(_run(_slice(with_spans=False))) is None


@pytest.mark.parametrize("name", PORT_METRICS)
def test_reader_finds_nothing_without_a_trace(name, port_counters):
    assert core.metric_reader(name)(core.Run(trace=True)) is None


def test_ranges_main_thread_sorted():
    trace = _slice()
    assert program_spans.ranges(trace, "dp::solve") == [
        (round(8.2 * MS), round(9.5 * MS)), (round(9.5 * MS), 11 * MS)]
    assert program_spans.ranges(trace, "dp::nothing") == []


def test_counter_ratio_needs_pairs(port_counters):
    """A counter a range needs both: no ``dp::solve`` range, or no such
    counter, reads nothing."""
    assert program_spans.counter_per_range(
        _slice(with_spans=False), "early_stop.noops", "dp::solve") is None
    assert program_spans.counter_per_range(
        _slice(), "solve.pairs", "dp::solve") is None
    assert program_spans.counter_per_range(
        _slice(), "early_stop.noops", "dp::solve") == 35.0
