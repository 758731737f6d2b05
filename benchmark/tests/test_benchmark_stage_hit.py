"""``stage_hit_pct`` against a hand-built slice of four uploads: None
without the port's staging counters (a port before it staged), 100 where
every upload found its buffer, 75 where one of the four allocated."""
import pytest

from benchmark import core
from benchmark.tracing import DeviceOp, DeviceTrace, HostRange
from deformationpyramid_tpu_torch.utils import timers

MS = 1_000_000
MAIN, OTHER = 1, 2


def _run():
    ops = [HostRange("dp::collate.to_device", k * 10 * MS, (k * 10 + 1) * MS,
                     MAIN) for k in range(4)]
    # another thread's range of the same name is not a pair's upload
    ops.append(HostRange("dp::collate.to_device", 0, 40 * MS, OTHER))
    device = [DeviceOp("kernel", 2 * MS, 5 * MS, MS, MAIN)]
    run = core.Run(trace=True)
    run.trace = DeviceTrace([], ops, device,
                            HostRange("bench::window", 0, 40 * MS, MAIN))
    return run


def _counters(monkeypatch, counts):
    monkeypatch.setattr(timers, "counters", lambda: dict(counts))


def read(run):
    return core.metric_reader("stage_hit_pct")(run)


def test_none_without_the_counters(monkeypatch):
    _counters(monkeypatch, {"early_stop.noops": 3})
    assert read(_run()) is None
    monkeypatch.delattr(timers, "counters")
    assert read(_run()) is None
    assert read(core.Run(trace=True)) is None


@pytest.mark.parametrize("counts,want", [
    ({"collate.staged": 4}, 100.0),
    ({"collate.staged": 4, "collate.stage_misses": 0}, 100.0),
    ({"collate.staged": 4, "collate.stage_misses": 1}, 75.0),
])
def test_share_of_uploads_that_hit(monkeypatch, counts, want):
    _counters(monkeypatch, counts)
    assert read(_run()) == pytest.approx(want, abs=1e-12)
