"""``graph_hit_pct.transfer`` against a hand-built slice of two transfers:
None without the port's level-loop counters (a port before the level
graph), 100 where every block was a replay, the share where some ran
eagerly, 0 where none was a replay."""
import pytest

from benchmark import core
from benchmark.tracing import DeviceOp, DeviceTrace, HostRange
from deformationpyramid_tpu_torch.utils import timers

MS = 1_000_000
MAIN, OTHER = 1, 2


def _run():
    ops = [HostRange("dp::solve", k * 10 * MS, (k * 10 + 8) * MS, MAIN)
           for k in range(2)]
    # another thread's range of the same name is not a transfer's solve
    ops.append(HostRange("dp::solve", 0, 20 * MS, OTHER))
    device = [DeviceOp("kernel", 2 * MS, 5 * MS, MS, MAIN)]
    run = core.Run(trace=True)
    run.trace = DeviceTrace([], ops, device,
                            HostRange("bench::window", 0, 20 * MS, MAIN))
    return run


def _counters(monkeypatch, counts):
    monkeypatch.setattr(timers, "counters", lambda: dict(counts))


def read(run):
    return core.metric_reader("graph_hit_pct.transfer")(run)


def test_none_without_the_counters(monkeypatch):
    _counters(monkeypatch, {"early_stop.noops": 3})
    assert read(_run()) is None
    _counters(monkeypatch, {"fused_level.blocks": 0})
    assert read(_run()) is None
    monkeypatch.delattr(timers, "counters")
    assert read(_run()) is None
    assert read(core.Run(trace=True)) is None


@pytest.mark.parametrize("counts,want", [
    ({"fused_level.blocks": 80, "fused_level.graph_replays": 80}, 100.0),
    ({"fused_level.blocks": 80, "fused_level.graph_replays": 60,
      "fused_level.graph_captures": 0}, 75.0),
    ({"fused_level.blocks": 80}, 0.0),
])
def test_share_of_blocks_replayed(monkeypatch, counts, want):
    _counters(monkeypatch, counts)
    assert read(_run()) == pytest.approx(want, abs=1e-12)
