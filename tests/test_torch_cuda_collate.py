"""``pyramid_to_device``'s staged upload on a CUDA device, against the
conversion array by array (each table widened on the host, a pageable
copy each). Marked ``cuda``: without a card every test here skips (the
decision is taken in a fixture). On the card run
``python -m pytest --noconftest tests/test_torch_cuda_collate.py -m cuda -q``.

The pyramids are those of the five 4DMatch-F size clusters (1500 to 28000
points a cloud, the target 85% of the source) at the LNDP matcher's
KPConv settings, neighbourhood limits [16, 21, 27, 29] and power-of-two
pads, the shapes the learned evaluation uploads."""
from pathlib import Path

import numpy as np
import pytest
import torch

from deformationpyramid_tpu_torch.data import collate as tcol
from deformationpyramid_tpu_torch.data.synthetic import make_pair
from deformationpyramid_tpu_torch.match.backbone import KPFCN_ARCHITECTURE
from deformationpyramid_tpu_torch.match.config_loader import (
    landmark_config_from_yaml)
from deformationpyramid_tpu_torch.utils import timers

pytestmark = pytest.mark.cuda

REPO = Path(__file__).resolve().parents[1]
CLUSTERS = (1500, 3000, 8000, 15000, 28000)
LIMITS = [16, 21, 27, 29]
COUNTED = ("collate.staged", "collate.stage_misses")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def pyramids():
    kpfcn = landmark_config_from_yaml(
        str(REPO / "config" / "configs" / "correspondence.yaml")
    ).matcher.kpfcn
    out = []
    for i, n in enumerate(CLUSTERS):
        src, tgt, _ = make_pair(n=n, seed=i, deform=0.12)
        tgt = tgt[np.random.default_rng(i).permutation(n)[:int(0.85 * n)]]
        out.append(tcol.build_pair_pyramid(src, tgt, kpfcn,
                                           KPFCN_ARCHITECTURE, LIMITS,
                                           pad_to="pow2"))
    return out


@pytest.fixture
def fresh_staging(monkeypatch):
    """The module's staging buffers, empty; the counters from zero."""
    monkeypatch.setattr(tcol, "_STAGING", tcol._PinnedStaging())
    timers.reset_counters()
    yield
    timers.reset_counters()


def per_array(pyr, dev):
    """The conversion array by array: each table widened on the host, one
    copy each (``pyramid_to_device`` before it staged)."""
    def put(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return (t.long() if t.dtype == torch.int32 else t).to(dev)

    out = {f: [put(a) for a in getattr(pyr, f)] for f in tcol._FIELDS}
    out["features"] = put(pyr.features)
    return out


def assert_same(got, want):
    assert set(got) == set(want)
    for field in want:
        g, w = got[field], want[field]
        if field == "features":
            g, w = [g], [w]
        assert len(g) == len(w), field
        for a, b in zip(g, w):
            assert a.device == b.device, field
            assert a.dtype == b.dtype and a.shape == b.shape, field
            assert torch.equal(a, b), field


def _counts():
    return tuple(timers.counters().get(k, 0) for k in COUNTED)


def _profiled():
    return torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])


def test_staged_upload_bit_equal_at_the_clusters(dev, pyramids,
                                                 fresh_staging):
    for pyr in pyramids:
        assert_same(tcol.pyramid_to_device(pyr, dev), per_array(pyr, dev))
    assert _counts() == (0, 0)      # the profiler was off


def test_first_call_intact_and_misses_counted(dev, pyramids, fresh_staging):
    """The first upload allocates both buffers, a larger pyramid replaces
    both, and every call after finds its buffer large enough: one miss a
    growth. The first call's tensors are intact after the buffers were
    regrown and reused."""
    small, large = pyramids[0], pyramids[-1]
    want = per_array(small, dev)
    with _profiled():
        first = tcol.pyramid_to_device(small, dev)
        assert _counts() == (1, 1)
        tcol.pyramid_to_device(large, dev)
        assert _counts() == (2, 2)
        tcol.pyramid_to_device(large, dev)
        assert _counts() == (3, 2)
        for pyr in pyramids * 2:
            tcol.pyramid_to_device(pyr, dev)
        assert _counts() == (3 + 2 * len(pyramids), 2)
    torch.cuda.synchronize()
    assert_same(first, want)
    tcol.pyramid_to_device(large, dev)
    assert _counts() == (3 + 2 * len(pyramids), 2)   # the profiler is off


def test_staged_upload_does_not_synchronize(dev, pyramids, fresh_staging):
    """Once the buffers hold the largest pyramid, an upload makes no call
    that synchronises the host with the device (the per-array path's
    pageable copies each do)."""
    tcol.pyramid_to_device(pyramids[-1], dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [tcol.pyramid_to_device(pyr, dev) for pyr in pyramids]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for pyr, out in zip(pyramids, outs):
        assert_same(out, per_array(pyr, dev))
