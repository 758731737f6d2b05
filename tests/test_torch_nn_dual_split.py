"""Kernel C1's selection, emulated in torch on the CPU: the database split
into contiguous slices, each slice's first-index minimum, the slices'
(min, argmin) pairs merged by the (d, i) rule.

C1 (``csrc/nn_dual.cu``) gives each warp of a block one contiguous slice
of the database in index order; a warp keeps its running (min, argmin)
with a strict '<' over its slice (an invalid row is staged as NaN and
never passes), a slice without a winner keeps (+inf, NONE), and the
block merges the warps' pairs by ``d < d' or (d == d' and i < i')``, NONE
turned back into 0 at the end. That rule is associative and commutative,
so any number of slices merged in any order must give exactly what the
plain version gives (``nn_argmin_dual_plain``: ``torch.min``, the first
index of a tie, and (+inf, 0) for a query without a valid candidate).
The inputs are ``chip_smoke.C1_EDGE_CASES``, on which the card's C1 is held
bit-equal to the plain version too: points on a 1/32 grid (every distance
exact in float32), exact ties across slice boundaries, slices and whole
clouds without a valid row, +inf rows, sizes 1 to 2000 with n != m.
"""
import random

import pytest
import torch

import chip_smoke
from deformationpyramid_tpu_torch.ops import knn as tknn

NONE = 2 ** 31 - 1      # NN_NONE in csrc/nn_dual.cu
SLICES = (1, 3, 16, 64)  # 16 is the kernel's NN_WARPS; 64 leaves slices
                         # empty at 63 rows


def _dist(q, db):
    """The kernel's distance: ((dx*dx + dy*dy) + dz*dz), no contraction."""
    diff = q[:, None, :] - db[None, :, :]
    return (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]) \
        + diff[..., 2] * diff[..., 2]


def _slice_min(ds, lo, hi):
    """One warp's scan of columns [lo, hi) of the staged distances ``ds``:
    the running strict '<' from +inf in index order keeps the first index
    of the smallest distance below +inf."""
    if hi <= lo:
        return (torch.full((ds.shape[0],), torch.inf),
                torch.full((ds.shape[0],), NONE, dtype=torch.int64))
    v, i = torch.min(ds[:, lo:hi], dim=1)
    return v, torch.where(v < torch.inf, i + lo, NONE)


def _merge(a, b):
    (da, ia), (db, ib) = a, b
    take = (db < da) | ((db == da) & (ib < ia))
    return torch.where(take, db, da), torch.where(take, ib, ia)


def _split_nn(q, db, valid, slices, order_seed):
    # invalid rows stage as NaN; NaN and +inf never pass the '<'
    ds = torch.where(valid[None], _dist(q, db), torch.nan)
    ds = torch.where(ds < torch.inf, ds, torch.inf)
    ndb = db.shape[0]
    per = -(-ndb // slices)
    parts = [_slice_min(ds, min(s * per, ndb), min(s * per + per, ndb))
             for s in range(slices)]
    random.Random(order_seed).shuffle(parts)
    best = parts[0]
    for p in parts[1:]:
        best = _merge(best, p)
    return best[0], torch.where(best[1] == NONE, 0, best[1])


@pytest.mark.parametrize("tag", sorted(chip_smoke.C1_EDGE_CASES))
def test_split_database_merge_is_the_first_index_minimum(tag):
    x, y, xv, yv = chip_smoke.c1_edge_input(torch.device("cpu"), tag)
    ref = tknn.nn_argmin_dual_plain(x, y, xv, yv)
    for slices in SLICES:
        got = (*_split_nn(x, y, yv, slices, slices),
               *_split_nn(y, x, xv, slices, slices + 1))
        for name, a, b in zip(("d_xy", "i_xy", "d_yx", "i_yx"), got, ref):
            assert torch.equal(a, b), (tag, slices, name)


def test_edge_cases_cover_what_the_merge_must_handle():
    """The cases hold what they are for: ties across slice boundaries, a
    slice without a valid row, queries without any candidate, +inf
    candidates, and n != m."""
    cpu = torch.device("cpu")
    x, y, _, yv = chip_smoke.c1_edge_input(cpu, "ties 2000 x 2000")
    d = _dist(x, y)
    dmin = torch.where(yv[None], d, torch.inf).min(1).values
    ties = (torch.where(yv[None], d, torch.inf) == dmin[:, None]).sum(1)
    assert (ties > 1).float().mean() > 0.5
    _, _, _, yv = chip_smoke.c1_edge_input(cpu, "invalid run 777 x 2000")
    assert not yv[:700].any() and yv[700:].any()
    d_xy, i_xy, _, _ = tknn.nn_argmin_dual_plain(
        *chip_smoke.c1_edge_input(cpu, "none valid 63 x 777"))
    assert torch.isinf(d_xy).all() and not i_xy.any()
    x, y, _, _ = chip_smoke.c1_edge_input(cpu, "inf rows 777 x 2000")
    inf_rows = torch.isinf(y).all(1)
    assert 0 < int(inf_rows.sum()) < 2000
    _, i_xy, d_yx, i_yx = tknn.nn_argmin_dual_plain(x, y)
    assert not inf_rows[i_xy].any()
    assert torch.isinf(d_yx[inf_rows]).all() and not i_yx[inf_rows].any()
    sizes = {(n, m) for n, m, _ in chip_smoke.C1_EDGE_CASES.values()}
    assert {1, 63, 777, 2000} <= {s for nm in sizes for s in nm}
    assert any(n != m for n, m in sizes)
