"""Kernels C14 and C12 on C1's split-database sweep, emulated in torch on the
CPU: the database split into contiguous slices, each slice's first-index
minimum, the slices' (min, argmin) pairs merged by the (d, i) rule; and
C12's finish, C6's bucket pass, as adds in increasing column order.

C14 (``csrc/nn_argmin.cu``) is the x -> y half of C1's sweep
(``csrc/nn_sweep.cuh``): 16 slices a query where its blocks fill the card,
32 (two lane groups a warp) where they would not, 8 to 64 in the variants
timed. C12 (``csrc/chamfer_fused.cu``) runs the same sweep in both
directions with its own staging: an invalid candidate keeps its +BIG
(3e38) term in the float4's w, added after the query's term for a row and
before it for a column (the row term, w's, always first), so a query whose
candidates are all invalid gets 3e38 (or +inf where BIG + BIG overflows,
a slice then keeping (+inf, NONE), turned into 0). The merge rule is
associative and commutative, so any number of slices merged in any order
must give exactly what the plain versions give (``torch.min``, the first
index of a tie). The inputs are ``chip_smoke.C12_EDGE_CASES`` and
``chip_smoke.C1_EDGE_CASES``, points on a 1/32 grid where every distance is
exact, on which the card's kernels are held bit-equal to the plain
versions too.
"""
import random

import numpy as np
import pytest
import torch

import chip_smoke
from deformationpyramid_tpu_torch.ops import chamfer_fused as tcf
from deformationpyramid_tpu_torch.ops import knn as tknn

NONE = 2 ** 31 - 1           # NN_NONE in csrc/nn_sweep.cuh
BIG = 3.0e38                 # CF_BIG in csrc/chamfer_fused.cu
C14_SLICES = (1, 8, 16, 32, 64)   # 16 / 32: one / two lane groups a warp
C12_SLICES = (1, 3, 16, 64)       # 16 is the kernel's CF_WARPS


def _sqdist(q, db):
    """The kernels' distance: ((dx*dx + dy*dy) + dz*dz), no contraction."""
    diff = q[:, None, :] - db[None, :, :]
    return (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]) \
        + diff[..., 2] * diff[..., 2]


def _split_min(ds, slices, order_seed):
    """The sweep over staged distances ``ds`` [queries, ndb]: each slice's
    running strict '<' from +inf in index order (the first index of the
    smallest distance below +inf, else (+inf, NONE)), the slices merged by
    the (d, i) rule in a shuffled order, NONE turned into 0."""
    ds = torch.where(ds < torch.inf, ds, torch.inf)   # NaN never wins
    ndb = ds.shape[1]
    per = -(-ndb // slices)
    parts = []
    for s in range(slices):
        lo, hi = min(s * per, ndb), min(s * per + per, ndb)
        if hi <= lo:
            parts.append((torch.full((ds.shape[0],), torch.inf),
                          torch.full((ds.shape[0],), NONE,
                                     dtype=torch.int64)))
            continue
        v, i = torch.min(ds[:, lo:hi], dim=1)
        parts.append((v, torch.where(v < torch.inf, i + lo, NONE)))
    random.Random(order_seed).shuffle(parts)
    d, i = parts[0]
    for dp, ip in parts[1:]:
        take = (dp < d) | ((dp == d) & (ip < i))
        d, i = torch.where(take, dp, d), torch.where(take, ip, i)
    return d, torch.where(i == NONE, 0, i)


def _term(valid):
    return torch.where(valid, 0.0, BIG)


def _c12_staged(w, y, wv, yv, rows: bool):
    """C12's distances as its sweep computes them: rows (queries w,
    candidates y) ((sq + w's term) + y's term); columns (queries y,
    candidates w) ((sq + w's term) + y's term), the subtraction the other
    way round (the squares are sign-symmetric)."""
    if rows:
        return (_sqdist(w, y) + _term(wv)[:, None]) + _term(yv)[None, :]
    return (_sqdist(y, w) + _term(wv)[None, :]) + _term(yv)[:, None]


def _plain_d(w, y, wv, yv):
    """``chamfer_fused_plain``'s [N, M] distance, written as it writes it."""
    d = ((w[:, None, 0] - y[None, :, 0]) ** 2
         + (w[:, None, 1] - y[None, :, 1]) ** 2) \
        + (w[:, None, 2] - y[None, :, 2]) ** 2
    return (d + torch.where(wv, 0.0, BIG)[:, None]) \
        + torch.where(yv, 0.0, BIG)[None, :]


@pytest.mark.parametrize("tag", sorted(chip_smoke.C12_EDGE_CASES))
def test_c12_split_sweep_is_the_plain_selection(tag):
    """C12's sweep with its +BIG staging, both directions, at 1 to 64
    slices: rmin / rarg bit-equal to ``chamfer_fused_plain``'s, cmin / carg
    to the column minima of its distance matrix."""
    w, y, wv, yv = chip_smoke.c12_edge_input(torch.device("cpu"), tag)
    _, _, rmin, rarg = tcf.chamfer_fused_plain(w, y, wv, yv,
                                               chip_smoke.C12_EDGE_TRUNC)
    d = _plain_d(w, y, wv, yv)
    assert torch.equal(torch.clamp_min(d.min(1).values, 0.0), rmin)
    assert torch.equal(d.min(1).indices, rarg)
    cmin, carg = torch.min(d, dim=0)
    for slices in C12_SLICES:
        r = _split_min(_c12_staged(w, y, wv, yv, True), slices, slices)
        c = _split_min(_c12_staged(w, y, wv, yv, False), slices, slices + 1)
        assert torch.equal(torch.clamp_min(r[0], 0.0), rmin), (tag, slices)
        assert torch.equal(r[1], rarg), (tag, slices)
        assert torch.equal(c[0], cmin), (tag, slices)
        assert torch.equal(c[1], carg), (tag, slices)


@pytest.mark.parametrize("tag", sorted(chip_smoke.C1_EDGE_CASES))
def test_c14_split_sweep_is_the_plain_selection(tag):
    """C14's sweep (C1's staging: an invalid row as NaN) at 1 to 64
    slices, with y's mask and without one: bit-equal to
    ``nn_argmin_plain``."""
    x, y, _, yv = chip_smoke.c1_edge_input(torch.device("cpu"), tag)
    for mask in (yv, None):
        ref = tknn.nn_argmin_plain(x, y, mask)
        ds = _sqdist(x, y)
        if mask is not None:
            ds = torch.where(mask[None], ds, torch.nan)
        for slices in C14_SLICES:
            got = _split_min(ds, slices, slices)
            assert torch.equal(got[0], ref[0]), (tag, slices)
            assert torch.equal(got[1], ref[1]), (tag, slices)


def _bucket_cgrad(w, y, cmin, carg, trunc):
    """C12's finish in float32, as an explicit loop over the columns in
    increasing j: each column's (s_j, s_j y_j) (the sweep's float4) added
    to its winning row from zero, then cgrad = w * cnt - sum s_j y_j."""
    w, y = w.numpy(), y.numpy()
    cmin, carg = cmin.numpy(), carg.numpy()
    acc = np.zeros((w.shape[0], 4), dtype=np.float32)
    for j in range(y.shape[0]):
        s = np.float32(1.0) / np.sqrt(np.maximum(cmin[j], np.float32(1e-16))) \
            if cmin[j] < np.float32(trunc) else np.float32(0.0)
        term = np.array([s, s * y[j, 0], s * y[j, 1], s * y[j, 2]],
                        dtype=np.float32)
        acc[carg[j]] = acc[carg[j]] + term
    return torch.from_numpy(w * acc[:, :1] - acc[:, 1:])


@pytest.mark.parametrize("tag", sorted(chip_smoke.C12_EDGE_CASES))
def test_c12_bucket_order_is_the_plain_cgrad(tag):
    """C12's finish (C6's bucket pass: every column's terms added to its
    row in increasing column order, from zero) gives
    ``chamfer_fused_plain``'s cgrad bit for bit (index_add_ on the CPU
    adds in index order)."""
    w, y, wv, yv = chip_smoke.c12_edge_input(torch.device("cpu"), tag)
    trunc = chip_smoke.C12_EDGE_TRUNC
    _, cgrad, _, _ = tcf.chamfer_fused_plain(w, y, wv, yv, trunc)
    cmin, carg = torch.min(_plain_d(w, y, wv, yv), dim=0)
    assert torch.equal(_bucket_cgrad(w, y, cmin, carg, trunc), cgrad)


def test_c12_edge_cases_cover_what_the_sweep_must_handle():
    """The cases hold what they are for: exact ties across slices, rows
    that meet only BIG terms (3e38, or +inf where two meet), invalid
    queries whose first valid candidate sits in a later slice, every
    column won by row 0, n != m both ways."""
    cpu = torch.device("cpu")
    w, y, wv, yv = chip_smoke.c12_edge_input(cpu, "ties 2000 x 2000")
    d = _plain_d(w, y, wv, yv)
    ties = (d == d.min(1, keepdim=True).values).sum(1)
    assert (ties > 1).float().mean() > 0.5
    for tag in ("rows invalid 777 x 2000", "columns invalid 2000 x 777"):
        args = chip_smoke.c12_edge_input(cpu, tag)
        d = _plain_d(*args)
        assert (d.min(1).values >= BIG).all() and (d.min(0).values >= BIG).all()
        assert torch.isinf(d).any()
    w, y, wv, yv = chip_smoke.c12_edge_input(cpu,
                                             "invalid queries 777 x 2000")
    d = _plain_d(w, y, wv, yv)
    assert not wv[:700].any() and wv[700:].all()
    assert (d.min(1).indices[:700] == 1300).all()         # slice 10 of 16
    assert (d.min(0).indices[:1300] == 700).all()         # slice 14 of 16
    w, y, wv, yv = chip_smoke.c12_edge_input(cpu, "one row 2000 x 2000")
    assert (torch.min(_plain_d(w, y, wv, yv), dim=0).indices == 0).all()
    sizes = {(n, m) for n, m, _ in chip_smoke.C12_EDGE_CASES.values()}
    assert (1, 1) in sizes and (63, 777) in sizes
    assert any(n > m for n, m in sizes) and any(n < m for n, m in sizes)
