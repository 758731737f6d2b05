"""The port's one-direction 1-NN (``ops/knn.nn_argmin``, whose plain
version runs here; kernel C14 on the card) against the JAX package's
``nn_argmin_xla``, on the CPU, on the same numpy inputs.

The port computes the exact difference form; JAX's ``|x|^2 + |y|^2 - 2 x.y``
carries rounding of a few ulps of |x|^2 + |y|^2, about 1e-6 absolute in d^2
on camera-frame clouds (|x| ~ 1.5 m), the order of a 1 mm pixel spacing
squared. So indices must be equal except at near-ties, where the two
candidates' exact squared distances (float64) agree to that rounding or to
3e-4 relative; the port's pick is never farther than JAX's beyond it; the
distances agree with JAX's within 1e-5 and with the float64 distance of the
port's own pick within 1e-6 relative. The chunked plain version is
bit-equal to the unchunked one; an exact tie goes to the first index.
"""
import re
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from deformationpyramid_tpu.ops import knn as jknn
from deformationpyramid_tpu_torch.ops import cuda_lib
from deformationpyramid_tpu_torch.ops import knn as tknn

PORT = Path(tknn.__file__).resolve().parents[1]


def _check(x, y, valid, got, ref):
    sq, idx = (a.numpy() for a in got)
    rsq, ridx = (np.asarray(a) for a in ref)
    x64, y64 = x.astype(np.float64), y.astype(np.float64)
    d_port = ((x64 - y64[idx]) ** 2).sum(-1)
    d_jax = ((x64 - y64[ridx]) ** 2).sum(-1)
    # a few ulps of the expanded form's |x|^2 + |y|^2
    slack = np.maximum(3e-4 * d_jax, 8 * 2.0 ** -24 * (
        (x64 ** 2).sum(-1) + (y64[ridx] ** 2).sum(-1)))
    flips = idx != ridx
    assert (np.abs(d_port - d_jax)[flips] <= slack[flips]).all()
    assert (d_port <= d_jax + slack).all()
    if valid is not None:
        assert valid[idx].all()
    assert np.abs(sq - rsq).max() <= 1e-5
    assert (np.abs(sq - d_port) <= 1e-6 * d_port + 1e-12).all()
    return int(flips.sum())


@pytest.mark.parametrize("n,m,masked", [(1, 1, False), (37, 500, True),
                                        (300, 77, False), (513, 1025, True)])
def test_nn_argmin_matches_jax_random(n, m, masked):
    rng = np.random.default_rng(n + m)
    x = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    y = rng.uniform(-0.5, 0.5, (m, 3)).astype(np.float32)
    valid = None
    if masked:
        valid = rng.random(m) > 0.3
        valid[0] = True
    ref = jknn.nn_argmin_xla(jnp.asarray(x), jnp.asarray(y),
                             None if valid is None else jnp.asarray(valid))
    got = tknn.nn_argmin(torch.from_numpy(x), torch.from_numpy(y),
                         None if valid is None else torch.from_numpy(valid))
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int64
    assert got[0].shape == got[1].shape == (n,)
    _check(x, y, valid, got, ref)


@pytest.mark.parametrize("masked", [False, True])
def test_nn_argmin_matches_jax_on_camera_frame_clouds(masked):
    """A scan-like cloud at 1-2 m with ~2 mm spacing against a copy moved
    by ~1 mm: the true d^2 (~1e-6) is the size of JAX's rounding."""
    rng = np.random.default_rng(7)
    g = np.stack(np.meshgrid(np.arange(60), np.arange(40)), -1).reshape(-1, 2)
    x = np.concatenate([(g - 30) * 0.002,
                        1.5 + 0.3 * np.sin(g[:, :1] * 0.05)], 1)
    x = x + np.array([0.4, -0.3, 0.0])
    y = x + rng.normal(0, 0.001, x.shape)
    x, y = x.astype(np.float32), y[rng.permutation(len(y))].astype(np.float32)
    valid = (rng.random(len(y)) > 0.5) if masked else None
    ref = jknn.nn_argmin_xla(jnp.asarray(x), jnp.asarray(y),
                             None if valid is None else jnp.asarray(valid))
    got = tknn.nn_argmin(torch.from_numpy(x), torch.from_numpy(y),
                         None if valid is None else torch.from_numpy(valid))
    _check(x, y, valid, got, ref)


def test_nn_argmin_exact_tie_goes_to_first_index():
    y = np.array([[1, 0, 0], [0, 1, 0], [-1, 0, 0], [0, 0, 1],
                  [0, -1, 0]], np.float32)
    x = np.zeros((3, 3), np.float32)
    x[1] = [0.25, 0.0, 0.0]
    sq, idx = tknn.nn_argmin(torch.from_numpy(x), torch.from_numpy(y))
    assert idx.tolist() == [0, 0, 0]
    valid = torch.tensor([False, True, True, True, True])
    sq, idx = tknn.nn_argmin(torch.from_numpy(x), torch.from_numpy(y), valid)
    assert idx.tolist() == [1, 1, 1]     # row 1: y1 and y3 tie at 1.0625
    _, jidx = jknn.nn_argmin_xla(jnp.asarray(x[[0, 2]]), jnp.asarray(y))
    assert np.asarray(jidx).tolist() == [0, 0]


def test_nn_argmin_no_valid_candidate_and_empty():
    x = torch.rand(5, 3)
    y = torch.rand(9, 3)
    sq, idx = tknn.nn_argmin(x, y, torch.zeros(9, dtype=torch.bool))
    assert torch.isinf(sq).all() and (idx == 0).all()
    sq, idx = tknn.nn_argmin(x, y[:0])
    assert torch.isinf(sq).all() and (idx == 0).all()
    sq, idx = tknn.nn_argmin(x[:0], y)
    assert sq.shape == idx.shape == (0,)


@pytest.mark.parametrize("masked", [False, True])
def test_chunked_plain_is_bit_equal_to_one_chunk(masked):
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(1001, 3, generator=gen) + 1.5
    y = torch.randn(777, 3, generator=gen) + 1.5
    valid = (torch.rand(777, generator=gen) > 0.4) if masked else None
    whole = tknn.nn_argmin_plain(x, y, valid, chunk=10 ** 6)
    for chunk in (1, 7, 256):
        part = tknn.nn_argmin_plain(x, y, valid, chunk=chunk)
        assert torch.equal(part[0], whole[0]) and torch.equal(part[1], whole[1])
    # the plain version's distance is the kernel's summation order
    diff = x[:, None] - y[None]
    d = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]) \
        + diff[..., 2] * diff[..., 2]
    assert torch.equal(whole[0], d.gather(1, whole[1][:, None])[:, 0])


def test_c14_argtypes_match_its_c_entry_point():
    """The wrapper's ctypes argtypes name dp_nn_argmin's parameters in
    order (the stream, appended by the binding, excluded)."""
    src = (cuda_lib.CSRC / "nn_argmin.cu").read_text()
    decl = re.search(r'extern "C" int dp_nn_argmin\(([^)]*)\)', src)
    kinds = {"void*": cuda_lib.P, "int": cuda_lib.I, "float": cuda_lib.F}
    params = [re.fullmatch(r"\s*(?:const\s+)?(void\s*\*|int|float)\s*\w+\s*",
                           p).group(1).replace(" ", "")
              for p in decl.group(1).split(",")]
    assert params[-1] == "void*"
    assert [kinds[p] for p in params[:-1]] == tknn.NN_ARGMIN.argtypes
    assert tknn.NN_ARGMIN.symbol == "dp_nn_argmin"


def test_port_calls_no_cdist():
    """``torch.cdist`` is the library yardstick that chip_smoke.py times
    beside C1, C12 and C14; the port itself never calls it."""
    hits = [p for p in PORT.rglob("*.py") if "cdist(" in p.read_text()]
    assert not hits, hits


def test_package_exports_nn_argmin():
    import deformationpyramid_tpu_torch as dp
    assert dp.nn_argmin is tknn.nn_argmin
    assert "nn_argmin" in dp.__all__
