"""Kernel C5 ldmk_iteration's host-side layout and its reduction, on the
CPU (no card here: what the kernel does is emulated in torch).

C5 runs C3's tile: ``ldmk_tile`` sizes its tiles of whole 16-row m-tiles
by C3's one-wave rule, and where the card holds fewer blocks than tiles
each block loops over tiles b, b + G, ... (csrc/ldmk_iteration.cu). Only a
tile with a valid row (a non-zero residual) runs its VJP; the Adam phase
sums the rows of those blocks alone, in block order, and the rows it
leaves out hold exact zeros, so p, m and v come out bit-equal to summing
every row. C5's plain version against the JAX package is held in
tests/test_torch_fused_iteration.py.
"""
import re

import pytest
import torch

from deformationpyramid_tpu_torch.models import pyramid as tpyr
from deformationpyramid_tpu_torch.ops import cuda_lib
from deformationpyramid_tpu_torch.ops import fused_iteration as tfi

BENCH = tpyr.NDPConfig(m=10, k0=-8, depth=3, width=128)   # config/LNDP.yaml
WIDE = tpyr.NDPConfig(m=10, k0=-8, depth=3, width=256)
H100_SMS = 132          # one C5 block an SM (512 threads, launch bounds 1)


def _grid(n: int, tile: int, resident: int) -> list[list[int]]:
    """The tiles each block takes (csrc/ldmk_iteration.cu): a grid of
    min(tiles, resident) blocks, block b the tiles b, b + G, ..."""
    tiles = -(-n // tile)
    g = min(tiles, resident)
    return [list(range(b, tiles, g)) for b in range(g)]


@pytest.mark.parametrize("n,tile", [(1, 16), (31, 16), (2048, 16),
                                    (4096, 32), (9000, 80)])
def test_c5_tile_takes_whole_m_tiles_in_one_wave(n, tile):
    """At LNDP's width 128, depth 3: whole 16-row m-tiles, as few a block
    as keep one block a tile within one wave of the card's SMs (2048 rows:
    128 tiles of 16; 4096: 128 of 32), and a block's shared memory within
    the limit."""
    got = tfi.ldmk_tile(n, BENCH)
    assert got == tile
    assert got % tfi.BWD_TILE == 0
    assert tfi.ldmk_smem(BENCH, got) <= tfi.SMEM_LIMIT
    tiles = -(-n // got)
    assert tiles <= tfi.C3_MAX_BLOCKS
    if got > tfi.BWD_TILE:          # no smaller tile keeps one wave
        assert -(-n // (got - tfi.BWD_TILE)) > tfi.C3_MAX_BLOCKS
    blocks = _grid(n, got, H100_SMS)
    assert len(blocks) == tiles and all(len(b) == 1 for b in blocks)


def test_c5_loops_over_tiles_where_one_wave_does_not_hold_them():
    """At width 256 a block holds 32 rows at most (48 would not fit), so
    9000 rows are 282 tiles: the grid is the 132 blocks the card holds and
    each takes 2 or 3 tiles, every tile exactly once, in tile order."""
    tile = tfi.ldmk_tile(9000, WIDE)
    assert tile == 32
    assert tfi.ldmk_smem(WIDE, tile) <= tfi.SMEM_LIMIT
    assert tfi.ldmk_smem(WIDE, tile + tfi.BWD_TILE) > tfi.SMEM_LIMIT
    blocks = _grid(9000, tile, H100_SMS)
    assert len(blocks) == H100_SMS
    assert sorted(t for b in blocks for t in b) == list(range(282))
    assert {len(b) for b in blocks} == {2, 3}
    assert all(b == sorted(b) for b in blocks)


def test_c5_smem_and_row_limit():
    """C5's block is C3's tile plus its static shared memory; the gate
    takes 1 to LDMK_MAX_ROWS landmark rows (csrc/ldmk_iteration.cu's
    LDMK_MAX_ROWS and LDMK_STATIC_SMEM)."""
    src = (cuda_lib.CSRC / "ldmk_iteration.cu").read_text()
    assert re.search(r"#define LDMK_MAX_ROWS \(1 << 24\)", src)
    assert tfi.LDMK_MAX_ROWS == 1 << 24
    assert re.search(rf"#define LDMK_STATIC_SMEM {tfi.LDMK_STATIC_SMEM}\b",
                     src)
    assert tfi.ldmk_smem(BENCH, 16) == tfi.c3_smem(BENCH, 16) + 128
    assert tfi.supports_fused_iteration_ldmk(BENCH, 0.0, tfi.LDMK_MAX_ROWS)
    assert not tfi.supports_fused_iteration_ldmk(BENCH, 0.0,
                                                 tfi.LDMK_MAX_ROWS + 1)
    # the grid query: six ints, no stream (cuda_lib.query)
    decl = re.search(r'extern "C" int dp_ldmk_blocks\(([^)]*)\)', src)
    assert decl
    assert [p.split()[0] for p in decl.group(1).split(",")] == ["int"] * 6


def _block_order_sum(rows: torch.Tensor) -> torch.Tensor:
    """The Adam phase's sum of each parameter over the given rows: from +0,
    one row after another, in float32."""
    g = torch.zeros(rows.shape[1], dtype=torch.float32)
    for r in rows:
        g = g + r
    return g


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


def test_summing_only_the_full_rows_gives_the_same_adam_step():
    """Rows of blocks whose tiles hold a valid row (random values, exact
    zeros of both signs, terms that cancel exactly) and rows of blocks
    that skipped their VJP (zeros of both signs): the block-order sum of
    the full rows alone is bit-equal to that of every row (a sum from +0
    never gives -0), and Adam from moments of +0 and of non-zero values
    gives bit-equal p, m and v; a gradient of -0 where the sum of every
    row in another order would give one (torch's ``sum`` of -0 rows)
    leads to the same p, m and v as +0."""
    gen = torch.Generator().manual_seed(0)
    n_rows, p_len = 12, 4096
    rows = torch.randn(n_rows, p_len, generator=gen)
    full = torch.tensor([1, 0, 0, 1, 1, 0, 1, 0, 0, 0, 1, 0], dtype=torch.bool)
    signs = torch.where(torch.rand(n_rows, p_len, generator=gen) < 0.5,
                        -1.0, 1.0)
    rows[~full] = 0.0 * signs[~full]                # +0 and -0
    cancel = torch.rand(p_len, generator=gen) < 0.1   # a + b - a - b
    rows[6, cancel] = -rows[3, cancel]
    rows[10, cancel] = -(rows[0, cancel] + rows[4, cancel])
    zero = torch.rand(p_len, generator=gen) < 0.2  # exact zeros in full rows
    for r, z in ((0, -0.0), (3, -0.0), (4, 0.0), (6, -0.0), (10, 0.0)):
        rows[r, zero] = z
    g_all = _block_order_sum(rows)
    g_full = _block_order_sum(rows[full])
    assert torch.equal(_bits(g_all), _bits(g_full))
    assert not torch.signbit(g_full[g_full == 0]).any()
    assert (g_full == 0).sum() > 0
    # torch's own sum of every row may give -0 where the rows are all -0
    g_neg = torch.where(g_full == 0, -0.0, g_full)
    assert torch.signbit(g_neg[g_full == 0]).all()

    p0 = torch.randn(p_len, generator=gen)
    m0 = torch.where(torch.rand(p_len, generator=gen) < 0.5, 0.0,
                     torch.randn(p_len, generator=gen) * 1e-3)
    v0 = torch.rand(p_len, generator=gen) * 1e-6
    applied = torch.tensor(3.0)
    hold = torch.tensor(0.0)
    outs = []
    for g in (g_all, g_full, g_neg):
        p, m, v = p0.clone(), m0.clone(), v0.clone()
        tfi.adam_step_plain(p, m, v, g[None], applied, hold, 0.01)
        outs.append((p, m, v))
    for got in outs[1:]:
        for a, b in zip(got, outs[0]):
            assert torch.equal(_bits(a), _bits(b))
