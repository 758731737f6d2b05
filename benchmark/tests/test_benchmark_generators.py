"""The frozen generators: the same seed gives the same pairs, the copies
equal the port's generators, and the 4DMatch-F pool is stratified."""
import collections

import numpy as np

from benchmark.traffic import synthetic


def test_make_pair_frozen_copy():
    from deformationpyramid_tpu_torch.data import synthetic as port
    for args in ((500, 3, 0.12), (64, 0, 0.15)):
        for a, b in zip(synthetic.make_pair(*args), port.make_pair(*args)):
            assert np.array_equal(a, b)
    for a, b in zip(synthetic.make_batch(3, 100, 5, 0.12),
                    port.make_batch(3, 100, 5, 0.12)):
        assert np.array_equal(a, b)


def test_pairs_deterministic_by_seed():
    a = synthetic.fourdmatch_pair(1500, 2**31 + 5)
    b = synthetic.fourdmatch_pair(1500, 2**31 + 5)
    c = synthetic.fourdmatch_pair(1500, 2**31 + 6)
    assert np.array_equal(a.src, b.src) and np.array_equal(a.tgt, b.tgt)
    assert not np.array_equal(a.src[:10], c.src[:10])
    # R (src + flow) + t on the kept target rows, 85% of them
    assert len(a.tgt) == int(len(a.src) * 0.85)
    assert 1500 * 0.92 <= len(a.src) <= 1500 * 1.08


def test_pool_stratified_same_mix_every_seed():
    clusters = (100, 200, 300)
    mixes = []
    for seed in (1, 2, 2**33):
        pool = synthetic.stratified_pool(clusters, 2, seed)
        mixes.append(collections.Counter(p.cluster for p in pool))
        again = synthetic.stratified_pool(clusters, 2, seed)
        assert [len(p.src) for p in pool] == [len(p.src) for p in again]
    assert all(m == {100: 2, 200: 2, 300: 2} for m in mixes)
    orders = [[p.cluster for p in synthetic.stratified_pool(clusters, 2, s)]
              for s in (1, 2, 3, 4)]
    assert len({tuple(o) for o in orders}) > 1
