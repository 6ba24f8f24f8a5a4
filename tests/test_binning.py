"""Row binning (BIN analog) sanity."""

import numpy as np

from nsparse_jax.io.generate import random_csr, rmat_csr
from nsparse_jax.ops.binning import bin_rows, bin_histogram, flops_per_row


def test_bins_partition_rows():
    sizes = np.array([0, 1, 31, 32, 33, 64, 65, 1000, 10**7])
    bins = bin_rows(sizes, min_size=32, num_bins=7)
    all_idx = np.concatenate(bins)
    assert sorted(all_idx.tolist()) == list(range(len(sizes)))
    # geometric edges: <=32, <=64, <=128, ...
    assert set(bins[0]) == {0, 1, 2, 3}
    assert set(bins[1]) == {4, 5}
    assert 8 in bins[-1]


def test_flops_per_row_matches_scipy():
    a = random_csr(64, 64, 0.08, seed=1)
    fr = np.asarray(flops_per_row(a, a))
    sa = a.to_scipy()
    b_deg = np.diff(sa.indptr)
    expected = np.zeros(64, dtype=np.int64)
    for i in range(64):
        cols = sa.indices[sa.indptr[i]:sa.indptr[i + 1]]
        expected[i] = b_deg[cols].sum()
    np.testing.assert_array_equal(fr, expected)


def test_skewed_histogram():
    a = rmat_csr(9, edge_factor=8, seed=2)
    fr = np.asarray(flops_per_row(a, a))
    counts, maxes = bin_histogram(fr)
    assert counts.sum() == a.shape[0]
    assert (np.diff([m for m in maxes if m]) >= 0).all()
