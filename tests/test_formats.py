"""Format containers: CSR/COO/ELL/BSR round-trips and padding contracts."""

import numpy as np
import pytest
import scipy.sparse as sp

from nsparse_jax.formats.coo import COO
from nsparse_jax.formats.csr import CSR
from nsparse_jax.formats.ell import ELL
from nsparse_jax.formats.bsr import BSR


def _rand(m, n, density, seed=0):
    return sp.random(m, n, density=density,
                     random_state=np.random.RandomState(seed)).tocsr()


def test_csr_scipy_roundtrip():
    s = _rand(40, 30, 0.1)
    a = CSR.from_scipy(s)
    back = a.to_scipy()
    assert (abs(back - s)).max() < 1e-14
    np.testing.assert_allclose(np.asarray(a.to_dense()), s.toarray())


def test_csr_padding_is_noop():
    s = _rand(20, 20, 0.1, seed=3)
    a = CSR.from_scipy(s)
    b = a.with_capacity(a.capacity + 100)
    assert b.capacity == a.capacity + 100
    np.testing.assert_allclose(np.asarray(b.to_dense()), s.toarray())


def test_csr_row_ids():
    s = sp.csr_matrix(np.array([[1.0, 0], [0, 0], [2.0, 3.0]]))
    a = CSR.from_scipy(s, pad_to=8)
    rows = np.asarray(a.row_ids())
    np.testing.assert_array_equal(rows[:3], [0, 2, 2])
    assert (rows[3:] == 3).all()  # padded tail -> M sentinel


def test_coo_roundtrip():
    c = COO.from_arrays([0, 2, 1], [1, 0, 1], [5.0, 6.0, 7.0], (3, 2),
                        pad_to=10)
    d = np.asarray(c.to_dense())
    assert d[0, 1] == 5.0 and d[2, 0] == 6.0 and d[1, 1] == 7.0
    a = CSR.from_coo(c)
    np.testing.assert_allclose(np.asarray(a.to_dense()), d)


@pytest.mark.parametrize("density", [0.02, 0.2])
@pytest.mark.parametrize("shape", [(64, 64), (100, 37), (257, 130)])
def test_ell_matches_csr(shape, density):
    s = _rand(*shape, density, seed=7)
    a = CSR.from_scipy(s)
    e = ELL.from_csr(a)
    np.testing.assert_allclose(np.asarray(e.to_dense()), s.toarray(),
                               rtol=1e-12)


def test_ell_skewed_rows():
    # one dense row among sparse ones exercises multi-slab binning
    m = np.zeros((50, 300))
    m[7, :] = 1.5
    m[3, 5] = 2.0
    m[20, ::30] = -1.0
    s = sp.csr_matrix(m)
    e = ELL.from_csr(CSR.from_scipy(s))
    assert len(e.widths) >= 2
    np.testing.assert_allclose(np.asarray(e.to_dense()), m)


def test_ell_sigma_window():
    s = _rand(200, 100, 0.05, seed=11)
    e = ELL.from_csr(CSR.from_scipy(s), sigma=32)
    np.testing.assert_allclose(np.asarray(e.to_dense()), s.toarray(),
                               rtol=1e-12)


@pytest.mark.parametrize("blocksize", [(8, 128), (4, 64), (8, 256)])
def test_bsr_matches_csr(blocksize):
    s = _rand(100, 300, 0.05, seed=5)
    a = CSR.from_scipy(s)
    b = BSR.from_csr(a, blocksize=blocksize)
    np.testing.assert_allclose(np.asarray(b.to_dense()), s.toarray(),
                               rtol=1e-12)
    # every block row must own at least one tile
    counts = np.diff(np.asarray(b.block_rpt))
    assert (counts >= 1).all()


def test_bsr_empty_rows():
    m = np.zeros((40, 200))
    m[0, 0] = 1.0
    m[39, 199] = 2.0
    b = BSR.from_csr(CSR.from_scipy(sp.csr_matrix(m)))
    np.testing.assert_allclose(np.asarray(b.to_dense()), m)
