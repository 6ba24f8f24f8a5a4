"""Matrix Market I/O semantics (reference convert_file_csr parity)."""

import os
import tempfile

import numpy as np
import pytest
import scipy.sparse as sp

from nsparse_jax.io.matrix_market import read_mtx, read_mtx_arrays, write_mtx
from nsparse_jax.formats.csr import CSR

EXPECTED_FIXTURE = np.array(
    [
        [10, 0, 1, 0, 0],
        [0, 20, 0, 0, 0],
        [1, 0, 30, 0, 2],
        [0, 0, 0, 40, 0],
        [0, 0, 2, 0, 50],
    ],
    dtype=np.float64,
)


def test_fixture_symmetrized(fixture_mtx):
    a = read_mtx(fixture_mtx)
    assert a.shape == (5, 5)
    assert a.nnz == 9  # 7 stored + 2 mirrored off-diagonals
    np.testing.assert_allclose(np.asarray(a.to_dense()), EXPECTED_FIXTURE)


def test_general_not_symmetrized(tmp_path):
    p = tmp_path / "g.mtx"
    p.write_text(
        "%%MatrixMarket matrix coordinate real general\n"
        "3 3 2\n2 1 5.0\n1 3 7.0\n"
    )
    a = read_mtx(str(p))
    d = np.asarray(a.to_dense())
    assert d[1, 0] == 5.0 and d[0, 2] == 7.0
    assert d[0, 1] == 0.0 and d[2, 0] == 0.0


def test_pattern_defaults_to_one(tmp_path):
    p = tmp_path / "p.mtx"
    p.write_text(
        "%%MatrixMarket matrix coordinate pattern general\n"
        "2 2 2\n1 1\n2 2\n"
    )
    a = read_mtx(str(p))
    np.testing.assert_allclose(np.asarray(a.to_dense()), np.eye(2))


def test_skew_symmetric(tmp_path):
    p = tmp_path / "s.mtx"
    p.write_text(
        "%%MatrixMarket matrix coordinate real skew-symmetric\n"
        "2 2 1\n2 1 3.0\n"
    )
    a = read_mtx(str(p))
    d = np.asarray(a.to_dense())
    assert d[1, 0] == 3.0 and d[0, 1] == -3.0


def test_roundtrip(tmp_path, rng):
    m = sp.random(17, 13, density=0.2, random_state=np.random.RandomState(1))
    a = CSR.from_scipy(m.tocsr())
    p = tmp_path / "rt.mtx"
    write_mtx(str(p), a)
    b = read_mtx(str(p))
    np.testing.assert_allclose(
        np.asarray(a.to_dense()), np.asarray(b.to_dense()), rtol=1e-12
    )


def test_native_parser_parity(fixture_mtx):
    """C++ parser must agree with the NumPy path exactly."""
    from nsparse_jax.native import try_native_read_mtx

    res = try_native_read_mtx(fixture_mtx)
    if res is None:
        pytest.skip("native parser unavailable")
    os.environ["NSPARSE_NO_NATIVE"] = "1"
    try:
        r2, c2, v2, shape2 = read_mtx_arrays(fixture_mtx)
    finally:
        del os.environ["NSPARSE_NO_NATIVE"]
    r1, c1, v1, shape1 = res
    assert shape1 == shape2
    key1 = np.lexsort((c1, r1))
    key2 = np.lexsort((c2, r2))
    np.testing.assert_array_equal(np.asarray(r1)[key1], np.asarray(r2)[key2])
    np.testing.assert_array_equal(np.asarray(c1)[key1], np.asarray(c2)[key2])
    np.testing.assert_allclose(np.asarray(v1)[key1], np.asarray(v2)[key2])


def test_comment_lines(tmp_path):
    p = tmp_path / "c.mtx"
    p.write_text(
        "%%MatrixMarket matrix coordinate real general\n"
        "% a comment\n% another\n"
        "2 2 1\n1 2 4.5\n"
    )
    a = read_mtx(str(p))
    assert np.asarray(a.to_dense())[0, 1] == 4.5
