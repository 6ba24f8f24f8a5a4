"""DIA format + spmv_dia tests."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from nsparse_jax.formats.dia import DIA
from nsparse_jax.io.generate import random_csr, stencil_csr
from nsparse_jax.ops.spmv import spmv, spmv_dia
from nsparse_jax.utils.checking import ans_check, spmv_oracle


def test_dia_roundtrip():
    a = stencil_csr(16, 16, dtype=np.float64)
    d = DIA.from_csr(a)
    assert d.ndiag == 5
    assert d.nnz == a.nnz
    np.testing.assert_allclose(
        np.asarray(d.to_dense()), np.asarray(a.to_dense())
    )


def test_dia_spmv_matches_oracle(rng):
    a = stencil_csr(32, 24, dtype=np.float64)
    d = DIA.from_csr(a)
    x = rng.standard_normal(a.shape[1])
    y = np.asarray(jax.jit(spmv_dia)(d, jnp.asarray(x)))
    ok, n = ans_check(y, spmv_oracle(a, x))
    assert ok, n


def test_dia_dispatch(rng):
    a = stencil_csr(8, 8, dtype=np.float64)
    d = DIA.from_csr(a)
    x = rng.standard_normal(a.shape[1])
    y = np.asarray(spmv(d, jnp.asarray(x)))
    ok, _ = ans_check(y, spmv_oracle(a, x))
    assert ok


def test_dia_rejects_random(rng):
    a = random_csr(200, 200, density=0.02, seed=7)
    with pytest.raises(ValueError):
        DIA.from_csr(a, max_diags=8)


def test_dia_partial_coverage():
    # random matrix accepted when max_diags is large enough
    a = random_csr_diagonalish()
    d = DIA.from_csr(a, max_diags=64, min_coverage=0.9)
    dense = np.asarray(d.to_dense())
    ref = np.asarray(a.to_dense())
    # kept entries agree; dropped ones are zero in DIA
    mask = dense != 0
    np.testing.assert_allclose(dense[mask], ref[mask])


def random_csr_diagonalish():
    import scipy.sparse as sp

    rng = np.random.default_rng(0)
    m = 64
    mats = []
    for off in (-3, 0, 2, 5):
        diag = rng.standard_normal(m - abs(off))
        mats.append(sp.diags([diag], [off], shape=(m, m)))
    s = sum(mats).tocsr()
    # a few stray entries (<10%)
    s = s.tolil()
    for _ in range(5):
        s[rng.integers(0, m), rng.integers(0, m)] = 1.0
    from nsparse_jax.formats.csr import CSR

    return CSR.from_scipy(s.tocsr())
