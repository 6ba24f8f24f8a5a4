"""SpMV over every format x semiring x dtype against a dense numpy
reference."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from nsparse_jax.formats.bsr import BSR
from nsparse_jax.formats.coo import COO
from nsparse_jax.formats.csr import CSR
from nsparse_jax.formats.dia import DIA
from nsparse_jax.formats.ell import ELL
from nsparse_jax.ops.spmv import spmv

SEMIRINGS = ["plus_times", "min_plus", "max_plus", "max_times"]
DTYPES = {"f32": np.float32, "f64": np.float64}


def _banded():
    """Full diagonals (every in-band slot an entry), so DIA's band pattern
    equals the CSR pattern for every semiring."""
    rng = np.random.default_rng(1)
    n = 70
    offs = (-3, -1, 0, 1, 4)
    diags = [rng.standard_normal(n - abs(o)) + 2.0 for o in offs]
    return sp.diags(diags, offs, shape=(n, n), format="csr")


def _irregular():
    """Random pattern with empty rows and columns."""
    m = sp.random(60, 45, density=0.08, random_state=2, format="lil")
    m[10:15, :] = 0
    m[:, 30:35] = 0
    return m.tocsr()


MATRICES = {"banded": _banded, "irregular": _irregular}
FORMATS = {
    "csr": lambda a: a,
    "coo": lambda a: COO.from_arrays(*_coo(a), a.shape),
    "ell": lambda a: ELL.from_csr(a, min_width=2, max_slabs=4),
    "dia": DIA.from_csr,
    "bsr": lambda a: BSR.from_csr(a, blocksize=(8, 16)),
}
# formats whose SpMV takes only the ordinary (+, *) semiring
PLUS_TIMES_ONLY = {"coo", "bsr"}


def _coo(a: CSR):
    s = a.to_scipy().tocoo()
    return s.row, s.col, s.data


def _reference(s, x, semiring):
    dense = s.toarray()
    mask = np.zeros(s.shape, bool)
    mask[s.nonzero()] = True
    if semiring == "plus_times":
        return dense @ x
    if semiring == "min_plus":
        return np.where(mask, dense + x[None, :], np.inf).min(axis=1)
    t = dense + x[None, :] if semiring == "max_plus" else dense * x[None, :]
    return np.where(mask, t, -np.inf).max(axis=1)


CASES = [
    (m, f, s, d)
    for m in MATRICES for f in FORMATS for s in SEMIRINGS for d in DTYPES
    if not (m == "irregular" and f == "dia")  # not diagonal: DIA refuses it
]


@pytest.mark.parametrize("matrix,fmt,semiring,dtype", CASES)
def test_spmv_format_semiring_dtype(matrix, fmt, semiring, dtype):
    dt = DTYPES[dtype]
    s = MATRICES[matrix]().astype(dt)
    a = CSR.from_scipy(s)
    f = FORMATS[fmt](a)
    x = np.random.default_rng(3).standard_normal(s.shape[1]).astype(dt)
    if fmt in PLUS_TIMES_ONLY and semiring != "plus_times":
        with pytest.raises(NotImplementedError):
            spmv(f, jnp.asarray(x), semiring=semiring)
        return
    y = np.asarray(spmv(f, jnp.asarray(x), semiring=semiring))
    assert y.dtype == dt
    rtol = 1e-5 if dt == np.float32 else 1e-12
    np.testing.assert_allclose(
        y, _reference(s.astype(np.float64), x.astype(np.float64), semiring),
        rtol=rtol, atol=rtol,
    )


def test_dia_refuses_irregular():
    with pytest.raises(ValueError):
        DIA.from_csr(CSR.from_scipy(_irregular()))
