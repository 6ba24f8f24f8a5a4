"""SpMV vs the scipy oracle (the reference's ans_check harness role)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from nsparse_jax.formats.csr import CSR
from nsparse_jax.formats.ell import ELL
from nsparse_jax.formats.bsr import BSR
from nsparse_jax.io.generate import random_csr, rmat_csr, stencil_csr
from nsparse_jax.io.matrix_market import read_mtx
from nsparse_jax.ops.spmv import spmv, spmv_csr, spmv_ell, spmv_bsr
from nsparse_jax.utils.checking import ans_check, spmv_oracle


def _x(n, dtype, seed=1):
    return jnp.asarray(
        np.random.default_rng(seed).standard_normal(n).astype(dtype)
    )


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_spmv_csr_fixture(fixture_mtx, dtype):
    a = read_mtx(fixture_mtx, dtype=dtype)
    x = _x(5, dtype)
    y = spmv_csr(a, x)
    ok, nf = ans_check(y, spmv_oracle(a, x), dtype=dtype)
    assert ok, f"{nf} mismatches"


@pytest.mark.parametrize("maker", [
    lambda: random_csr(200, 150, 0.05, seed=2),
    lambda: stencil_csr(16, 16),
    lambda: rmat_csr(8, edge_factor=4, seed=3),
])
def test_spmv_all_formats(maker):
    a = maker()
    x = _x(a.shape[1], np.float64)
    y_ref = spmv_oracle(a, x)

    np.testing.assert_allclose(np.asarray(spmv_csr(a, x)), y_ref, rtol=1e-10)
    e = ELL.from_csr(a)
    np.testing.assert_allclose(np.asarray(spmv_ell(e, x)), y_ref, rtol=1e-10)
    b = BSR.from_csr(a, blocksize=(8, 128))
    np.testing.assert_allclose(np.asarray(spmv_bsr(b, x)), y_ref, rtol=1e-10)


def test_spmv_csr_padded_capacity():
    a = random_csr(50, 50, 0.1, seed=4, pad_to=1000)
    x = _x(50, np.float64)
    np.testing.assert_allclose(
        np.asarray(spmv_csr(a, x)), spmv_oracle(a, x), rtol=1e-10
    )


def test_spmv_empty_rows_and_cols():
    m = np.zeros((30, 30))
    m[4, 7] = 3.0
    a = CSR.from_scipy(sp.csr_matrix(m))
    x = _x(30, np.float64)
    y = np.asarray(spmv_csr(a, x))
    np.testing.assert_allclose(y, m @ np.asarray(x), rtol=1e-12)
    e = ELL.from_csr(a)
    np.testing.assert_allclose(np.asarray(spmv_ell(e, x)), y, rtol=1e-12)


def test_spmv_jit_under_vmap_composes():
    a = random_csr(64, 64, 0.1, seed=6)
    xs = jnp.asarray(np.random.default_rng(7).standard_normal((4, 64)))
    ys = jax.vmap(lambda x: spmv_csr(a, x))(xs)
    for i in range(4):
        np.testing.assert_allclose(
            np.asarray(ys[i]), spmv_oracle(a, xs[i]), rtol=1e-10
        )


def test_spmv_dispatch():
    a = random_csr(32, 32, 0.2, seed=8)
    x = _x(32, np.float64)
    for fmt in (a, ELL.from_csr(a), BSR.from_csr(a, blocksize=(8, 128))):
        y = spmv(fmt, x)
        np.testing.assert_allclose(np.asarray(y), spmv_oracle(a, x),
                                   rtol=1e-10)


def test_spmv_semirings(rng):
    """Pluggable semirings (the reference's Add/Multiply functor parity)."""
    from nsparse_jax.io.generate import random_csr
    from nsparse_jax.ops.spmv import spmv_csr

    a = random_csr(60, 50, density=0.1, seed=11)
    x = rng.standard_normal(50)
    s = a.to_scipy()
    dense = s.toarray()
    mask = dense != 0

    y = np.asarray(spmv_csr(a, jnp.asarray(x), "min_plus"))
    ref = np.where(mask, dense + x[None, :], np.inf).min(axis=1)
    np.testing.assert_allclose(y, ref, rtol=1e-12)

    y = np.asarray(spmv_csr(a, jnp.asarray(x), "max_times"))
    ref = np.where(mask, dense * x[None, :], -np.inf).max(axis=1)
    np.testing.assert_allclose(y, ref, rtol=1e-12)

    y = np.asarray(spmv_csr(a, jnp.asarray(x), "plus_times"))
    np.testing.assert_allclose(y, s @ x, rtol=1e-12)


def test_spmm_multi_rhs(rng):
    """Y = A @ X for dense multi-vector right-hand sides."""
    from nsparse_jax.ops.spmv import spmm

    a = random_csr(60, 45, density=0.1, seed=13)
    x = rng.standard_normal((45, 7))
    y = np.asarray(spmm(a, jnp.asarray(x)))
    np.testing.assert_allclose(y, a.to_scipy() @ x, rtol=1e-10)

    b = BSR.from_csr(a, blocksize=(8, 128))
    y2 = np.asarray(spmm(b, jnp.asarray(x)))
    np.testing.assert_allclose(y2, a.to_scipy() @ x, rtol=1e-10)


def test_spmv_coo(rng):
    from nsparse_jax.formats.coo import COO
    from nsparse_jax.ops.spmv import spmv

    a = random_csr(40, 30, density=0.15, seed=17)
    s = a.to_scipy().tocoo()
    coo = COO.from_arrays(s.row, s.col, s.data, s.shape)
    x = rng.standard_normal(30)
    y = np.asarray(spmv(coo, jnp.asarray(x)))
    np.testing.assert_allclose(y, a.to_scipy() @ x, rtol=1e-10)


# ---------------------------------------------------------------------------
# semirings on the hot-path formats (nsparse_asm.hpp:56-104 functor parity)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("semiring", ["min_plus", "max_times", "max_plus"])
def test_ell_semiring_matches_csr(rng, semiring):
    a = random_csr(300, 300, density=0.03, seed=11)
    x = jnp.asarray(rng.standard_normal(300))
    ell = ELL.from_csr(a)
    got = np.asarray(spmv(ell, x, semiring=semiring))
    want = np.asarray(spmv(a, x, semiring=semiring))
    np.testing.assert_allclose(got, want, rtol=1e-12)


@pytest.mark.parametrize("semiring", ["min_plus", "max_times"])
def test_dia_semiring_band_pattern(rng, semiring):
    # DIA semantics: the full stored diagonals are the pattern
    from nsparse_jax.formats.dia import DIA
    from nsparse_jax.ops.spmv import SEMIRINGS, _ELEM_REDUCE

    a = stencil_csr(16, 16, dtype=np.float64)
    dia = DIA.from_csr(a)
    x = jnp.asarray(rng.standard_normal(a.shape[1]))
    got = np.asarray(spmv(dia, x, semiring=semiring))
    _, combine, ident = SEMIRINGS[semiring]
    m, n = a.shape
    vals = np.asarray(dia.vals)
    want = np.full(m, float(ident))
    red = {"min_plus": np.minimum, "max_times": np.maximum}[semiring]
    for d, off in enumerate(dia.offsets):
        for i in range(m):
            j = i + off
            if 0 <= j < n:
                want[i] = red(want[i], float(combine(vals[d, i], x[j])))
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_ell_row_splitting_heavy_tail():
    """Power-law degree tails: hub rows split into <= split_width chunks
    (bounding slab padding); chunk partials recombine exactly."""
    import numpy as np
    import scipy.sparse as sp

    import jax.numpy as jnp

    from nsparse_jax.formats.csr import CSR
    from nsparse_jax.formats.ell import ELL
    from nsparse_jax.ops.spmv import spmv_ell

    rng = np.random.default_rng(9)
    m = 512
    rows, cols = [], []
    for r in range(m):
        d = 4 if r % 7 else 300  # every 7th row is a hub
        cc = rng.choice(m, size=d, replace=False)
        rows += [r] * d
        cols += list(cc)
    v = rng.standard_normal(len(rows))
    s = sp.csr_matrix((v, (rows, cols)), shape=(m, m))
    a = CSR.from_scipy(s.astype(np.float64))
    e = ELL.from_csr(a, min_width=4, max_slabs=8, split_width=64)
    assert e.split_rows is not None  # hubs actually split
    assert max(e.widths) <= 64
    x = jnp.asarray(rng.standard_normal(m))
    y = spmv_ell(e, x)
    np.testing.assert_allclose(
        np.asarray(y), s @ np.asarray(x), rtol=1e-10, atol=1e-12
    )
    # padding bounded: chunks keep slabs dense
    assert e.padded_nnz <= 3 * a.nnz

    # min_plus semiring across split rows
    y2 = spmv_ell(e, x, semiring="min_plus")
    dense = np.where(s.toarray() != 0, s.toarray(), np.inf)
    ref = np.min(dense + np.asarray(x)[None, :], axis=1)
    np.testing.assert_allclose(np.asarray(y2), ref, rtol=1e-10)
