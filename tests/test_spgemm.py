"""SpGEMM vs the scipy oracle: exact structure, 1e-10 values (fp64)."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from nsparse_jax.formats.csr import CSR
from nsparse_jax.io.generate import random_csr, rmat_csr, stencil_csr
from nsparse_jax.io.matrix_market import read_mtx
from nsparse_jax.ops.spgemm import (
    spgemm,
    spgemm_flops,
    spgemm_numeric,
    spgemm_plan,
    spgemm_symbolic_nnz,
)
from nsparse_jax.utils.checking import check_spgemm_answer, spgemm_oracle


def _check(a: CSR, b: CSR):
    c = spgemm(a, b)
    ref = spgemm_oracle(a, b)
    assert check_spgemm_answer(c, ref, verbose=True)
    got = c.to_scipy()
    np.testing.assert_allclose(got.data, ref.data, rtol=1e-10, atol=1e-12)
    return c


def test_fixture_a_squared(fixture_mtx):
    a = read_mtx(fixture_mtx)
    _check(a, a)


def test_random_square():
    a = random_csr(120, 120, 0.05, seed=1)
    _check(a, a)


def test_rectangular_chain():
    a = random_csr(60, 90, 0.08, seed=2)
    b = random_csr(90, 40, 0.08, seed=3)
    _check(a, b)


def test_stencil_a_squared():
    a = stencil_csr(20, 20)
    _check(a, a)


def test_rmat_skewed():
    a = rmat_csr(8, edge_factor=4, seed=5)
    _check(a, a)


def test_empty_result():
    m1 = np.zeros((10, 10)); m1[0, 9] = 1.0
    m2 = np.zeros((10, 10)); m2[0, 5] = 2.0  # row 9 of b empty
    a = CSR.from_scipy(sp.csr_matrix(m1))
    b = CSR.from_scipy(sp.csr_matrix(m2))
    c = spgemm(a, b)
    assert c.nnz == 0
    assert spgemm_oracle(a, b).nnz == 0


def test_flop_count_matches_oracle():
    a = random_csr(80, 70, 0.1, seed=6)
    b = random_csr(70, 50, 0.1, seed=7)
    sa, sb = a.to_scipy(), b.to_scipy()
    b_deg = np.diff(sb.indptr)
    expected = 2 * int(b_deg[sa.indices].sum())
    assert spgemm_flops(a, b) == expected


def test_symbolic_nnz():
    a = random_csr(64, 64, 0.08, seed=8)
    assert spgemm_symbolic_nnz(a, a) == (a.to_scipy() @ a.to_scipy()).nnz


def test_plan_reuse_new_values():
    """The SpGEMM_Hash_Numeric analog: same pattern, new values."""
    a = random_csr(50, 50, 0.1, seed=9)
    plan = spgemm_plan(a, a)
    rng = np.random.default_rng(10)

    new_vals = np.zeros(a.capacity, dtype=np.float64)
    new_vals[: a.nnz] = rng.standard_normal(a.nnz)
    a2 = CSR(rpt=a.rpt, col=a.col, val=jnp.asarray(new_vals),
             shape=a.shape, nnz=a.nnz)

    c2 = spgemm_numeric(plan, a2, a2)
    ref = spgemm_oracle(a2, a2)
    assert check_spgemm_answer(c2, ref, verbose=True)
    np.testing.assert_allclose(c2.to_scipy().data, ref.data, rtol=1e-10)


def test_duplicate_column_accumulation():
    # products that hit the same (i, j) repeatedly must sum exactly
    m = np.ones((6, 6))
    a = CSR.from_scipy(sp.csr_matrix(m))
    c = spgemm(a, a)
    np.testing.assert_allclose(np.asarray(c.to_dense()), m @ m, rtol=1e-12)


def test_padded_inputs():
    a = random_csr(40, 40, 0.1, seed=11, pad_to=2048)
    _check(a, a)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_dtypes(dtype):
    a = random_csr(60, 60, 0.07, seed=12).astype(dtype)
    c = spgemm(a, a)
    ref = spgemm_oracle(a, a)
    assert check_spgemm_answer(c, ref, verbose=True)


def test_spgemm_method_auto():
    """Library-level method dispatch (esc vs dense-tile block path)."""
    from nsparse_jax.formats.csr import CSR
    from nsparse_jax.io.generate import fem_block_csr
    from nsparse_jax.ops.spgemm import spgemm
    from nsparse_jax.utils.checking import (check_spgemm_answer,
                                            spgemm_abs_oracle, spgemm_oracle)

    base = fem_block_csr(24, dof=8, neighbors=3, bandwidth=6, seed=9)
    s = base.to_scipy()
    s.data = np.abs(s.data) + 0.1
    a = CSR.from_scipy(s)
    c = spgemm(a, a, method="auto")
    assert check_spgemm_answer(
        c, spgemm_oracle(a, a), abs_ref=spgemm_abs_oracle(a, a)
    )


# ---------------------------------------------------------------------------
# host-planned numeric phase on long and mixed output-entry product runs
# ---------------------------------------------------------------------------


def _check_slab(a: CSR, b: CSR):
    """Host plan + numeric phase vs the oracle at the dtype's tolerance."""
    plan = spgemm_plan(a, b)
    c = spgemm_numeric(plan, a, b)
    ref = spgemm_oracle(a, b)
    assert check_spgemm_answer(c, ref, verbose=True)
    rtol = 1e-10 if a.val.dtype == jnp.float64 else 2e-5
    np.testing.assert_allclose(
        np.asarray(c.to_scipy().data), ref.data, rtol=rtol, atol=1e-12
    )
    return plan


def test_slab_path_rmat():
    a = rmat_csr(9, edge_factor=6, dtype=np.float64, seed=4)
    _check_slab(a, a)


def test_slab_path_multilevel():
    # a dense column block in A times dense rows of B makes C entries with
    # 1400 intermediate products each
    rng = np.random.default_rng(7)
    k = 1400
    a_d = rng.standard_normal((3, k))
    b_d = rng.standard_normal((k, 5))
    a = CSR.from_scipy(sp.csr_matrix(a_d))
    b = CSR.from_scipy(sp.csr_matrix(b_d))
    plan = _check_slab(a, b)
    assert plan.n_products == 3 * k * 5


def test_slab_path_mixed_lengths():
    # mix of tiny rows and one heavy row in the same product
    rng = np.random.default_rng(8)
    m = 64
    dense_row = np.zeros((1, m))
    dense_row[0, :] = rng.standard_normal(m)
    body = sp.random(m - 1, m, density=0.08, random_state=9)
    a = CSR.from_scipy(sp.csr_matrix(np.vstack([dense_row, body.toarray()])))
    b_dense = sp.csr_matrix(rng.standard_normal((m, 20)))
    b = CSR.from_scipy(b_dense)
    _check_slab(a, b)
