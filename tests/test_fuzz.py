"""Randomized property tests: SpMV and SpGEMM vs scipy over a spread of
shapes, densities, structures, and dtypes (the test pyramid the reference
lacks, SURVEY.md section 4)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import scipy.sparse as sp

from nsparse_jax.formats.csr import CSR
from nsparse_jax.formats.ell import ELL
from nsparse_jax.ops.spmv import spmv_csr, spmv_ell
from nsparse_jax.ops.spgemm import spgemm, spgemm_plan, spgemm_numeric
from nsparse_jax.utils.checking import (
    ans_check,
    check_spgemm_answer,
    spgemm_abs_oracle,
    spgemm_oracle,
    spmv_abs_oracle,
    spmv_oracle,
)

CASES = [
    # (m, n, density, dtype, seed)
    (1, 1, 1.0, np.float64, 0),
    (1, 300, 0.05, np.float64, 1),
    (300, 1, 0.05, np.float32, 2),
    (37, 53, 0.001, np.float64, 3),   # mostly-empty rows
    (64, 64, 0.6, np.float32, 4),     # dense-ish
    (513, 129, 0.02, np.float64, 5),  # non-multiple-of-128 shapes
    (200, 200, 0.0, np.float64, 6),   # empty matrix
]


def _make(m, n, density, dtype, seed):
    rng = np.random.default_rng(seed)
    if density == 0.0:
        return CSR.from_scipy(sp.csr_matrix((m, n), dtype=dtype))
    s = sp.random(m, n, density, random_state=seed, format="csr",
                  dtype=np.float64)
    s.data = rng.standard_normal(s.nnz)
    return CSR.from_scipy(s.astype(dtype))


@pytest.mark.parametrize("case", CASES)
def test_fuzz_spmv(case):
    m, n, density, dtype, seed = case
    a = _make(*case)
    x = np.random.default_rng(seed + 100).standard_normal(n).astype(dtype)
    y = np.asarray(spmv_csr(a, jnp.asarray(x)))
    ok, nf = ans_check(y, spmv_oracle(a, x), dtype=dtype,
                       scale=spmv_abs_oracle(a, x))
    assert ok, nf
    ell = ELL.from_csr(a)
    y2 = np.asarray(jax.jit(spmv_ell)(ell, jnp.asarray(x)))
    ok, nf = ans_check(y2, spmv_oracle(a, x), dtype=dtype,
                       scale=spmv_abs_oracle(a, x))
    assert ok, nf


@pytest.mark.parametrize("case", CASES)
def test_fuzz_spgemm(case):
    m, n, density, dtype, seed = case
    a = _make(*case)
    b = _make(n, max(m // 2, 1), min(density * 2, 1.0) or 0.0, dtype,
              seed + 7)
    c = spgemm(a, b)
    assert check_spgemm_answer(
        c, spgemm_oracle(a, b), abs_ref=spgemm_abs_oracle(a, b), verbose=True
    )


def test_spgemm_numeric_rerun_new_values():
    """The SpGEMM_Hash_Numeric contract: same pattern, new values."""
    import dataclasses

    a = _make(80, 80, 0.05, np.float64, 11)
    plan = spgemm_plan(a, a)
    rng = np.random.default_rng(12)
    new_val = np.asarray(a.val).copy()
    new_val[: a.nnz] = rng.standard_normal(a.nnz)
    a2 = dataclasses.replace(a, val=jnp.asarray(new_val))
    object.__setattr__(a2, "_host", None)
    c2 = spgemm_numeric(plan, a2, a2)
    assert check_spgemm_answer(
        c2, spgemm_oracle(a2, a2), abs_ref=spgemm_abs_oracle(a2, a2)
    )


def test_spgemm_chain_products():
    """(A @ B) @ C against scipy — plans at every stage."""
    a = _make(50, 70, 0.08, np.float64, 21)
    b = _make(70, 40, 0.08, np.float64, 22)
    c = _make(40, 60, 0.08, np.float64, 23)
    ab = spgemm(a, b)
    abc = spgemm(ab, c)
    ref = (a.to_scipy() @ b.to_scipy() @ c.to_scipy()).tocsr()
    ref.sum_duplicates()
    ref.sort_indices()
    sa = abs(a.to_scipy()) @ abs(b.to_scipy()) @ abs(c.to_scipy())
    sa = sa.tocsr()
    sa.sum_duplicates()
    sa.sort_indices()
    assert check_spgemm_answer(abc, ref, abs_ref=sa, verbose=True)