"""SpGEMM vs scipy across matrix families, dtypes and both planners, and
plan reuse with new values per family."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from nsparse_jax.formats.csr import CSR
from nsparse_jax.io.generate import fem_block_csr, random_csr, rmat_csr, stencil_csr
from nsparse_jax.io.matrix_market import read_mtx
from nsparse_jax.ops.spgemm import (
    spgemm,
    spgemm_numeric,
    spgemm_plan,
    spgemm_plan_device,
)
from nsparse_jax.utils.checking import (
    check_spgemm_answer,
    spgemm_abs_oracle,
    spgemm_oracle,
)

DATA = os.path.join(os.path.dirname(__file__), "..", "data")


def _empty_rows_cols():
    m = sp.random(40, 40, density=0.1, random_state=3, format="lil")
    m[5:12, :] = 0
    m[:, 20:30] = 0
    return CSR.from_scipy(m.tocsr())


def _one_dense_row():
    body = sp.random(50, 50, density=0.04, random_state=4, format="lil")
    body[7, :] = np.random.default_rng(5).standard_normal(50)
    return CSR.from_scipy(body.tocsr())


# each family: () -> (A, B)
FAMILIES = {
    "stencil": lambda: (stencil_csr(12, 10),) * 2,
    "rmat": lambda: (rmat_csr(8, edge_factor=4, seed=5),) * 2,
    "fem_block": lambda: (
        fem_block_csr(16, dof=4, neighbors=3, bandwidth=5, seed=6),) * 2,
    "rect_chain": lambda: (random_csr(50, 70, 0.06, seed=7),
                           random_csr(70, 30, 0.06, seed=8)),
    "empty_rows_cols": lambda: (_empty_rows_cols(),) * 2,
    "one_dense_row": lambda: (_one_dense_row(),) * 2,
    "fem_annulus": lambda: (read_mtx(os.path.join(DATA, "fem_annulus.mtx")),) * 2,
    "lshape_laplace": lambda: (
        read_mtx(os.path.join(DATA, "lshape_laplace.mtx")),) * 2,
    "circuit_zipf": lambda: (read_mtx(os.path.join(DATA, "circuit_zipf.mtx")),) * 2,
}


def _pair(family, dtype):
    a, b = FAMILIES[family]()
    return a.astype(dtype), b.astype(dtype)


def _ok(c, a, b):
    return check_spgemm_answer(
        c, spgemm_oracle(a, b), abs_ref=spgemm_abs_oracle(a, b), verbose=True
    )


@pytest.mark.parametrize("planner", ["host", "device"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_spgemm_matches_scipy(family, dtype, planner):
    a, b = _pair(family, dtype)
    c = spgemm(a, b, planner=planner)
    assert c.val.dtype == dtype
    assert _ok(c, a, b)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_plan_reuse_new_values(family):
    """One host plan, two value sets (the SpGEMM_Hash_Numeric analog); the
    device planner's plan gives the same output structure."""
    a, b = _pair(family, np.float64)
    plan = spgemm_plan(a, b)
    rng = np.random.default_rng(11)

    def renew(m):
        val = np.zeros(m.capacity)
        val[: m.nnz] = rng.standard_normal(m.nnz)
        out = dataclasses.replace(m, val=jnp.asarray(val))
        object.__setattr__(out, "_host", (m.host_arrays()[0],
                                          m.host_arrays()[1], val))
        return out

    a2, b2 = renew(a), renew(b)
    assert _ok(spgemm_numeric(plan, a2, b2), a2, b2)
    dplan = spgemm_plan_device(a, b)
    assert dplan.c_nnz == plan.c_nnz
    np.testing.assert_array_equal(np.asarray(dplan.c_rpt),
                                  np.asarray(plan.c_rpt))
