"""Block-SpGEMM tests: the gather + batched product + segment-sum route
for every dtype."""

import numpy as np
import pytest

from nsparse_jax.formats.csr import CSR
from nsparse_jax.io.generate import fem_block_csr, rmat_csr, stencil_csr
from nsparse_jax.ops.spgemm_bsr import (
    block_stats,
    choose_spgemm_path,
    plan_spgemm_bsr,
    spgemm_bsr,
)
from nsparse_jax.utils.checking import (
    check_spgemm_answer,
    spgemm_abs_oracle,
    spgemm_oracle,
)


DTYPES = pytest.mark.parametrize(
    "dtype", [np.float32, np.float64], ids=["f32", "f64"])


def _positive(a: CSR, dtype=np.float64) -> CSR:
    # positive values: block densification must not create cancellation
    # zeros that eliminate_zeros would strip from the exact structure
    s = a.to_scipy()
    s.data = np.abs(s.data) + 0.1
    return CSR.from_scipy(s.astype(dtype))


@DTYPES
def test_bsr_spgemm_stencil(dtype):
    a = _positive(stencil_csr(16, 16), dtype)
    plan = plan_spgemm_bsr(a, a)
    c = spgemm_bsr(a, a, plan)
    assert check_spgemm_answer(
        c, spgemm_oracle(a, a), abs_ref=spgemm_abs_oracle(a, a), verbose=True
    )
    # useful flops match the ESC metric definition
    from nsparse_jax.ops.spgemm import spgemm_flops

    assert plan.flops == spgemm_flops(a, a)


@DTYPES
@pytest.mark.parametrize("bs", [8, 32, 128])
def test_bsr_spgemm_fem(dtype, bs):
    a = _positive(fem_block_csr(24, dof=8, neighbors=3, bandwidth=6,
                                seed=1), dtype)
    c = spgemm_bsr(a, a, plan_spgemm_bsr(a, a, bs))
    assert c.val.dtype == dtype
    assert check_spgemm_answer(
        c, spgemm_oracle(a, a), abs_ref=spgemm_abs_oracle(a, a), verbose=True
    )


@DTYPES
def test_bsr_rectangular(dtype):
    import scipy.sparse as sp

    a = CSR.from_scipy((sp.random(200, 150, 0.05, random_state=1,
                                  format="csr")
                        + sp.eye(200, 150) * 0.5).astype(dtype))
    b = CSR.from_scipy((sp.random(150, 100, 0.05, random_state=2,
                                  format="csr")
                        + sp.eye(150, 100) * 0.5).astype(dtype))
    c = spgemm_bsr(a, b)
    assert check_spgemm_answer(
        c, spgemm_oracle(a, b), abs_ref=spgemm_abs_oracle(a, b), verbose=True
    )


def test_choose_path():
    fem = fem_block_csr(64, dof=16, neighbors=4, bandwidth=8,
                        dtype=np.float32, seed=2)
    graph = rmat_csr(10, 8, dtype=np.float32, seed=3)
    assert choose_spgemm_path(fem, fem) == "bsr"
    assert choose_spgemm_path(graph, graph) == "esc"
    pairs, a_fill, b_fill = block_stats(fem, fem)
    assert pairs > 0 and a_fill < 64


@DTYPES
def test_bsr_numeric_rerun(dtype):
    """Values-only re-run on the block path (device re-blockify)."""
    import dataclasses
    import jax.numpy as jnp
    from nsparse_jax.ops.spgemm_bsr import spgemm_bsr_blocks, spgemm_bsr_numeric

    base = fem_block_csr(24, dof=8, neighbors=3, bandwidth=6, seed=2)
    a = _positive(base, dtype)
    plan = plan_spgemm_bsr(a, a)
    rng = np.random.default_rng(5)
    new_val = np.asarray(a.val).copy()
    new_val[: a.nnz] = np.abs(rng.standard_normal(a.nnz)) + 0.1
    a2 = dataclasses.replace(a, val=jnp.asarray(new_val))
    blocks = np.asarray(spgemm_bsr_numeric(plan, a2, a2))
    assert blocks.dtype == dtype
    # compare with a fresh full run on the new values
    ref_blocks = np.asarray(spgemm_bsr_blocks(plan_spgemm_bsr(a2, a2)))
    rtol = 1e-5 if dtype == np.float32 else 1e-12
    np.testing.assert_allclose(blocks, ref_blocks, rtol=rtol)
