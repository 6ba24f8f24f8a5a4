"""SpGEMM plan serialization round-trip (the cross-process amortization
of the symbolic phase; reference analog: SpGEMM_Hash_Numeric re-runs +
committed tuning artifacts)."""

import numpy as np
import pytest

from nsparse_jax.io.generate import rmat_csr, stencil_csr
from nsparse_jax.ops.spgemm import spgemm_numeric, spgemm_plan
from nsparse_jax.tune.spgemm_cache import (
    load_spgemm_plan,
    save_spgemm_plan,
    spgemm_plan_cached,
)
from nsparse_jax.utils.checking import check_spgemm_answer, spgemm_oracle


@pytest.mark.parametrize("maker", [
    lambda: rmat_csr(9, edge_factor=8, dtype=np.float64, seed=3),
    lambda: stencil_csr(24, 24, dtype=np.float64),
], ids=["rmat", "stencil"])
def test_roundtrip_plan(tmp_path, maker):
    a = maker()
    plan = spgemm_plan(a, a)
    path = str(tmp_path / "plan.npz")
    save_spgemm_plan(plan, path)
    loaded = load_spgemm_plan(path)
    assert loaded is not None
    assert loaded.c_nnz == plan.c_nnz
    assert loaded.n_products == plan.n_products
    np.testing.assert_array_equal(
        np.asarray(loaded.out_pos), np.asarray(plan.out_pos)
    )
    c = spgemm_numeric(loaded, a, a)
    assert check_spgemm_answer(c, spgemm_oracle(a, a))


def test_cached_helper_hits(tmp_path):
    a = stencil_csr(16, 16, dtype=np.float64)
    p1, hit1 = spgemm_plan_cached(a, a, str(tmp_path))
    p2, hit2 = spgemm_plan_cached(a, a, str(tmp_path))
    assert (hit1, hit2) == (False, True)
    c1 = spgemm_numeric(p1, a, a)
    c2 = spgemm_numeric(p2, a, a)
    np.testing.assert_array_equal(np.asarray(c1.col), np.asarray(c2.col))
    np.testing.assert_allclose(
        np.asarray(c1.val), np.asarray(c2.val), rtol=1e-12
    )


def test_version_mismatch_returns_none(tmp_path, monkeypatch):
    a = stencil_csr(8, 8, dtype=np.float64)
    plan = spgemm_plan(a, a)
    path = str(tmp_path / "plan.npz")
    save_spgemm_plan(plan, path)
    import nsparse_jax.tune.spgemm_cache as sc

    monkeypatch.setattr(sc, "PLAN_VERSION", 999)
    assert load_spgemm_plan(path) is None
