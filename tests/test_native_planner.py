"""C++ planner vs numpy fallback equivalence (the native runtime layer)."""

import numpy as np
import pytest

from nsparse_jax import native
from nsparse_jax.io.generate import random_csr, rmat_csr, stencil_csr


def _plan_inputs(a, b):
    rpt_a, col_a, _ = a.host_arrays()
    rpt_b, col_b, _ = b.host_arrays()
    col_a64 = col_a[: a.nnz].astype(np.int64)
    return (
        rpt_a, col_a64, np.diff(rpt_a).astype(np.int64),
        rpt_b, col_b, np.diff(rpt_b).astype(np.int64),
        a.shape[0], b.shape[1], a.nnz,
    )


@pytest.mark.parametrize("maker", [
    lambda: (stencil_csr(12, 12), stencil_csr(12, 12)),
    lambda: (rmat_csr(8, 4, seed=1), rmat_csr(8, 4, seed=1)),
    lambda: (random_csr(50, 70, 0.08, seed=2), random_csr(70, 40, 0.08, seed=3)),
    lambda: (random_csr(10, 10, 0.0, seed=4), random_csr(10, 10, 0.0, seed=4)),
])
def test_native_matches_numpy(maker, monkeypatch):
    a, b = maker()
    args = _plan_inputs(a, b)
    if native.get_lib() is None:
        pytest.skip("native planner unavailable")
    res_native = native.spgemm_plan_host(*args)
    monkeypatch.setenv("NSPARSE_NO_NATIVE", "1")
    saved = native._lib
    native._lib = None
    try:
        res_numpy = native.spgemm_plan_host(*args)
    finally:
        native._lib = saved
        monkeypatch.delenv("NSPARSE_NO_NATIVE")
    names = ["apos", "bpos", "out_pos", "c_rpt", "c_col", "p_total", "c_nnz"]
    for name, x, y in zip(names, res_native, res_numpy):
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=name)
        else:
            assert x == y, name
