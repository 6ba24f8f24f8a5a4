"""Distributed layer on the 8-device virtual CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nsparse_jax.io.generate import random_csr, stencil_csr
from nsparse_jax.parallel.mesh import make_mesh
from nsparse_jax.parallel.partition import partition_rows
from nsparse_jax.parallel.spmv import spmv_dist
from nsparse_jax.parallel.spgemm import (
    gather_partitioned,
    rap_dist,
    spgemm_dist,
    spgemm_plan_dist,
    spgemm_numeric_dist,
)
from nsparse_jax.utils.checking import check_spgemm_answer, spmv_oracle, spgemm_oracle


pytestmark = pytest.mark.usefixtures("multi_device")


def test_partition_roundtrip():
    a = random_csr(100, 80, 0.07, seed=1)
    part = partition_rows(a, 8)
    back = gather_partitioned(
        type(part)(rpt=part.rpt, col=part.col, val=part.val,
                   shape=part.shape, m_loc=part.m_loc, nnz=part.nnz)
    )
    np.testing.assert_allclose(np.asarray(back.to_dense()),
                               np.asarray(a.to_dense()), rtol=1e-12)


def test_spmv_dist():
    mesh = make_mesh(8)
    a = random_csr(200, 120, 0.05, seed=2)
    part = partition_rows(a, 8)
    x = jnp.asarray(np.random.default_rng(3).standard_normal(120))
    y = spmv_dist(part, x, mesh)
    np.testing.assert_allclose(np.asarray(y), spmv_oracle(a, x), rtol=1e-10)


def test_spmv_dist_uneven_rows():
    mesh = make_mesh(8)
    a = stencil_csr(13, 5)  # 65 rows, not divisible by 8
    part = partition_rows(a, 8)
    x = jnp.asarray(np.random.default_rng(4).standard_normal(65))
    y = spmv_dist(part, x, mesh)
    np.testing.assert_allclose(np.asarray(y), spmv_oracle(a, x), rtol=1e-10)


def test_spgemm_dist():
    mesh = make_mesh(8)
    a = random_csr(96, 96, 0.06, seed=5)
    part = partition_rows(a, 8)
    c = spgemm_dist(part, a, mesh)
    got = gather_partitioned(c)
    assert check_spgemm_answer(got, spgemm_oracle(a, a), verbose=True)


def test_spgemm_dist_plan_reuse():
    mesh = make_mesh(8)
    a = random_csr(64, 64, 0.08, seed=6)
    part = partition_rows(a, 8)
    plan = spgemm_plan_dist(part, a)

    # new values, same pattern
    rng = np.random.default_rng(7)
    new_val = np.asarray(part.val).copy()
    mask = new_val != 0
    new_val[mask] = rng.standard_normal(mask.sum())
    part2 = type(part)(rpt=part.rpt, col=part.col, val=jnp.asarray(new_val),
                       shape=part.shape, m_loc=part.m_loc, nnz=part.nnz)
    a2 = gather_partitioned(part2)

    c = spgemm_numeric_dist(plan, part2, a2, mesh)
    got = gather_partitioned(c)
    assert check_spgemm_answer(got, spgemm_oracle(a2, a2), verbose=True)


def test_spmv_halo():
    from nsparse_jax.parallel.halo import (
        partition_banded,
        shard_x,
        spmv_halo,
    )

    mesh = make_mesh(8)
    a = stencil_csr(16, 16)
    ap = partition_banded(a, 8)
    assert ap.halo == 16
    rng = np.random.default_rng(3)
    x = rng.standard_normal(a.shape[1])
    xs = shard_x(jnp.asarray(x), 8, ap.m_loc)
    y = np.asarray(spmv_halo(ap, xs, mesh)).reshape(-1)[: a.shape[0]]
    np.testing.assert_allclose(y, spmv_oracle(a, x), rtol=1e-10)


def test_spmv_halo_diagonal():
    # pure-diagonal matrix: halo == 0; x_loc[-0:] would alias the whole
    # shard and misalign the rebased columns (advisor round-1 finding)
    from nsparse_jax.formats.csr import CSR
    from nsparse_jax.parallel.halo import partition_banded, shard_x, spmv_halo
    import scipy.sparse as sp

    m = 32
    d = np.arange(1.0, m + 1.0)
    a = CSR.from_scipy(sp.diags(d).tocsr())
    ap = partition_banded(a, 4)
    assert ap.halo == 0
    mesh = make_mesh(4)
    rng = np.random.default_rng(7)
    x = rng.standard_normal(m)
    xs = shard_x(jnp.asarray(x), 4, ap.m_loc)
    y = np.asarray(spmv_halo(ap, xs, mesh)).reshape(-1)[:m]
    np.testing.assert_allclose(y, d * x, rtol=1e-10)


def test_partition_banded_rejects_wide_band():
    import pytest as _pytest
    from nsparse_jax.parallel.halo import partition_banded
    from nsparse_jax.io.generate import random_csr

    a = random_csr(64, 64, density=0.3, seed=5)
    with _pytest.raises(ValueError):
        partition_banded(a, 8)


def test_rap_dist():
    mesh = make_mesh(8)
    n, nc = 64, 24
    a = stencil_csr(8, 8)
    rng = np.random.default_rng(8)
    import scipy.sparse as sp

    p_dense = np.zeros((n, nc))
    p_dense[np.arange(n), rng.integers(0, nc, n)] = 1.0
    from nsparse_jax.formats.csr import CSR

    p = CSR.from_scipy(sp.csr_matrix(p_dense))
    r = CSR.from_scipy(sp.csr_matrix(p_dense.T))
    got = rap_dist(r, a, p, mesh)
    ref = (r.to_scipy() @ a.to_scipy() @ p.to_scipy()).tocsr()
    ref.sum_duplicates(); ref.sort_indices()
    assert check_spgemm_answer(got, ref, verbose=True)


def test_spgemm_halo():
    from nsparse_jax.parallel.spgemm import gather_partitioned
    from nsparse_jax.parallel.spgemm_halo import spgemm_halo

    mesh = make_mesh(8)
    a = stencil_csr(16, 16)
    ap = partition_rows(a, 8)
    c = spgemm_halo(ap, ap, mesh)
    got = gather_partitioned(c)
    from nsparse_jax.utils.checking import spgemm_abs_oracle

    assert check_spgemm_answer(
        got, spgemm_oracle(a, a), abs_ref=spgemm_abs_oracle(a, a),
        verbose=True,
    )


def test_spgemm_halo_rejects_wide_band():
    from nsparse_jax.parallel.spgemm_halo import spgemm_halo_plan

    mesh = make_mesh(8)
    r = random_csr(64, 64, 0.3, seed=3)
    rp = partition_rows(r, 8)
    with pytest.raises(ValueError):
        spgemm_halo_plan(rp, rp)


def test_rap_halo():
    """R @ A @ P fully sharded with halo exchange only."""
    import scipy.sparse as sp
    from nsparse_jax.formats.csr import CSR
    from nsparse_jax.parallel.spgemm import gather_partitioned
    from nsparse_jax.parallel.spgemm_halo import rap_halo
    from nsparse_jax.utils.checking import spgemm_abs_oracle

    mesh = make_mesh(8)
    n, nc = 256, 64
    a = stencil_csr(16, 16)
    # local aggregation: node i -> aggregate i // 4 (banded R and P)
    agg = np.arange(n) // (n // nc)
    p_dense = np.zeros((n, nc))
    p_dense[np.arange(n), agg] = 1.0
    p = CSR.from_scipy(sp.csr_matrix(p_dense))
    r = CSR.from_scipy(sp.csr_matrix(p_dense.T))
    rp = partition_rows(r, 8)
    app = partition_rows(a, 8)
    pp = partition_rows(p, 8)
    got = gather_partitioned(rap_halo(rp, app, pp, mesh))
    ref = (r.to_scipy() @ a.to_scipy() @ p.to_scipy()).tocsr()
    ref.sum_duplicates(); ref.sort_indices()
    sa = (abs(r.to_scipy()) @ abs(a.to_scipy()) @ abs(p.to_scipy())).tocsr()
    sa.sum_duplicates(); sa.sort_indices()
    assert check_spgemm_answer(got, ref, abs_ref=sa, verbose=True)


def test_halo_paths_non_divisible_shapes():
    """195 rows over 8 shards: padded last shard, both halo paths."""
    from nsparse_jax.parallel.halo import partition_banded, shard_x, spmv_halo
    from nsparse_jax.parallel.spgemm import gather_partitioned
    from nsparse_jax.parallel.spgemm_halo import spgemm_halo
    from nsparse_jax.utils.checking import ans_check, spgemm_abs_oracle

    a = stencil_csr(15, 13)
    mesh = make_mesh(8)
    ap = partition_rows(a, 8)
    got = gather_partitioned(spgemm_halo(ap, ap, mesh))
    assert check_spgemm_answer(
        got, spgemm_oracle(a, a), abs_ref=spgemm_abs_oracle(a, a)
    )
    hp = partition_banded(a, 8)
    x = np.random.default_rng(1).standard_normal(a.shape[1])
    xs = shard_x(jnp.asarray(x), 8, hp.m_loc)
    y = np.asarray(spmv_halo(hp, xs, mesh)).reshape(-1)[: a.shape[0]]
    assert ans_check(y, spmv_oracle(a, x))[0]
