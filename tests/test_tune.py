"""Auto-tuner (sf_csr2amb analog) and Plan persistence."""

import numpy as np

from nsparse_jax.io.generate import random_csr, stencil_csr
from nsparse_jax.ops.spmv import spmv
from nsparse_jax.tune.autotune import autotune_spmv
from nsparse_jax.tune.plan import Plan, matrix_fingerprint
from nsparse_jax.utils.checking import spmv_oracle


def test_autotune_returns_correct_format():
    a = stencil_csr(16, 16)
    x = np.random.default_rng(0).standard_normal(a.shape[1])
    import jax.numpy as jnp

    fmt, plan = autotune_spmv(a, jnp.asarray(x), trials=2)
    assert plan.isPlan
    y = spmv(fmt, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(y), spmv_oracle(a, x), rtol=1e-8)


def test_footprint_mode():
    a = random_csr(100, 100, 0.05, seed=1)
    fmt, plan = autotune_spmv(a, measure=False)
    assert plan.memory_bytes > 0
    assert plan.measured_ms == float("inf")


def test_plan_roundtrip(tmp_path):
    p = Plan(format="ell", min_width=16, measured_ms=1.25,
             matrix_key="abc", chip="cpu")
    path = p.save(str(tmp_path))
    q = Plan.load(str(tmp_path), "abc", "cpu")
    assert q == p


def test_plan_cache(tmp_path):
    a = stencil_csr(8, 8)
    fmt1, p1 = autotune_spmv(a, trials=2, cache_dir=str(tmp_path))
    fmt2, p2 = autotune_spmv(a, trials=2, cache_dir=str(tmp_path))
    assert p1.format == p2.format  # second call hits the cache


def test_fingerprint_stable():
    a = stencil_csr(8, 8)
    b = stencil_csr(8, 8)
    c = random_csr(64, 64, 0.1, seed=3)
    assert matrix_fingerprint(a) == matrix_fingerprint(b)
    assert matrix_fingerprint(a) != matrix_fingerprint(c)
