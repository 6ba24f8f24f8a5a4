"""Checks that only a GPU can answer: float32 dense-tile products must not
run as TF32, and the block paths must launch.  Skipped elsewhere; run on
the card with ``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu``."""

import numpy as np
import pytest

import jax.numpy as jnp

from nsparse_jax.formats.bsr import BSR
from nsparse_jax.io.generate import fem_block_csr
from nsparse_jax.ops.spgemm_bsr import spgemm_bsr
from nsparse_jax.ops.spmv import spmm, spmv
from nsparse_jax.utils.checking import (
    ans_check,
    check_spgemm_answer,
    spgemm_abs_oracle,
    spgemm_oracle,
    spmv_abs_oracle,
    spmv_oracle,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def fem():
    return fem_block_csr(64, dof=16, neighbors=4, bandwidth=8,
                         dtype=np.float32, seed=4)


@pytest.mark.parametrize("block", [(16, 16), (128, 128)])
def test_bsr_spmv_f32_is_not_tf32(gpu, fem, block):
    x = np.random.default_rng(0).standard_normal(fem.shape[1]).astype(
        np.float32)
    y = spmv(BSR.from_csr(fem, blocksize=block), jnp.asarray(x))
    assert y.devices() == {gpu}
    ok, n_fail = ans_check(np.asarray(y), spmv_oracle(fem, x),
                           dtype=np.float32, scale=spmv_abs_oracle(fem, x))
    assert ok, n_fail


def test_bsr_spmm_f32_is_not_tf32(gpu, fem):
    x = np.random.default_rng(1).standard_normal((fem.shape[1], 64)).astype(
        np.float32)
    y = np.asarray(spmm(BSR.from_csr(fem, blocksize=(128, 128)),
                        jnp.asarray(x)))
    ref = fem.to_scipy().astype(np.float64) @ x.astype(np.float64)
    scale = abs(fem.to_scipy().astype(np.float64)) @ np.abs(x)
    assert np.all(np.abs(y - ref) <= 1e-5 * np.maximum(np.abs(ref), scale))


def test_bsr_spgemm_f32_is_not_tf32(gpu, fem):
    c = spgemm_bsr(fem, fem)
    assert check_spgemm_answer(
        c, spgemm_oracle(fem, fem), abs_ref=spgemm_abs_oracle(fem, fem))
