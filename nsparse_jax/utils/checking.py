"""Oracles and tolerance checkers.

Mirrors the reference's verification layer with scipy.sparse playing both
oracle roles (the serial CPU SpMV ``csr_kernel``, ``nsparse.cu:240-259``,
and cuSPARSE for SpGEMM):

- ``ans_check`` reproduces the reference's precision-scaled relative
  tolerance (``nsparse.cu:261-298``): fail when
  ``|y - y_ref| * 100 * scale > |y_ref|`` with scale 1e3 for fp32 / 1e6 for
  fp64, i.e. rtol ~1e-5 / ~1e-8; first ``max_report`` mismatches reported.
- ``check_spgemm_answer`` reproduces the exact-structure + tolerant-value
  SpGEMM compare (``nsparse.cu:300-353``): rpt and col must match exactly
  (both sides in sorted canonical form), values with the same rtol.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from nsparse_jax.formats.csr import CSR


def _rtol_for(dtype) -> float:
    return 1e-5 if np.dtype(dtype).itemsize <= 4 else 1e-8


def spmv_oracle(a: CSR, x) -> np.ndarray:
    """scipy-backed y = A @ x (the CPU serial oracle)."""
    return a.to_scipy() @ np.asarray(x)


def spgemm_oracle(a: CSR, b: CSR) -> "np.ndarray":
    """scipy-backed C = A @ B in canonical CSR (the cuSPARSE oracle role)."""
    c = (a.to_scipy() @ b.to_scipy()).tocsr()
    c.sum_duplicates()
    c.sort_indices()
    return c


def spgemm_abs_oracle(a: CSR, b: CSR) -> "np.ndarray":
    """|A| @ |B| on C's sparsity — the backward-error scale for value checks.

    A computed entry c_ij carries roundoff up to ~eps * sum_k |a_ik||b_kj|
    regardless of summation order; comparing against rtol * |c_ij| alone
    rejects legitimate reorderings (tree reductions, atomics) whenever the
    sum cancels.  The reference sidesteps this only because its FEM test
    matrices rarely cancel; a general checker must scale by this bound.
    """
    sa, sb = a.to_scipy(), b.to_scipy()
    sa = abs(sa.astype(np.float64))
    sb = abs(sb.astype(np.float64))
    c = (sa @ sb).tocsr()
    c.sum_duplicates()
    c.sort_indices()
    return c


def spmv_abs_oracle(a: CSR, x) -> np.ndarray:
    """|A| @ |x| — the backward-error scale for SpMV value checks."""
    return abs(a.to_scipy().astype(np.float64)) @ np.abs(
        np.asarray(x, dtype=np.float64)
    )


def ans_check(y, y_ref, dtype=None, max_report: int = 10,
              verbose: bool = False, scale=None) -> Tuple[bool, int]:
    """Element-wise relative check with the reference's tolerance.

    ``scale``, when given (e.g. |A|@|x| from :func:`spmv_abs_oracle`),
    relaxes the denominator to ``max(|ref|, scale)`` — the backward-error
    bound that accepts any summation order.  Returns (ok, n_fail).
    """
    y = np.asarray(y)
    y_ref = np.asarray(y_ref)
    rtol = _rtol_for(dtype or y.dtype)
    denom = np.abs(y_ref)
    if scale is not None:
        denom = np.maximum(denom, np.asarray(scale, dtype=np.float64))
    err = np.abs(y.astype(np.float64) - y_ref.astype(np.float64))
    # reference: fail if err * 100 * scale > |ref|; for ref == 0 require
    # err == 0 at tolerance scaled to 1 (zero rows stay zero numerically)
    fail = err > rtol * np.maximum(denom, np.finfo(np.float64).tiny ** 0.5)
    n_fail = int(fail.sum())
    if verbose and n_fail:
        idx = np.nonzero(fail)[0][:max_report]
        for i in idx:
            print(f"  mismatch [{i}]: got {y[i]!r} want {y_ref[i]!r}")
    return n_fail == 0, n_fail


def check_spgemm_answer(c: CSR, c_ref, verbose: bool = False,
                        abs_ref=None) -> bool:
    """Exact structure + tolerant values vs a scipy CSR (sorted canonical).

    ``abs_ref``: optional |A|@|B| CSR (same sparsity) from
    :func:`spgemm_abs_oracle` for backward-error-aware value tolerance.
    """
    ref = c_ref.tocsr() if not isinstance(c_ref, CSR) else c_ref.to_scipy()
    ref.sum_duplicates()
    ref.sort_indices()
    got = c.to_scipy()

    if got.shape != ref.shape:
        if verbose:
            print(f"shape mismatch {got.shape} vs {ref.shape}")
        return False
    if got.nnz != ref.nnz:
        if verbose:
            print(f"nnz mismatch {got.nnz} vs {ref.nnz}")
        return False
    if not np.array_equal(got.indptr, ref.indptr):
        if verbose:
            print("rpt mismatch")
        return False
    if not np.array_equal(got.indices, ref.indices):
        if verbose:
            print("col mismatch")
        return False
    ok, n_fail = ans_check(
        got.data, ref.data, dtype=got.data.dtype, verbose=verbose,
        scale=abs_ref.data if abs_ref is not None else None,
    )
    if verbose and not ok:
        print(f"{n_fail} value mismatches")
    return ok


def ans_check_device(y, y_ref, dtype=None, scale=None) -> Tuple[bool, int]:
    """On-device tolerant compare (same semantics as :func:`ans_check`).

    Uploads the oracle to the accelerator and reduces there, pulling back a
    single scalar — for deployments where device->host bandwidth is scarce
    (host->device is typically fine).  ``y`` stays on device.
    """
    import jax
    import jax.numpy as jnp

    wide = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    y_ref = jnp.asarray(np.asarray(y_ref), dtype=wide)
    rtol = _rtol_for(dtype or y.dtype)
    floor = float(np.finfo(np.float64).tiny ** 0.5)
    denom = jnp.abs(y_ref)
    if scale is not None:
        denom = jnp.maximum(denom, jnp.asarray(np.asarray(scale), dtype=wide))
    err = jnp.abs(y.astype(wide) - y_ref)
    fail = err > rtol * jnp.maximum(denom, floor)
    n_fail = int(jnp.sum(fail))
    return n_fail == 0, n_fail


def check_spgemm_answer_device(c: CSR, c_ref, abs_ref=None) -> bool:
    """On-device exact-structure + tolerant-value SpGEMM check.

    Same semantics as :func:`check_spgemm_answer`; the scipy oracle is
    uploaded and all comparisons reduce on device (three scalar pulls).
    """
    import jax.numpy as jnp

    ref = c_ref.tocsr()
    ref.sum_duplicates()
    ref.sort_indices()
    if tuple(c.shape) != tuple(ref.shape) or c.nnz != ref.nnz:
        return False
    nnz = c.nnz
    rpt_ok = bool(
        jnp.all(c.rpt == jnp.asarray(ref.indptr.astype(np.int32)))
    )
    col_ok = bool(
        jnp.all(c.col[:nnz] == jnp.asarray(ref.indices.astype(np.int32)))
    )
    if not (rpt_ok and col_ok):
        return False
    ok, _ = ans_check_device(
        c.val[:nnz], ref.data, dtype=c.val.dtype,
        scale=abs_ref.data if abs_ref is not None else None,
    )
    return ok


def csr_allclose(a: CSR, b: CSR) -> bool:
    """Tolerant matrix equality (the ``CSR::operator==`` analog)."""
    sa, sb = a.to_scipy(), b.to_scipy()
    sa.sum_duplicates(); sa.sort_indices()
    sb.sum_duplicates(); sb.sort_indices()
    if sa.shape != sb.shape or sa.nnz != sb.nnz:
        return False
    if not np.array_equal(sa.indptr, sb.indptr):
        return False
    if not np.array_equal(sa.indices, sb.indices):
        return False
    return ans_check(sa.data, sb.data, dtype=sa.data.dtype)[0]
