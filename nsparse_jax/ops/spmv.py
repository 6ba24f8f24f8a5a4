"""Sparse matrix-vector product y = A @ x.

Four compute paths, all jit-safe with static shapes:

- ``spmv_csr``  — reference-semantics path: gather x[col], multiply, and
  reduce by row with a sorted ``segment_sum``.  This is the semantic
  contract (the role of the serial CPU oracle ``csr_kernel``,
  reference ``cuda-c/src/nsparse.cu:240-259``) and the fallback everywhere.
- ``spmv_ell``  — the AMB analog: per width-binned slab,
  ``y += val[w, :] * x[col[w, :]]`` is a row-contiguous gather+FMA with no
  scatter; the reference's atomic permuted scatter
  (``kernel_spmv_amb.cu:67-78``) becomes a final gather by ``pos``.
- ``spmv_dia``  — banded matrices: shifted elementwise FMAs, no gathers.
- ``spmv_bsr``  — dense tiles: one batched matrix-vector product.

Dispatch by format type via ``spmv``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from nsparse_jax.formats.bsr import BSR
from nsparse_jax.formats.csr import CSR
from nsparse_jax.formats.dia import DIA
from nsparse_jax.formats.ell import ELL


# Pluggable semirings — the role of the reference's Add/Multiply functor
# templates (cuda-cpp/inc/nsparse_asm.hpp:56-104): (reduce, combine,
# identity).  The identity fills padded slots and empty rows.
SEMIRINGS = {
    "plus_times": (jax.ops.segment_sum, jnp.multiply, 0.0),
    "min_plus": (jax.ops.segment_min, jnp.add, jnp.inf),
    "max_plus": (jax.ops.segment_max, jnp.add, -jnp.inf),
    "max_times": (jax.ops.segment_max, jnp.multiply, -jnp.inf),
}

# elementwise reduce twin of each segment reduce (hot-path variants reduce
# over dense axes, not segments)
_ELEM_REDUCE = {
    "plus_times": jnp.add,
    "min_plus": jnp.minimum,
    "max_plus": jnp.maximum,
    "max_times": jnp.maximum,
}


def spmv_csr(a: CSR, x: jax.Array, semiring: str = "plus_times") -> jax.Array:
    """y = A (.) x for CSR over a configurable semiring.

    ``plus_times`` is ordinary SpMV; ``min_plus`` is one relaxation step of
    shortest paths; ``max_times`` is Viterbi-style.  Gather + sorted
    segmented reduction; padded slots contribute the reduce identity.
    """
    reduce_fn, combine, ident = SEMIRINGS[semiring]
    m = a.shape[0]
    rows = a.row_ids()  # padded tail -> m (dropped by num_segments trick)
    prod = combine(a.val, x[a.col])
    prod = jnp.where(a.valid_mask(), prod, jnp.asarray(ident, prod.dtype))
    y = reduce_fn(
        prod, rows, num_segments=m + 1, indices_are_sorted=True
    )
    return y[:m]



def _apply_row_splits(a: ELL, y: jax.Array, y_all: jax.Array,
                      semiring: str) -> jax.Array:
    """Fold the extra chunk partials of split rows into y (row splitting
    bounds slab padding on power-law degree tails; see ELL.from_csr)."""
    if a.split_rows is None:
        return y
    _, _, ident = SEMIRINGS[semiring]
    reduce_e = _ELEM_REDUCE[semiring]
    slots = a.split_slots
    part = jnp.where(
        slots >= 0, y_all[jnp.clip(slots, 0)],
        jnp.asarray(ident, y.dtype),
    )
    if semiring == "plus_times":
        return y.at[a.split_rows].add(jnp.sum(part, axis=1))
    red = part[:, 0]
    for c in range(1, int(slots.shape[1])):
        red = reduce_e(red, part[:, c])
    return y.at[a.split_rows].set(reduce_e(y[a.split_rows], red))


def spmv_ell(
    a: ELL, x: jax.Array, semiring: str = "plus_times"
) -> jax.Array:
    """y = A (.) x for width-binned ELL slabs over a configurable semiring.

    Non-``plus_times`` semirings (reference functor-template parity,
    ``cuda-cpp/inc/nsparse_asm.hpp:56-104``) mask the zero-padded slab
    slots with the reduce identity via the stored row lengths and reduce
    over the width axis elementwise; empty rows yield the identity (the
    same contract as :func:`spmv_csr`).
    """
    if semiring != "plus_times":
        _, combine, ident = SEMIRINGS[semiring]
        reduce_e = _ELEM_REDUCE[semiring]
        outs = []
        for val, col, ln in zip(a.vals, a.cols, a.lens):
            w = val.shape[0]
            g = combine(val, x[col])
            valid = (
                jnp.arange(w, dtype=jnp.int32)[:, None] < ln[None, :]
            )
            g = jnp.where(valid, g, jnp.asarray(ident, g.dtype))
            acc = g[0]
            for wi in range(1, w):
                acc = reduce_e(acc, g[wi])
            outs.append(acc)
        y_all = jnp.concatenate(outs, axis=0)
        return _apply_row_splits(a, y_all[a.pos], y_all, semiring)

    outs = []
    for val, col in zip(a.vals, a.cols):
        # (W, R): reduce over the width axis; every step is a row-wide FMA.
        outs.append(jnp.sum(val * x[col], axis=0))
    y_all = jnp.concatenate(outs, axis=0)
    return _apply_row_splits(a, y_all[a.pos], y_all, semiring)


def spmv_coo(a, x: jax.Array) -> jax.Array:
    """y = A @ x for COO (unsorted rows: plain segment_sum)."""
    m = a.shape[0]
    prod = jnp.where(a.valid_mask(), a.val * x[a.col], 0)
    return jax.ops.segment_sum(prod, a.row, num_segments=m)


def spmm_csr(a: CSR, x: jax.Array) -> jax.Array:
    """Y = A @ X for a dense (N, K) right-hand side.

    Row gathers of X amortize the per-element cost XLA's 1-D gather pays:
    each gathered row moves K contiguous values.  The accumulation is the
    same sorted segment reduction as SpMV.
    """
    m = a.shape[0]
    rows = a.row_ids()
    prod = a.val[:, None] * x[a.col]  # (cap, K)
    y = jax.ops.segment_sum(
        prod, rows, num_segments=m + 1, indices_are_sorted=True
    )
    return y[:m]


def spmm_bsr(a: BSR, x: jax.Array) -> jax.Array:
    """Y = A @ X over dense tiles — batched (br, bc) @ (bc, K) products."""
    br, bc = a.blocksize
    n = a.shape[1]
    k = x.shape[1]
    nbc = (n + bc - 1) // bc
    xp = jnp.pad(x, ((0, nbc * bc - n), (0, 0))).reshape(nbc, bc, k)
    xg = xp[a.block_col]  # (nblocks, bc, K)
    yb = jnp.einsum(
        "krc,kcj->krj", a.data, xg.astype(a.data.dtype),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=a.data.dtype,
    )
    y = jax.ops.segment_sum(
        yb, a.block_row, num_segments=a.n_block_rows, indices_are_sorted=True
    )
    return y.reshape(-1, k)[: a.shape[0]]


def spmm(a, x: jax.Array) -> jax.Array:
    """Multi-vector product Y = A @ X (dense X of shape (N, K))."""
    if isinstance(a, BSR):
        return spmm_bsr(a, x)
    if isinstance(a, CSR):
        return spmm_csr(a, x)
    raise TypeError(f"spmm supports CSR/BSR, got {type(a)}")


def spmv_dia(
    a: DIA, x: jax.Array, semiring: str = "plus_times"
) -> jax.Array:
    """y = A (.) x for DIA — shifted elementwise FMAs, zero gathers.

    y[i] = sum_d vals[d, i] * x[i + off_d]: each term is a contiguous
    (statically shifted) slice of x, so the whole SpMV is sequential memory
    traffic that XLA fuses into one elementwise pass — the speed-of-light
    path for banded matrices (the structural class AMB's segmentation
    targets).

    Non-``plus_times`` semirings treat the full stored diagonals as the
    pattern (DIA semantics: in-band positions are entries, including
    explicit zeros); out-of-range band slots contribute the identity.
    """
    m, n = a.shape
    mp = a.vals.shape[1]
    offs = a.offsets

    if semiring != "plus_times":
        _, combine, ident = SEMIRINGS[semiring]
        reduce_e = _ELEM_REDUCE[semiring]
        lo = min(0, min(offs, default=0))
        hi = max(0, max(offs, default=0))
        xp = jnp.pad(x, (-lo, hi + max(mp - m, 0) + max(m - n, 0)))
        i = jnp.arange(mp)
        y = jnp.full(mp, ident, dtype=a.vals.dtype)
        for d, off in enumerate(offs):
            xs = jax.lax.dynamic_slice(xp, ((-lo) + off,), (mp,))
            t = combine(a.vals[d], xs)
            inb = (i + off >= 0) & (i + off < n) & (i < m)
            y = reduce_e(y, jnp.where(inb, t, jnp.asarray(ident, t.dtype)))
        return y[:m]

    lo = min(0, min(offs, default=0))
    hi = max(0, max(offs, default=0))
    # pad x so every shifted read is in range: index i + off + (-lo)
    xp = jnp.pad(x, (-lo, hi + max(mp - m, 0) + max(m - n, 0)))
    y = jnp.zeros(mp, dtype=a.vals.dtype)
    for d, off in enumerate(offs):
        xs = jax.lax.dynamic_slice(xp, ((-lo) + off,), (mp,))
        y = y + a.vals[d] * xs
    return y[:m]


def spmv_bsr(a: BSR, x: jax.Array) -> jax.Array:
    """y = A @ x for BSR: one batched tile-times-vector product at full
    float32 precision (no TF32), then a sorted segment-sum over tile rows."""
    br, bc = a.blocksize
    n = a.shape[1]
    nbc = (n + bc - 1) // bc
    xp = jnp.pad(x, (0, nbc * bc - n)).reshape(nbc, bc)
    xg = xp[a.block_col]  # (nblocks, bc)
    yb = jnp.einsum(
        "krc,kc->kr", a.data, xg.astype(a.data.dtype),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=a.data.dtype,
    )
    y = jax.ops.segment_sum(
        yb, a.block_row, num_segments=a.n_block_rows, indices_are_sorted=True
    )
    return y.reshape(-1)[: a.shape[0]]


def spmv(a, x: jax.Array, semiring: str = "plus_times") -> jax.Array:
    """Format-dispatched SpMV (the ``sf_spmv_amb`` / ``AMB::spmv`` analog).

    ``semiring`` is supported on the CSR, ELL and DIA paths (the functor
    parity of ``nsparse_asm.hpp:56-104``); BSR/COO accept plus_times only.
    """
    from nsparse_jax.formats.coo import COO

    if isinstance(a, CSR):
        return spmv_csr(a, x, semiring=semiring)
    if isinstance(a, COO):
        if semiring != "plus_times":
            raise NotImplementedError("COO SpMV supports plus_times only")
        return spmv_coo(a, x)
    if isinstance(a, DIA):
        return spmv_dia(a, x, semiring=semiring)
    if isinstance(a, ELL):
        return spmv_ell(a, x, semiring=semiring)
    if isinstance(a, BSR):
        if semiring != "plus_times":
            raise NotImplementedError("BSR SpMV supports plus_times only")
        return spmv_bsr(a, x)
    raise TypeError(f"unsupported format {type(a)}")
