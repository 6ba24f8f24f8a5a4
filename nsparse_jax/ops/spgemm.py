"""SpGEMM C = A @ B via expand / sort / compress (ESC) with a reusable plan.

JAX redesign of the reference's two-phase hash SpGEMM
(``cuda-c/src/kernel/kernel_spgemm_hash_template.cu``).  The same two
phases, recast on sort and sorted-reduction primitives so that the result
is deterministic and the plan can be reused:

- **symbolic** (analog of ``set_row_nnz``): expand every intermediate
  product (a_ik, b_kj), sort by (i, j), count segment boundaries — on the
  host (C++/numpy planner, :func:`spgemm_plan`) or fully on device
  (:func:`spgemm_plan_device`, one ``jax.lax.sort``).
- **numeric** (analog of ``calculate_value_col_bin``), one jitted
  program: two gathers form the products in plan order, and one sorted
  ``segment_sum`` accumulates them into C's slots.

The captured :class:`SpgemmPlan` is the analog of both the reference's
symbolic output *and* its ``SpGEMM_Hash_Numeric`` re-run API
(``cuda-cpp/inc/HashSpGEMM.hpp:1014-1027``): for a fixed sparsity pattern,
new values of A/B re-run the numeric phase only.

Static-shape policy: the total intermediate-product count P must be known
to size the expansion, and the output nnz must be known to size C.  Both
require one device->host sync each — mirroring the reference's single
unavoidable sync after the symbolic phase
(``kernel_spgemm_hash_d.cu:1183-1184``).  Output columns are sorted
ascending within each row, matching the reference's sorted output used for
exact-structure comparison (``template.cu:805-815``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from nsparse_jax.formats.csr import CSR

# Plan arrays are padded to a multiple of this, so that nearby sizes share
# one compiled numeric program.
PAD = 128


def _round_up(x: int, m: int) -> int:
    return ((max(x, 1)) + m - 1) // m * m


# ---------------------------------------------------------------------------
# FLOP counting (analog of get_spgemm_flop, kernel_spgemm_cu_csr.cu:35-57)
# ---------------------------------------------------------------------------


@jax.jit
def _intprod_per_row(a: CSR, b: CSR) -> jax.Array:
    """Per-row intermediate product counts: sum_k in row(i) nnz(B[k, :])."""
    b_deg = b.rpt[1:] - b.rpt[:-1]
    cnt = jnp.where(a.valid_mask(), b_deg[a.col], 0)
    per_row = jax.ops.segment_sum(
        cnt, a.row_ids(), num_segments=a.shape[0] + 1, indices_are_sorted=True
    )
    return per_row[: a.shape[0]]


def spgemm_flops(a: CSR, b: CSR) -> int:
    """Total FLOPs = 2 * total intermediate products (host int)."""
    return 2 * int(jnp.sum(_intprod_per_row(a, b)))


# ---------------------------------------------------------------------------
# Plan
# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SpgemmPlan:
    """Captured sparsity computation of C = A @ B.

    Attributes:
      apos: (P_pad,) gather index into A's padded nnz arrays, sorted order.
      bpos: (P_pad,) gather index into B's padded nnz arrays, sorted order.
      out_pos: (P_pad,) output slot per product, non-decreasing; pad slots
        carry the sentinel c_cap, which the segment sum drops.
      c_rpt: (M+1,) output row pointers.
      c_col: (c_cap,) output column indices (sorted within rows).
      shape: static (M, N) of C.
      c_nnz: static output nnz.
      n_products: static total intermediate products P (flop = 2 * P).
    """

    apos: jax.Array
    bpos: jax.Array
    out_pos: jax.Array
    c_rpt: jax.Array
    c_col: jax.Array
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    c_nnz: int = dataclasses.field(metadata=dict(static=True))
    n_products: int = dataclasses.field(metadata=dict(static=True))

    @property
    def c_capacity(self) -> int:
        return int(self.c_col.shape[0])

    @property
    def flops(self) -> int:
        return 2 * self.n_products


def _expand_sort(a: CSR, b: CSR, p_pad: int):
    """Expand all intermediate products and sort by (row, col).

    Returns sorted (row, col, apos, bpos) plus boundary flags. Shapes are
    (p_pad,); slots beyond the true product count carry row == M.
    """
    m = a.shape[0]
    cap_a = a.capacity

    n = b.shape[1]
    b_deg = b.rpt[1:] - b.rpt[:-1]
    cnt = jnp.where(a.valid_mask(), b_deg[a.col], 0)
    off = jnp.cumsum(cnt)  # inclusive prefix; off[-1] == P
    total = off[cap_a - 1] if cap_a > 0 else jnp.int32(0)

    t = jnp.arange(p_pad, dtype=jnp.int32)
    # Which A-entry does product t come from: a scatter of ones at the A
    # entries' segment starts plus one cumsum, a single pass over P.
    starts_k = off - cnt  # exclusive prefix per A entry
    seg_marks = jnp.zeros(p_pad + 1, jnp.int32).at[
        jnp.minimum(starts_k, p_pad)
    ].add(jnp.where(jnp.arange(cap_a) > 0, 1, 0))
    k = jnp.cumsum(seg_marks[:p_pad]).astype(jnp.int32)
    k = jnp.minimum(k, cap_a - 1)
    start = (off - cnt)[k]
    valid = t < total

    acol = a.col[k]
    bpos = b.rpt[acol] + (t - start)
    bpos = jnp.where(valid, bpos, 0)
    a_rows = a.row_ids()
    row = jnp.where(valid, a_rows[k], m)
    ccol = jnp.where(valid, b.col[bpos], 0)

    # one packed (row, col) key halves the sort's operand traffic;
    # row * n + col < 2^31 is enforced by the caller
    key = row * jnp.int32(n) + ccol
    key = jnp.where(valid, key, jnp.int32(2**31 - 1))
    key_s, apos_s, bpos_s = jax.lax.sort((key, k, bpos), num_keys=1)
    row_s = jnp.where(
        key_s == 2**31 - 1, m, key_s // jnp.int32(n)
    )
    col_s = jnp.where(key_s == 2**31 - 1, 0, key_s % jnp.int32(n))

    prev_row = jnp.concatenate([jnp.full((1,), -1, row_s.dtype), row_s[:-1]])
    prev_col = jnp.concatenate([jnp.full((1,), -1, col_s.dtype), col_s[:-1]])
    is_new = (row_s != prev_row) | (col_s != prev_col)
    flags = is_new & (row_s < m)
    return row_s, col_s, apos_s, bpos_s, flags


_expand_sort_jit = jax.jit(_expand_sort, static_argnums=2)


def _pad(x: np.ndarray, length: int, fill: int) -> np.ndarray:
    out = np.full(length, fill, dtype=np.int32)
    out[: x.size] = x
    return out


def spgemm_plan(a: CSR, b: CSR) -> SpgemmPlan:
    """Symbolic phase: build the reusable plan on the host.

    Host-side C++ planner (numpy fallback, see ``nsparse_jax.native``):
    planning is one-time precompute per sparsity pattern, exactly like the
    reference's symbolic phase whose result must reach the host anyway to
    size C (``kernel_spgemm_hash_d.cu:1183-1184``).  The expansion is
    segmented-sort-by-column *within* rows only — expansion order is already
    row-major, so the key is the product column alone, sorted stably.
    """
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"shape mismatch {a.shape} @ {b.shape}")
    m, n = a.shape[0], b.shape[1]

    rpt_a, col_a, _ = a.host_arrays()
    rpt_b, col_b, _ = b.host_arrays()
    nnz_a = a.nnz
    col_a = col_a[:nnz_a].astype(np.int64)
    deg_a = np.diff(rpt_a).astype(np.int64)
    deg_b = np.diff(rpt_b).astype(np.int64)

    from nsparse_jax.native import spgemm_plan_host

    (apos, bpos, out_pos, c_rpt, c_col, p_total, c_nnz) = spgemm_plan_host(
        rpt_a, col_a, deg_a, rpt_b, col_b, deg_b, m, n, nnz_a
    )
    p_pad = _round_up(p_total, PAD)
    c_cap = _round_up(c_nnz, PAD)
    return SpgemmPlan(
        apos=jnp.asarray(_pad(apos, p_pad, int(apos[-1]) if apos.size else 0)),
        bpos=jnp.asarray(_pad(bpos, p_pad, 0)),
        out_pos=jnp.asarray(_pad(out_pos, p_pad, c_cap)),
        c_rpt=jnp.asarray(c_rpt),
        c_col=jnp.asarray(_pad(c_col, c_cap, 0)),
        shape=(m, n),
        c_nnz=c_nnz,
        n_products=p_total,
    )


def spgemm_plan_device(a: CSR, b: CSR) -> SpgemmPlan:
    """Symbolic phase fully on device (``jax.lax.sort`` ESC) — same result
    as :func:`spgemm_plan`; two device->host size syncs, everything else
    stays on the accelerator.  Used when the matrix already lives on device
    (e.g. produced by a previous device-side SpGEMM)."""
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"shape mismatch {a.shape} @ {b.shape}")
    m, n = a.shape[0], b.shape[1]

    if a.shape[0] * b.shape[1] >= 2**31:
        raise ValueError(
            "device planner requires M * N < 2^31 (packed sort key); "
            "use spgemm_plan for larger shapes"
        )
    per_row = _intprod_per_row(a, b)
    p_total = int(jnp.sum(per_row))  # sync 1 (sizes the expansion)
    p_pad = _round_up(p_total, PAD)

    row_s, col_s, apos_s, bpos_s, flags = _expand_sort_jit(a, b, p_pad)

    flags_i = flags.astype(jnp.int32)
    out_pos_valid = jnp.cumsum(flags_i) - 1
    valid = row_s < m
    c_nnz = int(jnp.sum(flags_i))  # sync 2 (sizes C)
    c_cap = _round_up(c_nnz, PAD)

    out_pos = jnp.where(valid, jnp.minimum(out_pos_valid, c_cap - 1), c_cap)

    # Output structure: scatter boundary (row, col) to their output slot.
    tgt = jnp.where(flags, out_pos_valid, c_cap)
    c_col = jnp.zeros(c_cap + 1, dtype=jnp.int32).at[tgt].set(col_s)[:c_cap]
    row_counts = jax.ops.segment_sum(
        flags_i, row_s, num_segments=m + 1, indices_are_sorted=True
    )[:m]
    c_rpt = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(row_counts).astype(jnp.int32)]
    )
    return SpgemmPlan(
        apos=apos_s,
        bpos=bpos_s,
        out_pos=out_pos,
        c_rpt=c_rpt,
        c_col=c_col,
        shape=(m, n),
        c_nnz=c_nnz,
        n_products=p_total,
    )


def spgemm_numeric(plan: SpgemmPlan, a: CSR, b: CSR) -> CSR:
    """Numeric phase (the ``SpGEMM_Hash_Numeric`` analog: same pattern, new
    values): gather both operands into plan order, multiply, and sum each
    output entry's run of products with one sorted ``segment_sum``."""
    prod = a.val[plan.apos] * b.val[plan.bpos]
    c_val = jax.ops.segment_sum(
        prod,
        plan.out_pos,
        num_segments=plan.c_capacity + 1,
        indices_are_sorted=True,
    )[: plan.c_capacity]
    return CSR(
        rpt=plan.c_rpt,
        col=plan.c_col,
        val=c_val.astype(a.val.dtype),
        shape=plan.shape,
        nnz=plan.c_nnz,
    )


def spgemm(a: CSR, b: CSR, plan: SpgemmPlan | None = None,
           method: str = "esc", planner: str = "auto") -> CSR:
    """C = A @ B (the ``spgemm_kernel_hash`` / ``SpGEMM_Hash`` analog).

    ``method``: "esc" (general sort/segment-sum path), "bsr" (dense-tile
    path for block-clustered matrices), or "auto" (cost-model dispatch).

    ``planner`` (plan-less calls only): "device" runs the symbolic phase
    on the accelerator (``spgemm_plan_device``: two size syncs, one
    ``lax.sort``) — the reference's model, where binning + symbolic +
    numeric run per call (``kernel_spgemm_hash_template.cu:1024-1064``);
    "host" builds the plan with the native host planner; "auto" picks
    "device".  Callers who re-multiply the same structure should build
    ``spgemm_plan`` once and pass it.
    """
    if method == "auto":
        from nsparse_jax.ops.spgemm_bsr import choose_spgemm_path

        method = choose_spgemm_path(a, b) if plan is None else "esc"
    if method == "bsr":
        if plan is not None:
            raise ValueError(
                "a precomputed ESC plan was supplied with method='bsr'; "
                "use method='esc' (or 'auto') to reuse it"
            )
        from nsparse_jax.ops.spgemm_bsr import spgemm_bsr

        return spgemm_bsr(a, b)
    if plan is None:
        if planner not in ("auto", "device", "host"):
            raise ValueError(f"unknown planner {planner!r}")
        if planner in ("auto", "device"):
            plan = spgemm_plan_device(a, b)
        else:
            plan = spgemm_plan(a, b)
    return jax.jit(spgemm_numeric)(plan, a, b)


def spgemm_symbolic_nnz(a: CSR, b: CSR) -> int:
    """Output nnz only (the ``set_row_nnz`` + scan readback analog)."""
    return spgemm_plan(a, b).c_nnz
