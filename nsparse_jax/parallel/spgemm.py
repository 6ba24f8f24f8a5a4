"""Distributed SpGEMM over a 1-D mesh (the BASELINE.json config-5 axis).

C = A @ B with A row-sharded and B replicated: SpGEMM is row-wise
independent, so each device runs the ESC pipeline on its row block and C
comes out row-sharded.  Planning happens per shard on the host (the
symbolic phase needs its two size syncs anyway); plans are padded to common
static shapes and stacked so the numeric phase is one SPMD program with no
collectives — value-only reruns on new A/B values stay pure device code.

``rap_dist`` chains the AMG Galerkin triple product R @ A @ P: the
intermediate A @ P is gathered (all-gather over rows) and re-used as the
replicated right operand of the second product — on GPUs XLA hands that
collective to NCCL over NVLink.  ``parallel/spgemm_halo.py`` holds the
halo-exchange variant for banded operands.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from nsparse_jax.formats.csr import CSR
from nsparse_jax.ops.spgemm import spgemm_plan
from nsparse_jax.parallel.partition import PartitionedCSR, partition_rows


def _round_up(x: int, m: int) -> int:
    return (max(x, 1) + m - 1) // m * m


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PartitionedSpgemmPlan:
    """Per-shard ESC plans, padded to common shapes and stacked on axis 0."""

    apos: jax.Array      # (D, p_pad)
    bpos: jax.Array      # (D, p_pad)
    out_pos: jax.Array   # (D, p_pad), sentinel == c_cap
    c_rpt: jax.Array     # (D, m_loc + 1)
    c_col: jax.Array     # (D, c_cap)
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    m_loc: int = dataclasses.field(metadata=dict(static=True))
    c_nnz: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    n_products: int = dataclasses.field(metadata=dict(static=True))

    @property
    def c_capacity(self) -> int:
        return int(self.c_col.shape[1])

    @property
    def flops(self) -> int:
        return 2 * self.n_products


def _shard_csr(a: PartitionedCSR, d: int) -> CSR:
    """Materialize shard d as a host-side CSR over (m_loc, N)."""
    return CSR(
        rpt=a.rpt[d],
        col=a.col[d],
        val=a.val[d],
        shape=(a.m_loc, a.shape[1]),
        nnz=int(a.rpt[d][-1]),
    )


def spgemm_plan_dist(a: PartitionedCSR, b: CSR) -> PartitionedSpgemmPlan:
    """Build and stack per-shard plans (host-side symbolic phase)."""
    plans = [spgemm_plan(_shard_csr(a, d), b) for d in range(a.n_shards)]
    p_pad = max(p.apos.shape[0] for p in plans)
    c_cap = max(p.c_capacity for p in plans)

    def pad_plan(p):
        pp = p.apos.shape[0]
        apos = np.zeros(p_pad, np.int32)
        bpos = np.zeros(p_pad, np.int32)
        out = np.full(p_pad, c_cap, np.int32)
        apos[:pp] = np.asarray(p.apos)
        bpos[:pp] = np.asarray(p.bpos)
        op = np.asarray(p.out_pos)
        out[:pp] = np.where(op == p.c_capacity, c_cap, op)
        ccol = np.zeros(c_cap, np.int32)
        ccol[: p.c_capacity] = np.asarray(p.c_col)
        return apos, bpos, out, ccol

    padded = [pad_plan(p) for p in plans]
    return PartitionedSpgemmPlan(
        apos=jnp.asarray(np.stack([q[0] for q in padded])),
        bpos=jnp.asarray(np.stack([q[1] for q in padded])),
        out_pos=jnp.asarray(np.stack([q[2] for q in padded])),
        c_rpt=jnp.stack([p.c_rpt for p in plans]),
        c_col=jnp.asarray(np.stack([q[3] for q in padded])),
        shape=(a.shape[0], b.shape[1]),
        m_loc=a.m_loc,
        c_nnz=tuple(p.c_nnz for p in plans),
        n_products=sum(p.n_products for p in plans),
    )


def spgemm_numeric_dist(
    plan: PartitionedSpgemmPlan,
    a: PartitionedCSR,
    b: CSR,
    mesh: Mesh,
    axis: str = "x",
) -> PartitionedCSR:
    """SPMD numeric phase: per-shard gather + multiply + segment-sum."""
    c_cap = plan.c_capacity

    def shard_fn(apos, bpos, out_pos, a_val, b_val):
        prod = a_val[0][apos[0]] * b_val[bpos[0]]
        c_val = jax.ops.segment_sum(
            prod, out_pos[0], num_segments=c_cap + 1, indices_are_sorted=True
        )[:c_cap]
        return c_val[None]

    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P()),
        out_specs=P(axis),
    )
    c_val = fn(plan.apos, plan.bpos, plan.out_pos, a.val, b.val)
    return PartitionedCSR(
        rpt=plan.c_rpt,
        col=plan.c_col,
        val=c_val,
        shape=plan.shape,
        m_loc=plan.m_loc,
        nnz=sum(plan.c_nnz),
    )


def spgemm_dist(
    a: PartitionedCSR,
    b: CSR,
    mesh: Mesh,
    axis: str = "x",
    plan: PartitionedSpgemmPlan | None = None,
) -> PartitionedCSR:
    if plan is None:
        plan = spgemm_plan_dist(a, b)
    return spgemm_numeric_dist(plan, a, b, mesh, axis)


def gather_partitioned(c: PartitionedCSR) -> CSR:
    """Host-side gather of a row-sharded CSR back to one canonical CSR."""
    import scipy.sparse as sp

    m, n = c.shape
    rows_all, cols_all, vals_all = [], [], []
    rpt = np.asarray(c.rpt)
    col = np.asarray(c.col)
    val = np.asarray(c.val)
    for d in range(c.n_shards):
        nloc = int(rpt[d, -1])
        loc_rows = (
            np.searchsorted(rpt[d], np.arange(nloc), side="right") - 1
        )
        rows_all.append(loc_rows + d * c.m_loc)
        cols_all.append(col[d, :nloc])
        vals_all.append(val[d, :nloc])
    coo = sp.coo_matrix(
        (
            np.concatenate(vals_all) if vals_all else np.zeros(0),
            (
                np.concatenate(rows_all) if rows_all else np.zeros(0, int),
                np.concatenate(cols_all) if cols_all else np.zeros(0, int),
            ),
        ),
        shape=(m, n),
    )
    return CSR.from_scipy(coo)


def _sharded_structure(rpt_d: np.ndarray, col_d: np.ndarray, c_nnz,
                       m: int, n: int, m_loc: int):
    """Global CSR STRUCTURE (host numpy) of a row-sharded product, from
    its symbolic plan's per-shard rpt/col.  Structure is host-known at
    plan time by design (the symbolic phase sizes C on the host, like the
    reference's two size syncs); the VALUES never ride along."""
    d_n = rpt_d.shape[0]
    offs = np.zeros(d_n + 1, np.int64)
    np.cumsum([int(c_nnz[d]) for d in range(d_n)], out=offs[1:])
    rpt = np.zeros(d_n * m_loc + 1, np.int64)
    cols = []
    for d in range(d_n):
        rpt[d * m_loc : (d + 1) * m_loc + 1] = (
            np.asarray(rpt_d[d], np.int64) + offs[d]
        )
        cols.append(np.asarray(col_d[d, : int(c_nnz[d])]))
    rpt = rpt[: m + 1]
    col = (
        np.concatenate(cols) if cols else np.zeros(0, np.int64)
    )
    return rpt, col, int(offs[-1])


def rap_dist_parts(
    r: CSR,
    a: CSR,
    p: CSR,
    mesh: Mesh,
    axis: str = "x",
) -> PartitionedCSR:
    """R @ A @ P with the intermediate A·P VALUES kept on device.

    Planning (host, once per sparsity): plan A·P per shard, derive the
    global A·P structure from the plan's rpt/col (no value pull), plan
    R·(A·P) against that structure.  Numeric (device, reusable): the
    A·P shard values are sliced/concatenated into the replicated right
    operand on device — under a real mesh that concatenation is an
    all-gather.  The final PartitionedCSR stays row-sharded."""
    import dataclasses as dc

    n_shards = int(np.prod(mesh.devices.shape))

    # --- symbolic (host, structure only) -------------------------------
    a_part = partition_rows(a, n_shards)
    plan1 = spgemm_plan_dist(a_part, p)
    rpt_ap, col_ap, nnz_ap = _sharded_structure(
        np.asarray(plan1.c_rpt), np.asarray(plan1.c_col), plan1.c_nnz,
        a.shape[0], p.shape[1], plan1.m_loc,
    )
    ap_struct = CSR(
        rpt=jnp.asarray(rpt_ap, jnp.int32),
        col=jnp.asarray(col_ap, jnp.int32),
        val=jnp.zeros(nnz_ap, a.val.dtype),
        shape=(a.shape[0], p.shape[1]),
        nnz=nnz_ap,
    )
    r_part = partition_rows(r, n_shards)
    plan2 = spgemm_plan_dist(r_part, ap_struct)

    # --- numeric (device values end to end) ----------------------------
    ap_part = spgemm_numeric_dist(plan1, a_part, p, mesh, axis)
    ap_val = jnp.concatenate([
        ap_part.val[d, : int(plan1.c_nnz[d])] for d in range(n_shards)
    ]) if n_shards else jnp.zeros(0, a.val.dtype)
    ap_dev = dc.replace(ap_struct, val=ap_val.astype(a.val.dtype))
    return spgemm_numeric_dist(plan2, r_part, ap_dev, mesh, axis)


def rap_dist(
    r: CSR,
    a: CSR,
    p: CSR,
    mesh: Mesh,
    axis: str = "x",
) -> CSR:
    """Galerkin triple product R @ A @ P over the mesh (BASELINE config 5).
    The intermediate A·P stays on device (``rap_dist_parts``); only the
    final result is gathered."""
    return gather_partitioned(rap_dist_parts(r, a, p, mesh, axis))
