"""Halo-exchange distributed SpGEMM: C = A @ B with BOTH operands sharded.

``parallel/spgemm.py`` keeps B replicated (no communication, full B per
card).  For banded A — the AMG/FEM case of BASELINE.md config 5 — shard d's
rows only reference B rows within one block of their own range, so B can be
row-sharded like A and each card only needs its two neighbor B blocks: two
``ppermute``s (NCCL send/receive over NVLink) per multiply, exactly the
halo pattern of the distributed stencil SpMV.

The host planner builds, per shard, an ESC plan against a *local* B made of
the three neighbor blocks in their padded on-device layout (phantom rows
absorb the per-block padding so row pointers stay monotone); the device
program is then one shard_map: ppermute up, ppermute down, concatenate,
numeric phase.
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
from nsparse_jax.parallel.partition import PartitionedCSR, _round_up


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class HaloSpgemmPlan:
    """Stacked per-shard plans for the halo SpGEMM numeric phase."""

    apos: jax.Array      # (D, p_pad)
    bpos: jax.Array      # (D, p_pad) -> indices into concat(prev,own,next) vals
    out_pos: jax.Array   # (D, p_pad)
    c_rpt: jax.Array     # (D, m_loc + 1)
    c_col: jax.Array     # (D, c_cap)
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    m_loc: int = dataclasses.field(metadata=dict(static=True))
    c_nnz: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    n_products: int = dataclasses.field(metadata=dict(static=True))

    @property
    def c_capacity(self) -> int:
        return int(self.c_col.shape[1])


def _local_b_csr(b: PartitionedCSR, d: int, n_shards: int) -> CSR:
    """Blocks d-1, d, d+1 of B as one host CSR whose nnz layout matches the
    on-device ``concatenate([prev, own, next])`` of PADDED value arrays.

    A phantom row per block absorbs the padding slots, keeping row pointers
    monotone; callers never reference phantom rows.
    """
    cap = b.capacity
    m_loc = b.m_loc
    n = b.shape[1]
    cols = []
    rpt_local = [0]
    for j, src in enumerate((d - 1, d, d + 1)):
        if 0 <= src < n_shards:
            rpt = np.asarray(b.rpt[src])
            col = np.asarray(b.col[src])
        else:  # edge: neighbor block is all-empty (zeros arrive via ppermute mask)
            rpt = np.zeros(m_loc + 1, np.int32)
            col = np.zeros(cap, np.int32)
        base = j * cap
        rpt_local.extend((base + rpt[1 : m_loc + 1]).tolist())
        rpt_local.append((j + 1) * cap)  # phantom row spans the pad slots
        cols.append(col)
    rpt_local = np.asarray(rpt_local, dtype=np.int64)
    col_all = np.concatenate(cols)
    # the symbolic planner only reads structure; values stay on device
    val_all = np.zeros(col_all.shape[0], np.float32)
    # build the CSR container directly (bypasses canonicalization: layout
    # must stay exactly the padded concat)
    out = CSR(
        rpt=jnp.asarray(rpt_local.astype(np.int32)),
        col=jnp.asarray(col_all.astype(np.int32)),
        val=jnp.asarray(val_all),
        shape=(3 * (m_loc + 1), n),
        nnz=int(rpt_local[-1]),
    )
    object.__setattr__(out, "_host", (
        rpt_local.astype(np.int32), col_all.astype(np.int32), val_all
    ))
    return out


def spgemm_halo_plan(
    a: PartitionedCSR, b: PartitionedCSR
) -> HaloSpgemmPlan:
    """Host symbolic phase.  Requires every A column of shard d to fall in
    B row blocks {d-1, d, d+1} (banded A); raises ValueError otherwise."""
    n_shards = a.n_shards
    m_loc = a.m_loc
    bm = b.m_loc  # B's row-block size == A's column-block size
    if b.n_shards != n_shards:
        raise ValueError("A and B must use the same shard count")
    plans = []
    for d in range(n_shards):
        rpt = np.asarray(a.rpt[d])
        col = np.asarray(a.col[d])
        nloc = int(rpt[-1])
        lo, hi = (d - 1) * bm, (d + 2) * bm
        cols_d = col[:nloc]
        if nloc and (cols_d.min() < lo or cols_d.max() >= hi):
            raise ValueError(
                f"shard {d}: A columns escape the halo "
                f"[{lo}, {hi}) — use the replicated-B path"
            )
        # remap A cols to local B row space (bm + 1 rows per block, the
        # last one phantom)
        rel = cols_d - lo
        local = (rel // bm) * (bm + 1) + rel % bm
        a_loc = CSR.from_arrays(
            rpt, local.astype(np.int32), np.zeros(nloc, np.float32),
            (m_loc, 3 * (bm + 1)),
        )
        b_loc = _local_b_csr(b, d, n_shards)
        plans.append(spgemm_plan(a_loc, b_loc))

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
    return HaloSpgemmPlan(
        apos=jnp.asarray(np.stack([q[0] for q in padded])),
        bpos=jnp.asarray(np.stack([q[1] for q in padded])),
        out_pos=jnp.asarray(np.stack([q[2] for q in padded])),
        c_rpt=jnp.stack([p.c_rpt for p in plans]),
        c_col=jnp.asarray(np.stack([q[3] for q in padded])),
        shape=(a.shape[0], b.shape[1]),
        m_loc=m_loc,
        c_nnz=tuple(p.c_nnz for p in plans),
        n_products=sum(p.n_products for p in plans),
    )


def spgemm_halo_numeric(
    plan: HaloSpgemmPlan,
    a: PartitionedCSR,
    b: PartitionedCSR,
    mesh: Mesh,
    axis: str = "x",
) -> PartitionedCSR:
    """SPMD numeric phase: two neighbor ppermutes + local gather/segsum."""
    c_cap = plan.c_capacity
    nd = int(np.prod(mesh.devices.shape))

    def shard_fn(apos, bpos, out_pos, a_val, b_val):
        own = b_val[0]
        up = [(i, (i + 1) % nd) for i in range(nd)]
        dn = [(i, (i - 1) % nd) for i in range(nd)]
        prev = jax.lax.ppermute(own, axis, up)      # from d-1
        nxt = jax.lax.ppermute(own, axis, dn)       # from d+1
        d = jax.lax.axis_index(axis)
        prev = jnp.where(d == 0, jnp.zeros_like(prev), prev)
        nxt = jnp.where(d == nd - 1, jnp.zeros_like(nxt), nxt)
        bloc = jnp.concatenate([prev, own, nxt])
        prod = a_val[0][apos[0]] * bloc[bpos[0]]
        c_val = jax.ops.segment_sum(
            prod, out_pos[0], num_segments=c_cap + 1, indices_are_sorted=True
        )[:c_cap]
        return c_val[None]

    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P(axis)),
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


def spgemm_halo(
    a: PartitionedCSR, b: PartitionedCSR, mesh: Mesh, axis: str = "x",
    plan: HaloSpgemmPlan | None = None,
) -> PartitionedCSR:
    if plan is None:
        plan = spgemm_halo_plan(a, b)
    return spgemm_halo_numeric(plan, a, b, mesh, axis)


def rap_halo(
    r: PartitionedCSR,
    a: PartitionedCSR,
    p: PartitionedCSR,
    mesh: Mesh,
    axis: str = "x",
) -> PartitionedCSR:
    """Galerkin triple product R @ A @ P with every operand AND the
    intermediate A@P row-sharded; all communication is neighbor halo
    ppermutes (BASELINE.md config 5).  Requires banded locality
    (raises ValueError otherwise — ``rap_dist`` is the general path).
    """
    ap = spgemm_halo(a, p, mesh, axis)
    return spgemm_halo(r, ap, mesh, axis)
