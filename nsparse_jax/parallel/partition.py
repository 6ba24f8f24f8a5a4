"""Row-block partitioning of CSR matrices for SPMD execution.

Each shard holds a contiguous row block with full column range; shards are
stacked on a leading device axis with one shared (padded) nnz capacity so
the whole thing is a single rectangular pytree that ``shard_map`` can
partition.  Padded slots carry ``col == 0, val == 0`` and rpt-tails repeat
the local nnz, so every local kernel treats them as additive no-ops — the
same padding contract as the single-chip formats.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from nsparse_jax.formats.csr import CSR


def _round_up(x: int, m: int) -> int:
    return (max(x, 1) + m - 1) // m * m


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PartitionedCSR:
    """D row blocks of a global (M, N) CSR, stacked on axis 0.

    Attributes:
      rpt: (D, m_loc + 1) local row pointers (0-based within shard).
      col: (D, cap) local column indices (global column space).
      val: (D, cap) values.
      shape: static global (M, N).
      m_loc: static rows per shard (last shard zero-padded).
      nnz: static global nnz.
    """

    rpt: jax.Array
    col: jax.Array
    val: jax.Array
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    m_loc: int = dataclasses.field(metadata=dict(static=True))
    nnz: int = dataclasses.field(metadata=dict(static=True))

    @property
    def n_shards(self) -> int:
        return int(self.rpt.shape[0])

    @property
    def capacity(self) -> int:
        return int(self.val.shape[1])


def partition_rows(a: CSR, n_shards: int, cap_multiple: int = 128) -> PartitionedCSR:
    """Split ``a`` into ``n_shards`` contiguous row blocks (host-side)."""
    m, n = a.shape
    m_loc = (m + n_shards - 1) // n_shards
    rpt = np.asarray(a.rpt)
    col = np.asarray(a.col)
    val = np.asarray(a.val)

    caps = []
    for d in range(n_shards):
        r0, r1 = d * m_loc, min((d + 1) * m_loc, m)
        caps.append(int(rpt[r1] - rpt[r0]) if r1 > r0 else 0)
    cap = _round_up(max(caps), cap_multiple)

    rpt_s = np.zeros((n_shards, m_loc + 1), dtype=np.int32)
    col_s = np.zeros((n_shards, cap), dtype=np.int32)
    val_s = np.zeros((n_shards, cap), dtype=val.dtype)
    for d in range(n_shards):
        r0, r1 = d * m_loc, min((d + 1) * m_loc, m)
        if r1 > r0:
            base = rpt[r0]
            loc = rpt[r0 : r1 + 1] - base
            rpt_s[d, : r1 - r0 + 1] = loc
            rpt_s[d, r1 - r0 + 1 :] = loc[-1]  # padded rows are empty
            nloc = int(loc[-1])
            col_s[d, :nloc] = col[base : base + nloc]
            val_s[d, :nloc] = val[base : base + nloc]
    return PartitionedCSR(
        rpt=jnp.asarray(rpt_s),
        col=jnp.asarray(col_s),
        val=jnp.asarray(val_s),
        shape=(m, n),
        m_loc=m_loc,
        nnz=a.nnz,
    )


def local_spmv(rpt: jax.Array, col: jax.Array, val: jax.Array,
               x: jax.Array, m_loc: int) -> jax.Array:
    """SpMV on one shard's arrays with *dynamic* local nnz (rpt[-1]).

    Static per-shard nnz can't exist inside a single SPMD program, so the
    valid range is carried by the row pointers themselves; padded slots are
    val==0 no-ops anyway.
    """
    idx = jnp.arange(col.shape[0], dtype=jnp.int32)
    rows = jnp.searchsorted(rpt, idx, side="right").astype(jnp.int32) - 1
    rows = jnp.clip(rows, 0, m_loc)  # padded tail -> sentinel row m_loc
    prod = val * x[col]
    y = jax.ops.segment_sum(prod, rows, num_segments=m_loc + 1,
                            indices_are_sorted=True)
    return y[:m_loc]
