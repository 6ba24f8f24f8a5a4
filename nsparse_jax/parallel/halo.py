"""Halo-exchange SpMV: banded matrices with x sharded over the mesh.

The replicated-x SpMV (``parallel/spmv.py``) needs no communication but
holds all of x on every chip.  For banded matrices (the FEM/stencil class
AMB targets) each row block only reads x inside its own column range plus a
halo of the matrix bandwidth, so x can be row-sharded like A and only the
halos move — one ``ppermute`` per neighbor (an NCCL send/receive over
NVLink), the textbook stencil exchange (BASELINE.md config 5).

Host-side ``partition_banded`` validates the bandwidth, rebases column
indices into the extended local window ``[start - halo, end + halo)``, and
records the halo width; ``spmv_halo`` then runs one SPMD program:
neighbor halos via ``ppermute``, local SpMV on the extended x window.
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
from nsparse_jax.parallel.partition import PartitionedCSR, _round_up


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BandedPartitionedCSR:
    """Row-sharded CSR with columns rebased to the haloed local window.

    ``col`` holds indices into ``concat(left_halo, x_local, right_halo)``,
    i.e. ``global_col - shard_start + halo``.
    """

    rpt: jax.Array
    col: jax.Array
    val: jax.Array
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    m_loc: int = dataclasses.field(metadata=dict(static=True))
    halo: int = dataclasses.field(metadata=dict(static=True))
    nnz: int = dataclasses.field(metadata=dict(static=True))

    @property
    def n_shards(self) -> int:
        return int(self.rpt.shape[0])


def partition_banded(
    a: CSR, n_shards: int, cap_multiple: int = 128
) -> BandedPartitionedCSR:
    """Split square banded ``a`` into row blocks with rebased columns.

    Raises ValueError when the bandwidth exceeds one block (the halo would
    span more than the nearest neighbors — use the replicated-x path then).
    """
    m, n = a.shape
    if m != n:
        raise ValueError("halo partitioning expects a square matrix")
    m_loc = (m + n_shards - 1) // n_shards
    rpt, col, val = a.host_arrays()
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(rpt))
    dist = col[: a.nnz].astype(np.int64) - rows
    halo = int(max(-dist.min(initial=0), dist.max(initial=0)))
    if halo > m_loc:
        raise ValueError(
            f"bandwidth {halo} exceeds block size {m_loc}; halo exchange "
            "would need non-neighbor communication"
        )

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
        if r1 <= r0:
            continue
        base = rpt[r0]
        loc = rpt[r0 : r1 + 1] - base
        rpt_s[d, : r1 - r0 + 1] = loc
        rpt_s[d, r1 - r0 + 1 :] = loc[-1]
        nloc = int(loc[-1])
        col_s[d, :nloc] = col[base : base + nloc] - (d * m_loc) + halo
        val_s[d, :nloc] = val[base : base + nloc]
    return BandedPartitionedCSR(
        rpt=jnp.asarray(rpt_s),
        col=jnp.asarray(col_s),
        val=jnp.asarray(val_s),
        shape=(m, n),
        m_loc=m_loc,
        halo=halo,
        nnz=a.nnz,
    )


def shard_x(x, n_shards: int, m_loc: int):
    """Host-side: pad and reshape x to (D, m_loc) for P('x') placement."""
    x = jnp.asarray(x)
    pad = n_shards * m_loc - int(x.shape[0])
    return jnp.pad(x, (0, pad)).reshape(n_shards, m_loc)


def spmv_halo(
    a: BandedPartitionedCSR, xs: jax.Array, mesh: Mesh, axis: str = "x"
) -> jax.Array:
    """y = A @ x with x row-sharded; halos move by ``ppermute``.

    ``xs``: (D, m_loc) sharded x (see :func:`shard_x`).  Returns (D, m_loc)
    row-sharded y.
    """
    m_loc, halo = a.m_loc, a.halo
    nd = int(np.prod(mesh.devices.shape))

    def shard_fn(rpt, col, val, xs):
        x_loc = xs[0]
        if halo == 0:
            # pure-diagonal matrix: nothing to exchange (x_loc[-0:] would
            # alias the WHOLE shard and misalign the rebased columns)
            x_ext = x_loc
        else:
            # left neighbor's tail -> my left halo; right neighbor's head ->
            # my right halo
            src_dst_up = [(i, (i + 1) % nd) for i in range(nd)]
            src_dst_dn = [(i, (i - 1) % nd) for i in range(nd)]
            left = jax.lax.ppermute(x_loc[-halo:], axis, src_dst_up)
            right = jax.lax.ppermute(x_loc[:halo], axis, src_dst_dn)
            # edge shards read zeros beyond the global range
            d = jax.lax.axis_index(axis)
            left = jnp.where(d == 0, jnp.zeros_like(left), left)
            right = jnp.where(d == nd - 1, jnp.zeros_like(right), right)
            x_ext = jnp.concatenate([left, x_loc, right])

        idx = jnp.arange(col.shape[1], dtype=jnp.int32)
        rows = (
            jnp.searchsorted(rpt[0], idx, side="right").astype(jnp.int32) - 1
        )
        rows = jnp.clip(rows, 0, m_loc)
        prod = val[0] * x_ext[jnp.clip(col[0], 0, x_ext.shape[0] - 1)]
        y = jax.ops.segment_sum(
            prod, rows, num_segments=m_loc + 1, indices_are_sorted=True
        )
        return y[:m_loc][None]

    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis)),
        out_specs=P(axis),
    )
    return fn(a.rpt, a.col, a.val, xs)
