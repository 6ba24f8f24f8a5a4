"""Distributed SpMV over a 1-D mesh (row-block data parallel).

y = A @ x with A row-sharded and x replicated: each device computes its row
block locally; the result is row-sharded (gathered to replicated on request).
No collectives are needed in the replicated-x form; the halo-exchange
variant for banded matrices with sharded x lives in ``halo.py``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from nsparse_jax.parallel.partition import PartitionedCSR, local_spmv


def spmv_dist(a: PartitionedCSR, x: jax.Array, mesh: Mesh,
              axis: str = "x", gather: bool = True) -> jax.Array:
    """y = A @ x; returns replicated (M,) if gather else sharded (D, m_loc)."""
    m_loc = a.m_loc

    def shard_fn(rpt, col, val, x):
        y = local_spmv(rpt[0], col[0], val[0], x, m_loc)
        return y[None]

    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P()),
        out_specs=P(axis),
    )
    y = fn(a.rpt, a.col, a.val, x)  # (D, m_loc) row-sharded
    if gather:
        return y.reshape(-1)[: a.shape[0]]
    return y
