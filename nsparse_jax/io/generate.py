"""Matrix generators for tests and benchmarks.

The reference is evaluated on user-supplied SuiteSparse .mtx files
(``README.md:30-37``); with zero egress we synthesize the same structural
classes named in BASELINE.json's configs: banded FEM/stencil matrices
(cant/consph/pwtk stand-ins), uniform random, and R-MAT scale-free graphs
(webbase-1M stand-in) whose skewed rows stress the binning paths.
"""

from __future__ import annotations

import numpy as np

from nsparse_jax.formats.csr import CSR


def random_csr(
    m: int,
    n: int,
    density: float = 0.01,
    dtype=np.float64,
    seed: int = 0,
    pad_to=None,
) -> CSR:
    """Uniform random sparse matrix (duplicates merged)."""
    rng = np.random.default_rng(seed)
    nnz = max(int(m * n * density), 1)
    rows = rng.integers(0, m, size=nnz)
    cols = rng.integers(0, n, size=nnz)
    vals = rng.standard_normal(nnz).astype(dtype)
    import scipy.sparse as sp

    return CSR.from_scipy(
        sp.coo_matrix((vals, (rows, cols)), shape=(m, n)), pad_to=pad_to
    )


def stencil_csr(
    nx: int, ny: int, dtype=np.float64, pad_to=None
) -> CSR:
    """2-D 5-point Laplacian on an nx x ny grid — banded FEM/stencil class."""
    import scipy.sparse as sp

    d = sp.diags(
        [4.0, -1.0, -1.0, -1.0, -1.0],
        [0, -1, 1, -nx, nx],
        shape=(nx * ny, nx * ny),
        format="csr",
    )
    return CSR.from_scipy(d.astype(dtype), pad_to=pad_to)


def fem_block_csr(
    n_nodes: int,
    dof: int = 16,
    neighbors: int = 6,
    bandwidth: int = 32,
    dtype=np.float64,
    seed: int = 0,
    pad_to=None,
) -> CSR:
    """Multi-DOF FEM-stiffness stand-in: dense (dof, dof) blocks on a
    banded node graph — the block-clustered structural class where the
    dense-tile block-SpGEMM path pays (cant/consph shape, BASELINE.json configs).
    """
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    rows, cols = [np.arange(n_nodes)], [np.arange(n_nodes)]
    for _ in range(neighbors):
        off = rng.integers(1, bandwidth, n_nodes)
        j = np.minimum(np.arange(n_nodes) + off, n_nodes - 1)
        rows.append(np.arange(n_nodes))
        cols.append(j)
        rows.append(j)
        cols.append(np.arange(n_nodes))
    r = np.concatenate(rows)
    c = np.concatenate(cols)
    graph = sp.coo_matrix(
        (np.ones(r.size), (r, c)), shape=(n_nodes, n_nodes)
    ).tocsr()
    graph.sum_duplicates()
    nnz_blocks = graph.nnz
    data = rng.standard_normal((nnz_blocks, dof, dof)).astype(dtype)
    bsr = sp.bsr_matrix(
        (data, graph.indices, graph.indptr),
        shape=(n_nodes * dof, n_nodes * dof),
    )
    return CSR.from_scipy(bsr.tocsr(), pad_to=pad_to)


def rmat_csr(
    scale: int,
    edge_factor: int = 8,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    dtype=np.float64,
    seed: int = 0,
    pad_to=None,
) -> CSR:
    """R-MAT power-law graph (Graph500-style), duplicates merged.

    Vectorized bit-recursive generation: each of ``scale`` levels picks a
    quadrant per edge.
    """
    rng = np.random.default_rng(seed)
    n = 1 << scale
    ne = n * edge_factor
    rows = np.zeros(ne, dtype=np.int64)
    cols = np.zeros(ne, dtype=np.int64)
    ab = a + b
    a_norm = a / ab
    c_norm = c / (1.0 - ab)
    for _ in range(scale):
        r1 = rng.random(ne)
        r2 = rng.random(ne)
        down = r1 > ab  # lower half of the adjacency quadrant
        right = np.where(down, r2 > c_norm, r2 > a_norm)
        rows = (rows << 1) | down
        cols = (cols << 1) | right
    vals = rng.standard_normal(ne).astype(dtype)
    import scipy.sparse as sp

    return CSR.from_scipy(
        sp.coo_matrix((vals, (rows, cols)), shape=(n, n)), pad_to=pad_to
    )
