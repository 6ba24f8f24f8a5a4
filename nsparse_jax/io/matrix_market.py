"""Matrix Market I/O with the reference's exact semantics.

Reimplements ``convert_file_csr`` (reference ``cuda-c/src/nsparse.cu:14-136``)
behavior:

- symmetrize unless the header's first line contains ``general``: every
  off-diagonal entry (r, c) is mirrored to (c, r) with the same value
  (``nsparse.cu:88-92, 119-133``);
- entries with no value field (pattern matrices) default to 1.0
  (``nsparse.cu:70-77``);
- 1-based indices converted to 0-based.

Deltas from the reference (deliberate): ``skew-symmetric`` mirrors with
negated value and ``hermitian`` is treated as symmetric-real (the reference
would silently mis-handle both); duplicates are summed and columns sorted to
canonical CSR form (the reference keeps file order).

A native C fast path (``nsparse_jax/native/mmio.cpp``, loaded via ctypes)
parses large files; the NumPy path is the always-available fallback and the
behavioral spec.
"""

from __future__ import annotations

import io
import os

import numpy as np

from nsparse_jax.formats.coo import COO
from nsparse_jax.formats.csr import CSR


def _parse_header(line: str):
    toks = line.strip().lower().split()
    if len(toks) < 3 or not toks[0].startswith("%%matrixmarket"):
        raise ValueError(f"not a MatrixMarket file: {line!r}")
    fmt = toks[2] if len(toks) > 2 else "coordinate"
    field = toks[3] if len(toks) > 3 else "real"
    symmetry = toks[4] if len(toks) > 4 else "general"
    return fmt, field, symmetry


def read_mtx_arrays(path: str):
    """Parse a .mtx file to (rows, cols, vals, (M, N)) with symmetrization
    already applied. NumPy only, no device involvement."""
    from nsparse_jax.native import try_native_read_mtx

    native = try_native_read_mtx(path)
    if native is not None:
        return native

    with open(path, "rb") as f:
        head = f.readline().decode("ascii", errors="replace")
        fmt, field, symmetry = _parse_header(head)
        if fmt != "coordinate":
            raise NotImplementedError("array (dense) .mtx not supported")
        line = f.readline().decode("ascii", errors="replace")
        while line.startswith("%"):
            line = f.readline().decode("ascii", errors="replace")
        m, n, nz = (int(t) for t in line.split()[:3])
        body = np.loadtxt(
            io.BytesIO(f.read()), dtype=np.float64, ndmin=2
        ) if nz else np.zeros((0, 3))

    if body.size and body.shape[0] != nz:
        raise ValueError(f"expected {nz} entries, got {body.shape[0]}")
    rows = body[:, 0].astype(np.int64) - 1 if nz else np.zeros(0, np.int64)
    cols = body[:, 1].astype(np.int64) - 1 if nz else np.zeros(0, np.int64)
    if field == "pattern" or body.shape[1] < 3:
        vals = np.ones(rows.shape[0], dtype=np.float64)
    elif field == "complex":
        vals = body[:, 2].copy()  # real part, like a naive scanf would read
    else:
        vals = body[:, 2].copy()

    if symmetry != "general":
        sgn = -1.0 if symmetry == "skew-symmetric" else 1.0
        off = rows != cols
        rows, cols, vals = (
            np.concatenate([rows, cols[off]]),
            np.concatenate([cols, rows[off]]),
            np.concatenate([vals, sgn * vals[off]]),
        )

    return rows, cols, vals, (m, n)


def read_mtx_coo(path: str, dtype=np.float64, pad_to=None) -> COO:
    rows, cols, vals, shape = read_mtx_arrays(path)
    return COO.from_arrays(rows, cols, vals.astype(dtype), shape, pad_to=pad_to)


def read_mtx(path: str, dtype=np.float64, pad_to=None) -> CSR:
    """.mtx -> canonical CSR (the ``init_csr_matrix_from_file`` analog,
    ``nsparse.cu:138-144``)."""
    import scipy.sparse as sp

    rows, cols, vals, shape = read_mtx_arrays(path)
    coo = sp.coo_matrix((vals.astype(dtype), (rows, cols)), shape=shape)
    return CSR.from_scipy(coo, pad_to=pad_to)


def write_mtx(path: str, a: CSR, symmetry: str = "general") -> None:
    s = a.to_scipy().tocoo()
    with open(path, "w") as f:
        f.write(f"%%MatrixMarket matrix coordinate real {symmetry}\n")
        f.write(f"{a.shape[0]} {a.shape[1]} {s.nnz}\n")
        for r, c, v in zip(s.row, s.col, s.data):
            f.write(f"{r + 1} {c + 1} {v:.17g}\n")
