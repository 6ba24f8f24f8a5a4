"""DIA (diagonal) format — the zero-gather SpMV path for banded matrices.

The reference's AMB format wins on banded FEM/stencil matrices by making
x accesses cache-local (column segmentation, ``convert_amb.cu:138-165``).
The strongest form of that idea is to eliminate the gather entirely: a
matrix stored by diagonals computes ``y = sum_d vals[d] * shift(x, off_d)``
— every term is an elementwise multiply against a *contiguously shifted* x,
so the whole product is sequential memory traffic with no index reads.

Only diagonals holding at least ``min_fill`` of their possible entries are
stored (explicit zeros elsewhere, the analog of AMB's zero fill,
``convert_amb.cu:473-525``); matrices whose nnz don't concentrate on
diagonals are rejected by ``from_csr`` (the tuner then picks ELL/BSR/CSR).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from nsparse_jax.formats.csr import CSR

ROW_PAD = 128  # stored diagonals are padded to a multiple of this


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DIA:
    """Diagonal-major storage.

    Attributes:
      vals: (ndiag, Mp) per-diagonal values, Mp = M padded to 128;
        vals[d, i] = A[i, i + offsets[d]] (0 where out of range / absent).
      offsets: static tuple of diagonal offsets (col - row).
      shape: static (M, N).
      nnz: static true nnz represented.
    """

    vals: jax.Array
    offsets: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    nnz: int = dataclasses.field(metadata=dict(static=True))

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def ndiag(self) -> int:
        return len(self.offsets)

    @property
    def padded_nnz(self) -> int:
        """Stored slots (bandwidth cost model input)."""
        return int(self.vals.size)

    @classmethod
    def from_csr(
        cls,
        a: CSR,
        max_diags: int = 64,
        min_coverage: float = 0.95,
    ) -> "DIA":
        """Host-side conversion; raises ValueError when the matrix is not
        diagonal-concentrated (>= min_coverage of nnz on <= max_diags
        diagonals)."""
        m, n = a.shape
        rpt, col, val = a.host_arrays()
        nnz = a.nnz
        col = col[:nnz]
        val = val[:nnz]
        rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(rpt))
        offs = col.astype(np.int64) - rows

        uniq, counts = np.unique(offs, return_counts=True)
        order = np.argsort(-counts)
        keep = uniq[order[:max_diags]]
        covered = counts[order[:max_diags]].sum()
        if nnz and covered < min_coverage * nnz:
            raise ValueError(
                f"matrix is not diagonal: {len(uniq)} diagonals, "
                f"top-{max_diags} cover {covered / nnz:.1%} < {min_coverage:.0%}"
            )
        keep = np.sort(keep)

        mp = (m + ROW_PAD - 1) // ROW_PAD * ROW_PAD
        vals = np.zeros((len(keep), mp), dtype=val.dtype)
        on_kept = np.isin(offs, keep)
        kept_idx = np.searchsorted(keep, offs[on_kept])
        vals[kept_idx, rows[on_kept]] = val[on_kept]
        stored = int(on_kept.sum())

        return cls(
            vals=jnp.asarray(vals),
            offsets=tuple(int(o) for o in keep),
            shape=(m, n),
            nnz=stored,
        )

    def to_dense(self) -> jax.Array:
        m, n = self.shape
        out = np.zeros((m, n), dtype=np.asarray(self.vals).dtype)
        v = np.asarray(self.vals)
        for d, off in enumerate(self.offsets):
            i = np.arange(max(0, -off), min(m, n - off))
            out[i, i + off] = v[d, i]
        return jnp.asarray(out)
