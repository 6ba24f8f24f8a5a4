"""CSR container — the library's canonical format.

JAX rethink of the reference's ``sfCSR`` struct
(``cuda-c/inc/nsparse.h:62-75``) and ``CSR<idType, valType>`` class
(``cuda-cpp/inc/CSR.hpp:10-132``):

- a frozen dataclass registered as a JAX pytree, so a CSR flows through
  ``jit`` / ``shard_map`` / ``grad`` like any array;
- no H<->D memcpy API (``csr_memcpy`` / ``csr_memcpyDtH``,
  ``nsparse.cu:146-168``) — device placement is JAX's job;
- arrays are padded to a static capacity (``nnz`` real entries followed by
  ``col == 0, val == 0`` no-ops) because XLA requires static shapes; this is
  the design answer to the reference's dynamic ``cudaMalloc`` sizing.

Canonical form: per-row column indices sorted ascending, duplicates summed
(the reference keeps file order, ``nsparse.cu:119-133``; sorted canonical
form is what makes the SpGEMM structure comparison exact, mirroring how the
reference sorts SpGEMM output rows to compare against cuSPARSE,
``kernel_spgemm_hash_template.cu:805-815``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from nsparse_jax.formats.coo import COO


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CSR:
    """Compressed sparse row matrix with static padded capacity.

    Attributes:
      rpt: (M+1,) int32 row pointers (``rpt[M] == nnz``).
      col: (capacity,) int32 column indices; padded tail is 0.
      val: (capacity,) values; padded tail is 0.
      shape: static (M, N).
      nnz: static true non-zero count (<= capacity).
    """

    rpt: jax.Array
    col: jax.Array
    val: jax.Array
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    nnz: int = dataclasses.field(metadata=dict(static=True))

    # -- construction ------------------------------------------------------

    @classmethod
    def from_scipy(cls, mat, dtype=None, pad_to: int | None = None) -> "CSR":
        m = mat.tocsr()
        m.sum_duplicates()
        m.sort_indices()
        val = m.data if dtype is None else m.data.astype(dtype)
        return cls.from_arrays(m.indptr, m.indices, val, m.shape, pad_to=pad_to)

    @classmethod
    def from_arrays(cls, rpt, col, val, shape, pad_to: int | None = None) -> "CSR":
        rpt = np.asarray(rpt, dtype=np.int32)
        col = np.asarray(col, dtype=np.int32)
        val = np.asarray(val)
        nnz = int(rpt[-1])
        cap = int(pad_to) if pad_to is not None else max(nnz, 1)
        if cap < nnz:
            raise ValueError(f"pad_to={cap} < nnz={nnz}")
        pc = np.zeros(cap, dtype=np.int32)
        pv = np.zeros(cap, dtype=val.dtype)
        pc[:nnz] = col[:nnz]
        pv[:nnz] = val[:nnz]
        out = cls(
            rpt=jnp.asarray(rpt),
            col=jnp.asarray(pc),
            val=jnp.asarray(pv),
            shape=(int(shape[0]), int(shape[1])),
            nnz=nnz,
        )
        # cache the host copies: conversions / planners read them without a
        # device->host transfer
        object.__setattr__(out, "_host", (rpt, pc, pv))
        return out

    @classmethod
    def from_dense(cls, dense, pad_to: int | None = None) -> "CSR":
        import scipy.sparse as sp

        return cls.from_scipy(sp.csr_matrix(np.asarray(dense)), pad_to=pad_to)

    @classmethod
    def from_coo(cls, coo: COO, pad_to: int | None = None) -> "CSR":
        """Host-side COO -> CSR (sorted, duplicates summed)."""
        return cls.from_scipy(coo.to_scipy(), pad_to=pad_to)

    # -- properties --------------------------------------------------------

    @property
    def dtype(self):
        return self.val.dtype

    @property
    def capacity(self) -> int:
        return int(self.val.shape[0])

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    def nnz_per_row(self) -> jax.Array:
        return self.rpt[1:] - self.rpt[:-1]

    def nnz_max(self) -> int:
        """Max nnz in any row (reference tracks this during file read,
        ``nsparse.cu:100-107``)."""
        return int(jnp.max(self.nnz_per_row()))

    def valid_mask(self) -> jax.Array:
        return jnp.arange(self.capacity, dtype=jnp.int32) < self.nnz

    def row_ids(self) -> jax.Array:
        """Expand rpt to a per-entry row index (padded tail -> M).

        The CSR->COO expansion the reference does implicitly by launching a
        thread per row.  Scatter-increment + cumsum: O(M) scatter + O(nnz)
        scan, one pass over the entries.
        """
        m = self.shape[0]
        idx = jnp.arange(self.capacity, dtype=jnp.int32)
        starts = jnp.zeros(self.capacity + 1, jnp.int32)
        # row r begins at rpt[r]: +1 markers at every row start past 0,
        # clipped into [0, capacity] (empty tail rows pile at the end)
        starts = starts.at[jnp.clip(self.rpt[1:m], 0, self.capacity)].add(1)
        rows = jnp.cumsum(starts[: self.capacity]).astype(jnp.int32)
        return jnp.where(idx < self.nnz, rows, m)

    def host_arrays(self):
        """(rpt, col, val) as numpy — cached when built from host data.

        Host-side planners/converters go through this so matrices built on
        the host never round-trip through the device (the analog concern of
        the reference keeping a CPU copy alongside the device copy,
        ``sfCSR``'s twin pointer sets, ``nsparse.h:62-75``).
        """
        cached = getattr(self, "_host", None)
        if cached is not None:
            return cached
        host = (
            np.asarray(self.rpt),
            np.asarray(self.col),
            np.asarray(self.val),
        )
        object.__setattr__(self, "_host", host)
        return host

    # -- conversion / host interop ----------------------------------------

    def with_capacity(self, cap: int) -> "CSR":
        cap = max(int(cap), self.nnz, 1)
        if cap == self.capacity:
            return self
        if cap > self.capacity:
            pad = cap - self.capacity
            return dataclasses.replace(
                self,
                col=jnp.pad(self.col, (0, pad)),
                val=jnp.pad(self.val, (0, pad)),
            )
        return dataclasses.replace(
            self, col=self.col[:cap], val=self.val[:cap]
        )

    def astype(self, dtype) -> "CSR":
        return dataclasses.replace(self, val=self.val.astype(dtype))

    def to_dense(self) -> jax.Array:
        m, n = self.shape
        rows = jnp.clip(self.row_ids(), 0, m - 1)
        v = jnp.where(self.valid_mask(), self.val, 0)
        out = jnp.zeros((m, n), dtype=self.val.dtype)
        return out.at[rows, self.col].add(v)

    def to_scipy(self):
        import scipy.sparse as sp

        nnz = self.nnz
        rpt, col, val = self.host_arrays()
        return sp.csr_matrix(
            (val[:nnz], col[:nnz], rpt), shape=self.shape
        )

    def transpose(self) -> "CSR":
        """Host-side transpose (CSR of A^T), preserving capacity."""
        return CSR.from_scipy(self.to_scipy().T.tocsr(), pad_to=self.capacity)

    def __eq__(self, other) -> bool:  # structural + tolerant value compare
        """Mirror of the reference's tolerant matrix compare
        (``cuda-cpp/inc/CSR.hpp:34-91``): exact rpt/col, rtol values."""
        from nsparse_jax.utils.checking import csr_allclose

        if not isinstance(other, CSR):
            return NotImplemented
        return csr_allclose(self, other)

    def __hash__(self):
        return id(self)
