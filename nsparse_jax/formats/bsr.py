"""Block-sparse-row (BSR) format — dense tiles.

This is the second half of the AMB analog: where the reference merges
adjacent columns into small dense blocks (block_size 1..20,
``convert_amb.cu:388-525``) so each ushort column load amortizes over
block_size FMAs, this version stores ``(br, bc)`` dense tiles so one index
read serves a whole tile and the product is a batched dense one.
Explicit zero fill inside a tile is the price of dense compute, exactly the
trade AMB's tuner makes — our tuner (``nsparse_jax.tune.autotune``) weighs
measured time the same way ``convert_amb_at`` does.

Blocks are stored row-major by block row (sorted by block column within a
row).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from nsparse_jax.formats.csr import CSR


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BSR:
    """Block sparse row matrix.

    Attributes:
      data: (nblocks, br, bc) dense tiles.
      block_col: (nblocks,) int32 block-column index of each tile.
      block_row: (nblocks,) int32 block-row index of each tile (expanded
        from block_rpt so a flat grid can prefetch it).
      block_rpt: (n_block_rows + 1,) int32 tile row pointers.
      shape: static logical (M, N).
      blocksize: static (br, bc).
      nnz: static true scalar nnz of the source matrix.
    """

    data: jax.Array
    block_col: jax.Array
    block_row: jax.Array
    block_rpt: jax.Array
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    blocksize: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    nnz: int = dataclasses.field(metadata=dict(static=True))

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def nblocks(self) -> int:
        return int(self.data.shape[0])

    @property
    def n_block_rows(self) -> int:
        return int(self.block_rpt.shape[0]) - 1

    @property
    def padded_nnz(self) -> int:
        """Stored slots including explicit zeros (bandwidth cost model)."""
        return int(self.data.size)

    @property
    def fill_ratio(self) -> float:
        return self.padded_nnz / max(self.nnz, 1)

    @classmethod
    def from_csr(cls, a: CSR, blocksize: Tuple[int, int] = (8, 128)) -> "BSR":
        """Host-side conversion via scipy's BSR (zero-fill inside tiles).

        Every block row is guaranteed at least one tile (a zero tile at
        block column 0 if empty) so every output block is written — the analog of the reference zero-filling y first
        (``kernel_spmv_init_ans``, ``kernel_spmv_amb.cu:10-19``).
        """
        import scipy.sparse as sp

        br, bc = blocksize
        m, n = a.shape
        mp = ((m + br - 1) // br) * br
        np_ = ((n + bc - 1) // bc) * bc
        s = a.to_scipy()
        s = sp.csr_matrix((s.data, s.indices, s.indptr), shape=(m, n))
        s.resize((mp, np_))
        b = s.tobsr(blocksize=(br, bc))
        b.sort_indices()

        indptr = np.asarray(b.indptr, dtype=np.int32)
        indices = np.asarray(b.indices, dtype=np.int32)
        data = np.asarray(b.data)

        # insert a zero tile for empty block rows
        nbr = mp // br
        counts = np.diff(indptr)
        if (counts == 0).any():
            new_counts = np.maximum(counts, 1)
            new_indptr = np.zeros(nbr + 1, dtype=np.int32)
            np.cumsum(new_counts, out=new_indptr[1:])
            nblocks = int(new_indptr[-1])
            new_data = np.zeros((nblocks, br, bc), dtype=data.dtype)
            new_indices = np.zeros(nblocks, dtype=np.int32)
            for i in range(nbr):
                s0, e0 = indptr[i], indptr[i + 1]
                d0 = new_indptr[i]
                if e0 > s0:
                    new_data[d0 : d0 + (e0 - s0)] = data[s0:e0]
                    new_indices[d0 : d0 + (e0 - s0)] = indices[s0:e0]
            indptr, indices, data = new_indptr, new_indices, new_data

        block_row = (
            np.searchsorted(indptr, np.arange(len(indices)), side="right") - 1
        ).astype(np.int32)

        return cls(
            data=jnp.asarray(data),
            block_col=jnp.asarray(indices),
            block_row=jnp.asarray(block_row),
            block_rpt=jnp.asarray(indptr),
            shape=(m, n),
            blocksize=(br, bc),
            nnz=a.nnz,
        )

    def to_dense(self) -> jax.Array:
        br, bc = self.blocksize
        m, n = self.shape
        nbr = self.n_block_rows
        nbc = ((n + bc - 1) // bc)
        dense = np.zeros((nbr * br, nbc * bc), dtype=np.asarray(self.data).dtype)
        data = np.asarray(self.data)
        bcol = np.asarray(self.block_col)
        brow = np.asarray(self.block_row)
        for k in range(self.nblocks):
            r, c = brow[k] * br, bcol[k] * bc
            dense[r : r + br, c : c + bc] += data[k]
        return jnp.asarray(dense[:m, :n])
