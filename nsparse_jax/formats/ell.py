"""Sigma-sorted, width-binned ELL slabs — the XLA form of AMB / SELL-C-sigma.

The reference's AMB format (``cuda-c/src/conversion/convert_amb.cu``) is
hand-scheduled CUDA: warp-sized chunks, 16-bit compressed column indices,
atomic scatter into a permuted output.  Under XLA the constraint is static
rectangular shapes, so the design here is:

- sort rows by descending nnz (the sigma-sort of ``convert_amb.cu:670-696``,
  with sigma = whole matrix by default);
- bin rows into geometric width classes W in {8, 16, 32, ...} (the analog of
  AMB's block_size search + the SpGEMM row binning) and pack each class into
  a rectangular **slab** stored width-major ``(W, R)`` with R padded to a
  multiple of 128 rows — each ``val[w, :] * x[col[w, :]]`` step is then a
  fully vectorized gather+FMA over the row dimension with **no scatter**;
- the output permutation is applied as a *gather* (``y_all[pos]``) instead of
  the reference's atomicAdd scatter (``kernel_spmv_amb.cu:67-78``): every row
  lives in exactly one slab, so no accumulation across slabs is needed.

Padding slots carry ``col == 0, val == 0`` (explicit zeros, the analog of
``set_blocked_col_val``'s zero fill, ``convert_amb.cu:473-525``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from nsparse_jax.formats.csr import CSR

ROW_PAD = 128  # slab row counts are padded to a multiple of this


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ELL:
    """Width-binned ELL slabs.

    Attributes:
      vals: tuple of ``(W_i, R_i)`` value slabs (width-major).
      cols: tuple of ``(W_i, R_i)`` int32 column-index slabs.
      pos:  ``(M,)`` int32 — original row -> index into the concatenation of
            per-slab outputs (gather-based inverse of the sort permutation).
      shape: static (M, N).
      widths: static tuple of slab widths (for reporting / tuning).
      nnz: static true nnz.
    """

    vals: Tuple[jax.Array, ...]
    cols: Tuple[jax.Array, ...]
    pos: jax.Array
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    widths: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    nnz: int = dataclasses.field(metadata=dict(static=True))
    # per-slab (R_pad,) true row lengths (padding rows 0) — the validity
    # mask for non-plus_times semirings
    lens: Tuple[jax.Array, ...] = ()
    # row splitting (SELL-style chunks): rows wider than split_width are
    # cut into chunks; ``pos`` points at the first chunk and the extra
    # chunk partials combine through these tables (None = no split rows)
    split_rows: object = None     # (k,) int32 original row ids
    split_slots: object = None    # (k, C) int32 extra chunk slots (-1 pad)

    @property
    def dtype(self):
        return self.vals[0].dtype

    @property
    def padded_nnz(self) -> int:
        """Stored slots incl. explicit zeros — the bandwidth cost model input
        (analog of the footprint model in ``convert_amb.cu:785-798``)."""
        return int(sum(v.size for v in self.vals))

    @classmethod
    def from_csr(
        cls,
        a: CSR,
        min_width: int = 8,
        max_slabs: int = 8,
        sigma: int | None = 1024,
        split_width: int | None = 512,
    ) -> "ELL":
        """Host-side conversion (the ``sf_csr2amb`` analog, minus the timer
        search — see ``nsparse_jax.tune.autotune`` for that).

        Args:
          min_width: smallest width class.
          max_slabs: cap on number of width classes (guards compile time).
          sigma: sort window; ``None`` sorts globally.  Matches the role of
            SIGMA=32768 in the reference (``nsparse.h:30``).
          split_width: rows wider than this split into chunks (bounding
            slab padding on power-law degree tails — the few hub rows of
            an R-MAT graph otherwise pad 128-row pow2 slabs nearly empty);
            chunk partials recombine with one tiny gather + add.  None
            disables splitting.
        """
        m, n = a.shape
        rpt, col, val = a.host_arrays()
        col = col[: a.nnz]
        val = val[: a.nnz]
        deg = np.diff(rpt)

        # --- row splitting: virtual rows = chunks of split_width --------
        v_rpt = rpt[:-1].astype(np.int64)
        v_deg = deg.astype(np.int64)
        v_parent = np.arange(m, dtype=np.int64)
        first_chunk = np.ones(m, dtype=bool)
        if split_width is not None and m and deg.max(initial=0) > split_width:
            heavy = np.flatnonzero(deg > split_width)
            nch = -(-deg[heavy] // split_width)
            rep = np.repeat(heavy, nch)
            cum = np.concatenate([[0], np.cumsum(nch)[:-1]])
            kin = (
                np.arange(rep.size, dtype=np.int64)
                - np.repeat(cum, nch)
            )
            ch_rpt = rpt[rep] + kin * split_width
            ch_deg = np.minimum(
                deg[rep] - kin * split_width, split_width
            )
            keepm = deg <= split_width
            v_rpt = np.concatenate([rpt[:-1][keepm], ch_rpt])
            v_deg = np.concatenate([deg[keepm], ch_deg])
            v_parent = np.concatenate(
                [np.flatnonzero(keepm).astype(np.int64), rep]
            )
            first_chunk = np.concatenate(
                [np.ones(int(keepm.sum()), bool), kin == 0]
            )
        mv = v_deg.size  # virtual row count

        # sigma-windowed descending sort by (virtual) row length (sigma=0:
        # no sort — preserves the row order, keeping banded matrices'
        # x accesses local)
        order = np.empty(mv, dtype=np.int64)
        if sigma == 0:
            order = np.arange(mv, dtype=np.int64)
        elif sigma is None or sigma >= mv:
            order = np.argsort(-v_deg, kind="stable")
        else:
            for s in range(0, mv, sigma):
                e = min(s + sigma, mv)
                order[s:e] = s + np.argsort(-v_deg[s:e], kind="stable")

        # geometric width classes
        max_deg = int(v_deg.max()) if mv else 0
        levels = []
        w = max(int(min_width), 1)
        while True:
            levels.append(w)
            if w >= max(max_deg, 1):
                break
            w *= 2
        if len(levels) > max_slabs:
            # merge the smallest classes upward
            levels = levels[len(levels) - max_slabs:]
        levels = sorted(levels)

        # vectorized level assignment: smallest level with w >= deg
        lev_arr = np.asarray(levels, dtype=np.int64)
        level = np.searchsorted(lev_arr, v_deg, side="left")
        level = np.minimum(level, len(levels) - 1)
        if val.size == 0:  # fully empty matrix: keep gathers in-bounds
            val = np.zeros(1, dtype=val.dtype)
            col = np.zeros(1, dtype=col.dtype)

        vals, colss, widths, lens_l = [], [], [], []
        vpos = np.zeros(mv, dtype=np.int32)
        offset = 0
        lev_of_order = level[order]
        for li, w in enumerate(levels):
            rows = order[lev_of_order == li]
            if rows.size == 0:
                continue
            rpad = _round_up(rows.size, ROW_PAD)
            d = np.minimum(v_deg[rows], w)
            # (w, R) gather indices into the flat nnz arrays
            idx = v_rpt[rows][None, :] + np.arange(w)[:, None]
            mask = np.arange(w)[:, None] < d[None, :]
            idx = np.where(mask, idx, 0)
            # padding slots replicate the row's last valid column (val 0) —
            # the reference's leader-replication (convert_amb.cu:104-136),
            # which keeps padding reads next to the row's real ones
            last_idx = np.minimum(
                v_rpt[rows] + np.maximum(d - 1, 0), col.size - 1
            )
            lastcol = np.where(d > 0, col[last_idx], 0).astype(np.int32)
            sval = np.zeros((w, rpad), dtype=val.dtype)
            scol = np.zeros((w, rpad), dtype=np.int32)
            sval[:, : rows.size] = np.where(mask, val[idx], 0)
            scol[:, : rows.size] = np.where(mask, col[idx], lastcol[None, :])
            vpos[rows] = offset + np.arange(rows.size, dtype=np.int32)
            ln = np.zeros(rpad, dtype=np.int32)
            ln[: rows.size] = d
            lens_l.append(jnp.asarray(ln))
            vals.append(jnp.asarray(sval))
            colss.append(jnp.asarray(scol))
            widths.append(w)
            offset += rpad

        # original-row pos = first chunk's slot; extra chunks recombine
        pos = np.zeros(m, dtype=np.int32)
        pos[v_parent[first_chunk]] = vpos[first_chunk]
        split_rows_np = split_slots_np = None
        extra = ~first_chunk
        if extra.any():
            er = v_parent[extra]
            es = vpos[extra]
            o2 = np.argsort(er, kind="stable")
            er = er[o2]
            es = es[o2]
            f2 = np.flatnonzero(
                np.diff(np.concatenate([[-1], er])) != 0
            )
            cnt2 = np.diff(np.concatenate([f2, [er.size]]))
            cmax = int(cnt2.max())
            split_rows_np = er[f2].astype(np.int32)
            split_slots_np = np.full(
                (f2.size, cmax), -1, np.int32
            )
            kk = (
                np.arange(er.size, dtype=np.int64)
                - np.repeat(f2, cnt2)
            )
            split_slots_np[
                np.repeat(np.arange(f2.size), cnt2), kk
            ] = es

        if not vals:  # empty matrix
            vals = [jnp.zeros((1, ROW_PAD), dtype=val.dtype)]
            colss = [jnp.zeros((1, ROW_PAD), dtype=np.int32)]
            widths = [1]
            lens_l = [jnp.zeros(ROW_PAD, dtype=np.int32)]

        return cls(
            vals=tuple(vals),
            cols=tuple(colss),
            pos=jnp.asarray(pos),
            split_rows=(
                jnp.asarray(split_rows_np)
                if split_rows_np is not None else None
            ),
            split_slots=(
                jnp.asarray(split_slots_np)
                if split_slots_np is not None else None
            ),
            shape=(m, n),
            widths=tuple(widths),
            nnz=a.nnz,
            lens=tuple(lens_l),
        )

    def to_dense(self) -> jax.Array:
        m, n = self.shape
        out = np.zeros((m + 1, n), dtype=np.asarray(self.vals[0]).dtype)
        # reconstruct per-slab then gather rows by pos
        outs = []
        for v, c in zip(self.vals, self.cols):
            v = np.asarray(v)
            c = np.asarray(c)
            w, r = v.shape
            slab = np.zeros((r, n), dtype=v.dtype)
            for wi in range(w):
                np.add.at(slab, (np.arange(r), c[wi]), v[wi])
            outs.append(slab)
        all_rows = np.concatenate(outs, axis=0)
        pos = np.asarray(self.pos)
        return jnp.asarray(all_rows[pos])
