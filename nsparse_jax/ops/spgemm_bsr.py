"""Block-sparse SpGEMM: C = A @ B over dense (BS, BS) tiles.

The ESC SpGEMM (``ops/spgemm.py``) moves every intermediate product
through memory.  Matrices whose nonzeros cluster into dense-ish blocks
(FEM stiffness, multi-DOF meshes — the structural class the reference's
AMB blocking targets, ``convert_amb.cu:388-525``) admit a denser path:
blockify A and B, plan the block-level product structure on the host, and
run the numeric phase as one gather of tile pairs, one batched matrix
product, and one ``segment_sum`` over the output tiles.

Zero fill-in inside blocks is the price (the same trade AMB's tuner makes);
``plan_spgemm_bsr`` reports the fill ratio and :func:`choose_spgemm_path`
weighs it against the ESC path.
"""

from __future__ import annotations

import dataclasses

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from nsparse_jax.formats.csr import CSR

# Tile edge: the fastest of 64/128/256 for the numeric phase of the FEM
# matrix in ``chip_smoke.py`` (8,192 rows, 1.5M nnz): 1.10 / 1.03 / 1.29 ms
# on an NVIDIA H100 80GB HBM3, power limit 700 W.
BS = 128

# Path cost model of :func:`choose_spgemm_path`, numeric phase only, from
# the same matrix and card (NVIDIA H100 80GB HBM3, power limit 700 W): the
# ESC numeric took 14.48 ms for 290.6M intermediate products, the block
# numeric 1.03 ms for 2,996 tile pairs of edge 128.
ESC_NS_PER_PRODUCT = 0.050
BSR_US_PER_PAIR = 0.34


def _blockify(a: CSR, bs: int = BS):
    """Host: CSR -> (blocks (nb, bs, bs), block_row, block_col, fill, valid).

    ``fill`` maps every block slot to its source position in the padded
    CSR value array so new values re-blockify ON DEVICE with one gather;
    ``valid`` marks the slots that hold a real entry.
    """
    import scipy.sparse as sp

    m, n = a.shape
    s = a.to_scipy()
    mp = (m + bs - 1) // bs * bs
    np_ = (n + bs - 1) // bs * bs
    s.resize((mp, np_))
    b = s.tobsr(blocksize=(bs, bs))
    b.sort_indices()
    indptr = np.asarray(b.indptr)
    brow = np.repeat(
        np.arange(len(indptr) - 1, dtype=np.int32), np.diff(indptr)
    )
    # same blockification applied to 1-based source positions gives the
    # slot -> source map (0 slots are structural padding)
    si = sp.csr_matrix(
        (
            np.arange(1, a.nnz + 1, dtype=np.float64),
            s.indices,
            s.indptr,
        ),
        shape=(mp, np_),
    ).tobsr(blocksize=(bs, bs))
    si.sort_indices()
    fill = np.asarray(si.data).astype(np.int64).reshape(-1, bs * bs) - 1
    valid = fill >= 0
    fill = np.where(valid, fill, 0)
    return (
        np.asarray(b.data),
        brow,
        np.asarray(b.indices, dtype=np.int32),
        fill.reshape(-1).astype(np.int32),
        valid.reshape(-1),
    )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BsrSpgemmPlan:
    """Block-product schedule for C = A @ B on dense tiles.

    Attributes:
      a_blocks / b_blocks: (nba|nbb, BS, BS) dense tiles.
      pair_a / pair_b: (npair,) tile indices per block product.
      pair_c: (npair,) output tile index, non-decreasing.
      c_block_row / c_block_col: (nbc,) C tile coordinates.
      a_fill / b_fill: (slots,) source position in the padded CSR values
        of each tile slot (re-blockifies new values on device).
      a_fill_mask / b_fill_mask: (slots,) 0/1, zeroes padding slots.
      c_rpt / c_col: element-level pattern of C (sorted within rows).
      c_slot: (c_nnz,) flat index of each C entry into the dense C tiles.
      shape: static (M, N) of C; n_block_rows static.
      fill: stored-slot / true-nnz ratio (cost model input).
      flops: true useful FLOPs (2 * intermediate products of the scalar
        matrices) — the same metric the ESC path reports.
    """

    a_blocks: jax.Array
    b_blocks: jax.Array
    pair_a: jax.Array
    pair_b: jax.Array
    pair_c: jax.Array
    c_block_row: jax.Array
    c_block_col: jax.Array
    a_fill: jax.Array
    b_fill: jax.Array
    a_fill_mask: jax.Array
    b_fill_mask: jax.Array
    c_rpt: jax.Array
    c_col: jax.Array
    c_slot: jax.Array
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    n_block_rows: int = dataclasses.field(metadata=dict(static=True))
    bs: int = dataclasses.field(metadata=dict(static=True))
    fill: float = dataclasses.field(metadata=dict(static=True))
    flops: int = dataclasses.field(metadata=dict(static=True))
    c_nnz: int = dataclasses.field(default=0, metadata=dict(static=True))

    @property
    def n_pairs(self) -> int:
        return int(self.pair_a.shape[0])

    @property
    def n_c_blocks(self) -> int:
        return int(self.c_block_row.shape[0])


def plan_spgemm_bsr(a: CSR, b: CSR, bs: int = BS) -> BsrSpgemmPlan:
    """Host-side block symbolic phase (block-granular ESC planning)."""
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"shape mismatch {a.shape} @ {b.shape}")
    import scipy.sparse as sp

    from nsparse_jax.ops.spgemm import spgemm_flops

    a_blk, a_brow, a_bcol, a_fill, a_mask = _blockify(a, bs)
    b_blk, b_brow, b_bcol, b_fill, b_mask = _blockify(b, bs)

    # block-level product pairs: for each a-block (i,k), every b-block (k,j)
    nbr_a = (a.shape[0] + bs - 1) // bs
    nbc_a = (a.shape[1] + bs - 1) // bs
    nbc_b = (b.shape[1] + bs - 1) // bs
    sa = sp.csr_matrix(
        (np.arange(1, len(a_bcol) + 1), a_bcol, np.concatenate(
            [[0], np.cumsum(np.bincount(a_brow, minlength=nbr_a))]
        )),
        shape=(nbr_a, nbc_a),
    )
    sb = sp.csr_matrix(
        (np.arange(1, len(b_bcol) + 1), b_bcol, np.concatenate(
            [[0], np.cumsum(np.bincount(b_brow, minlength=nbc_a))]
        )),
        shape=(nbc_a, nbc_b),
    )

    # expand block pairs (i,k),(k,j) sorted by (i, j)
    sb_indptr, sb_indices, sb_data = sb.indptr, sb.indices, sb.data
    pairs = []
    for i in range(nbr_a):
        for ap in range(sa.indptr[i], sa.indptr[i + 1]):
            k = sa.indices[ap]
            a_id = int(sa.data[ap]) - 1
            for bp in range(sb_indptr[k], sb_indptr[k + 1]):
                pairs.append((i, int(sb_indices[bp]), a_id, int(sb_data[bp]) - 1))
    pairs.sort()
    pa, pb, pc, crow, ccol = [], [], [], [], []
    c_id = {}
    for i, j, a_id, b_id in pairs:
        if (i, j) not in c_id:
            c_id[(i, j)] = len(c_id)
            crow.append(i)
            ccol.append(j)
        pa.append(a_id)
        pb.append(b_id)
        pc.append(c_id[(i, j)])

    # element-level C pattern (|A| @ |B|) + per-entry tile slot: the
    # extraction back to CSR is then a single on-device gather, and the
    # pattern matches the ESC path's structural output exactly
    sa_abs = a.to_scipy()
    sb_abs = b.to_scipy()
    sa_abs.data = np.abs(sa_abs.data) + 1.0
    sb_abs.data = np.abs(sb_abs.data) + 1.0
    cpat = (sa_abs @ sb_abs).tocsr()
    cpat.sort_indices()
    c_rpt = np.asarray(cpat.indptr, dtype=np.int32)
    c_col = np.asarray(cpat.indices, dtype=np.int32)
    c_rows = np.repeat(
        np.arange(cpat.shape[0], dtype=np.int64), np.diff(cpat.indptr)
    )
    crow_a = np.asarray(crow, dtype=np.int64)
    ccol_a = np.asarray(ccol, dtype=np.int64)
    tile_keys = crow_a * nbc_b + ccol_a  # sorted: pairs were (i, j) sorted
    ekey = (c_rows // bs) * nbc_b + (c_col.astype(np.int64) // bs)
    tid = np.searchsorted(tile_keys, ekey)
    c_slot = (
        tid * (bs * bs) + (c_rows % bs) * bs + (c_col.astype(np.int64) % bs)
    ).astype(np.int32)

    stored = a_blk.size + b_blk.size
    true_nnz = a.nnz + b.nnz
    return BsrSpgemmPlan(
        a_blocks=jnp.asarray(a_blk),
        b_blocks=jnp.asarray(b_blk),
        pair_a=jnp.asarray(np.asarray(pa, np.int32)),
        pair_b=jnp.asarray(np.asarray(pb, np.int32)),
        pair_c=jnp.asarray(np.asarray(pc, np.int32)),
        c_block_row=jnp.asarray(np.asarray(crow, np.int32)),
        c_block_col=jnp.asarray(np.asarray(ccol, np.int32)),
        a_fill=jnp.asarray(a_fill),
        b_fill=jnp.asarray(b_fill),
        a_fill_mask=jnp.asarray(a_mask.astype(np.float32)),
        b_fill_mask=jnp.asarray(b_mask.astype(np.float32)),
        c_rpt=jnp.asarray(c_rpt),
        c_col=jnp.asarray(c_col),
        c_slot=jnp.asarray(c_slot),
        shape=(a.shape[0], b.shape[1]),
        n_block_rows=nbr_a,
        bs=bs,
        fill=stored / max(true_nnz, 1),
        flops=spgemm_flops(a, b),
        c_nnz=int(cpat.nnz),
    )


def spgemm_bsr_blocks(plan: BsrSpgemmPlan) -> jax.Array:
    """Numeric phase: (nbc, bs, bs) dense C tiles.

    Gathers the (a, b) tile of every pair, multiplies all pairs in one
    batched product at full float32 precision (no TF32), and sums each
    output tile's pairs with a ``segment_sum``."""
    ga = plan.a_blocks[plan.pair_a]
    gb = plan.b_blocks[plan.pair_b]
    prods = jnp.einsum(
        "kij,kjl->kil", ga, gb,
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=plan.a_blocks.dtype,
    )
    # pair_c is sorted, but saying so makes XLA's GPU backend emit a
    # scatter kernel whose launch runs out of memory for (bs, bs) windows
    # (NVIDIA H100 80GB HBM3, jax 0.9.0); the unsorted scatter runs.
    return jax.ops.segment_sum(
        prods, plan.pair_c, num_segments=plan.n_c_blocks
    )


def block_stats(a: CSR, b: CSR, bs: int = BS):
    """Host-side cost probe: (block_pairs, a_fill, b_fill) at block size bs.

    Used by :func:`choose_spgemm_path` — the analog of the reference's bin
    dispatch deciding between kernel families by measured row statistics.
    """
    import scipy.sparse as sp

    def graph(m):
        s = m.to_scipy().tocoo()
        br, bc = s.row // bs, s.col // bs
        nbr = (m.shape[0] + bs - 1) // bs
        nbc = (m.shape[1] + bs - 1) // bs
        g = sp.coo_matrix(
            (np.ones(len(br)), (br, bc)), shape=(nbr, nbc)
        ).tocsr()
        g.sum_duplicates()
        g.data[:] = 1.0
        return g

    ga, gb = graph(a), graph(b)
    pairs = int((ga @ gb).sum())  # sum of products of indicator entries
    a_fill = ga.nnz * bs * bs / max(a.nnz, 1)
    b_fill = gb.nnz * bs * bs / max(b.nnz, 1)
    return pairs, a_fill, b_fill


def choose_spgemm_path(a: CSR, b: CSR) -> str:
    """'bsr' when dense-tile products beat the ESC path's per-product cost
    (``ESC_NS_PER_PRODUCT`` vs ``BSR_US_PER_PAIR``, measured on the card);
    also require the block fill not to explode memory."""
    from nsparse_jax.ops.spgemm import spgemm_flops

    pairs, a_fill, b_fill = block_stats(a, b, BS)
    if max(a_fill, b_fill) > 64:
        return "esc"
    esc_ns = spgemm_flops(a, b) // 2 * ESC_NS_PER_PRODUCT
    bsr_ns = pairs * BSR_US_PER_PAIR * 1e3
    return "bsr" if bsr_ns < esc_ns else "esc"


def _reblock(fill, mask, val: jax.Array, bs: int, dtype) -> jax.Array:
    """Device-side re-blockification: padded CSR values -> dense tiles."""
    flat = val.astype(dtype)[fill] * mask.astype(dtype)
    return flat.reshape(-1, bs, bs)


def spgemm_bsr_numeric(plan: BsrSpgemmPlan, a: CSR, b: CSR) -> jax.Array:
    """Values-only re-run (the ``SpGEMM_Hash_Numeric`` analog for the block
    path): re-blockify new A/B values on device, then the block numeric
    phase.  Returns the dense C tiles (``spgemm_bsr`` densifies to CSR)."""
    ab = _reblock(
        plan.a_fill, plan.a_fill_mask, a.val, plan.bs, plan.a_blocks.dtype
    )
    bb = _reblock(
        plan.b_fill, plan.b_fill_mask, b.val, plan.bs, plan.b_blocks.dtype
    )
    return spgemm_bsr_blocks(
        dataclasses.replace(plan, a_blocks=ab, b_blocks=bb)
    )


def spgemm_bsr(a: CSR, b: CSR, plan: BsrSpgemmPlan | None = None) -> CSR:
    """C = A @ B through dense block tiles; returns canonical CSR.

    Extraction back to CSR is a single on-device gather through the plan's
    element-level pattern (``c_slot``); the structural pattern equals the
    ESC path's (all |A|@|B| positions, explicit zeros kept), so the two
    methods are interchangeable.
    """
    if plan is None:
        plan = plan_spgemm_bsr(a, b)
    blocks = spgemm_bsr_blocks(plan)
    c_val = blocks.reshape(-1)[plan.c_slot]
    return CSR(
        rpt=plan.c_rpt,
        col=plan.c_col,
        val=c_val,
        shape=plan.shape,
        nnz=plan.c_nnz,
    )
