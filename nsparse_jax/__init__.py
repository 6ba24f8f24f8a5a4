"""nsparse_jax — sparse matrix kernel library on JAX/XLA.

A from-scratch JAX rebuild of the capabilities of nsparse (EBD-CREST:
AMB-format auto-tuned SpMV and two-phase hash SpGEMM):

- The reference's shared-memory hash-table SpGEMM (symbolic nnz count +
  numeric accumulate, ``cuda-c/src/kernel/kernel_spgemm_hash_template.cu``)
  is reformulated as **expand / sort / compress** row products using
  ``jax.lax.sort`` + ``segment_sum`` — deterministic, race-free, and with
  a symbolic plan that value-only re-runs reuse.
- The reference's AMB format (adaptive multi-level blocking,
  ``cuda-c/src/conversion/convert_amb.cu``) becomes sigma-sorted ELL slabs,
  diagonal (DIA) storage and blocked-sparse-row (BSR) tiles.
- Thrust sort/scan become ``jax.lax`` primitives; per-row FLOP binning
  (``set_max_bin``/``set_min_bin``) becomes padded per-bin batches.
- The cuSPARSE baseline role is played by ``scipy.sparse`` (oracle) and
  ``jax.experimental.sparse`` (vendor-ish XLA baseline).
"""

from nsparse_jax.utils.hostmem import tune_host_memory as _tune_host_memory

_tune_host_memory()  # THP off: 2-3x faster plan builds on microVM hosts

from nsparse_jax.formats.csr import CSR
from nsparse_jax.formats.coo import COO
from nsparse_jax.formats.ell import ELL
from nsparse_jax.formats.bsr import BSR
from nsparse_jax.formats.dia import DIA
from nsparse_jax.io.matrix_market import read_mtx, write_mtx
from nsparse_jax.ops.spmv import (spmv, spmv_csr, spmv_dia, spmv_ell,
                                  spmm, spmm_csr, spmm_bsr)
from nsparse_jax.ops.spgemm import (
    spgemm,
    spgemm_flops,
    SpgemmPlan,
    spgemm_plan,
    spgemm_numeric,
)
from nsparse_jax.ops.spgemm_bsr import (
    BsrSpgemmPlan,
    choose_spgemm_path,
    plan_spgemm_bsr,
    spgemm_bsr,
)
from nsparse_jax.tune.plan import Plan
from nsparse_jax.tune.autotune import autotune_spmv

__version__ = "0.1.0"

__all__ = [
    "CSR",
    "COO",
    "ELL",
    "BSR",
    "DIA",
    "read_mtx",
    "write_mtx",
    "spmv",
    "spmv_csr",
    "spmv_dia",
    "spmv_ell",
    "spmm",
    "spmm_csr",
    "spmm_bsr",
    "spgemm",
    "spgemm_flops",
    "SpgemmPlan",
    "spgemm_plan",
    "spgemm_numeric",
    "BsrSpgemmPlan",
    "choose_spgemm_path",
    "plan_spgemm_bsr",
    "spgemm_bsr",
    "Plan",
    "autotune_spmv",
]
