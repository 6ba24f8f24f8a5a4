from nsparse_jax.ops.spmv import spmv, spmv_csr, spmv_ell, spmv_bsr
from nsparse_jax.ops.spgemm import (
    spgemm,
    spgemm_flops,
    SpgemmPlan,
    spgemm_plan,
    spgemm_numeric,
)
from nsparse_jax.ops.binning import flops_per_row, bin_rows

__all__ = [
    "spmv",
    "spmv_csr",
    "spmv_ell",
    "spmv_bsr",
    "spgemm",
    "spgemm_flops",
    "SpgemmPlan",
    "spgemm_plan",
    "spgemm_numeric",
    "flops_per_row",
    "bin_rows",
]
