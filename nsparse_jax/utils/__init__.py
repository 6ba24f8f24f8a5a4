from nsparse_jax.utils.checking import (
    ans_check,
    check_spgemm_answer,
    csr_allclose,
    spmv_oracle,
    spgemm_oracle,
)
from nsparse_jax.utils.roofline import chip_specs, spmv_roofline_gflops

__all__ = [
    "ans_check",
    "check_spgemm_answer",
    "csr_allclose",
    "spmv_oracle",
    "spgemm_oracle",
    "chip_specs",
    "spmv_roofline_gflops",
]
