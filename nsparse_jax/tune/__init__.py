from nsparse_jax.tune.plan import Plan
from nsparse_jax.tune.autotune import autotune_spmv

__all__ = ["Plan", "autotune_spmv"]
