from nsparse_jax.formats.coo import COO
from nsparse_jax.formats.csr import CSR
from nsparse_jax.formats.ell import ELL
from nsparse_jax.formats.bsr import BSR

__all__ = ["COO", "CSR", "ELL", "BSR"]
