from nsparse_jax.io.matrix_market import read_mtx, read_mtx_coo, write_mtx
from nsparse_jax.io.generate import random_csr, rmat_csr, stencil_csr

__all__ = [
    "read_mtx",
    "read_mtx_coo",
    "write_mtx",
    "random_csr",
    "rmat_csr",
    "stencil_csr",
]
