"""Per-row work analysis and geometric binning.

Analog of the reference's BIN machinery (``set_max_bin`` / ``set_min_bin``,
``cuda-c/src/kernel/kernel_spgemm_hash_template.cu:59-235`` and
``cuda-cpp/inc/BIN.hpp``): rows are classed by their work size (intermediate
products before the numeric phase, output nnz after the symbolic phase) into
geometric bins ``(..., min*2^j]``.  Where the reference launches a different
kernel shape per bin on 7 CUDA streams, this library uses bins to build
padded per-class batches (see ``formats/ell.py``) — XLA pipelines the
resulting independent computations.
"""

from __future__ import annotations

from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from nsparse_jax.formats.csr import CSR
from nsparse_jax.ops.spgemm import _intprod_per_row

BIN_NUM = 7  # parity with the reference's BIN_NUM (spgemm_hash_kernel_gen.c)


def flops_per_row(a: CSR, b: CSR) -> jax.Array:
    """Intermediate products per output row (x2 = FLOPs per row)."""
    return _intprod_per_row(a, b)


def bin_rows(
    sizes: np.ndarray,
    min_size: int = 32,
    num_bins: int = BIN_NUM,
) -> List[np.ndarray]:
    """Partition row indices into geometric size classes.

    bin j holds rows with ``size <= min_size * 2**j`` (not in a smaller bin);
    the last bin is unbounded (the reference's "large" bin with the global-
    memory fallback, ``set_row_nz_bin_each_gl``).  Returns a list of index
    arrays; empty bins are kept (empty arrays) so bin identity is stable.
    """
    sizes = np.asarray(sizes)
    edges = [min_size * (1 << j) for j in range(num_bins - 1)]
    bins: List[np.ndarray] = []
    lo = -1
    for e in edges:
        sel = (sizes > lo) & (sizes <= e)
        bins.append(np.nonzero(sel)[0].astype(np.int32))
        lo = e
    bins.append(np.nonzero(sizes > lo)[0].astype(np.int32))
    return bins


def bin_histogram(sizes: np.ndarray, min_size: int = 32,
                  num_bins: int = BIN_NUM) -> Tuple[np.ndarray, np.ndarray]:
    """(bin sizes, bin max) — the diagnostic the reference prints when
    inspecting bin balance."""
    bins = bin_rows(sizes, min_size, num_bins)
    counts = np.array([len(b) for b in bins])
    maxes = np.array(
        [int(np.asarray(sizes)[b].max()) if len(b) else 0 for b in bins]
    )
    return counts, maxes
