"""Published device peaks and roofline models.

The reference reports raw GFLOPS (``spmv_amb.cu:62``, ``spgemm_hash.cu:52``)
and leaves roofline context to the papers.  Here the roofline is first-class:
both SpMV and SpGEMM are memory-bound, so the model is bytes moved over
memory bandwidth.
"""

from __future__ import annotations

import dataclasses
import subprocess

import jax


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    hbm_gbps: float          # device-memory bandwidth, GB/s
    peak_bf16_tflops: float  # dense tensor-core rate
    peak_f32_tflops: float   # float32 outside the tensor cores
    source: str


# Keyed by ``jax.Device.device_kind``.  The rates assume the card's full
# power limit; a card set below it cannot hold its top clock under load.
_SPECS = {
    "NVIDIA H100 80GB HBM3": ChipSpec(
        "NVIDIA H100 SXM", 3350.0, 989.0, 67.0,
        "NVIDIA H100 Tensor Core GPU data sheet, SXM5, dense rates, 700 W",
    ),
}


def chip_specs(device=None) -> ChipSpec:
    """Published peaks of ``device`` (default: the first JAX device).

    Raises ValueError for a device kind with no entry: a roofline share
    against made-up peaks would be a wrong number, not a default."""
    kind = (device or jax.devices()[0]).device_kind
    try:
        return _SPECS[kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {kind!r}; add its data "
            "sheet entry to nsparse_jax/utils/roofline.py"
        ) from None


def nvidia_smi_card() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them (a
    card set below its maximum power runs slower under load), read by a
    child process that does not touch JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"unavailable ({type(e).__name__})"
    return "; ".join(line.strip() for line in out.splitlines() if line.strip())


def spmv_bytes(nnz: int, m: int, n: int, val_bytes: int = 4,
               idx_bytes: int = 4, padded_nnz: int | None = None) -> int:
    """Minimum HBM traffic for one SpMV: read vals + indices + x, write y.

    ``padded_nnz`` accounts for explicit-zero fill in ELL/BSR layouts.
    """
    stored = padded_nnz if padded_nnz is not None else nnz
    return stored * (val_bytes + idx_bytes) + n * val_bytes + m * val_bytes


def spmv_roofline_gflops(nnz: int, m: int, n: int, val_bytes: int = 4,
                         idx_bytes: int = 4,
                         padded_nnz: int | None = None,
                         spec: ChipSpec | None = None) -> float:
    """Bandwidth-bound GFLOPS ceiling for y = A @ x (useful flops = 2*nnz)."""
    spec = spec or chip_specs()
    bytes_moved = spmv_bytes(nnz, m, n, val_bytes, idx_bytes, padded_nnz)
    seconds_per_op = bytes_moved / (spec.hbm_gbps * 1e9)
    return 2.0 * nnz / seconds_per_op / 1e9


def spgemm_bytes(nnz_a: int, nnz_b: int, nnz_c: int, n_products: int,
                 val_bytes: int = 4, idx_bytes: int = 4) -> int:
    """Approximate minimum HBM traffic for C = A @ B (hash-style ideal):
    read A and B once, write C once, touch each intermediate product once."""
    per_nnz = val_bytes + idx_bytes
    return (nnz_a + nnz_b + nnz_c) * per_nnz + n_products * per_nnz


def spgemm_roofline_gflops(nnz_a: int, nnz_b: int, nnz_c: int,
                           n_products: int, val_bytes: int = 4,
                           idx_bytes: int = 4,
                           spec: ChipSpec | None = None) -> float:
    spec = spec or chip_specs()
    bytes_moved = spgemm_bytes(nnz_a, nnz_b, nnz_c, n_products, val_bytes,
                               idx_bytes)
    seconds = bytes_moved / (spec.hbm_gbps * 1e9)
    return 2.0 * n_products / seconds / 1e9
