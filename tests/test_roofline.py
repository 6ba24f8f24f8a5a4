"""Published-peaks table: keyed by device kind, no default."""

import types

import pytest

from nsparse_jax.utils.roofline import (
    chip_specs,
    nvidia_smi_card,
    spmv_roofline_gflops,
)


def _device(kind):
    return types.SimpleNamespace(device_kind=kind)


def test_h100_entry_is_sourced():
    spec = chip_specs(_device("NVIDIA H100 80GB HBM3"))
    assert spec.hbm_gbps == 3350.0
    assert spec.peak_bf16_tflops == 989.0
    assert spec.peak_f32_tflops == 67.0
    assert "data sheet" in spec.source


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB"])
def test_unknown_device_raises(kind):
    with pytest.raises(ValueError, match="no published peaks"):
        chip_specs(_device(kind))


def test_spmv_roofline_scales_with_bandwidth():
    spec = chip_specs(_device("NVIDIA H100 80GB HBM3"))
    # 1M nnz CSR SpMV moves 8 MB of entries + 8 MB of vectors: ~16 MB at
    # 3.35 TB/s is ~4.8 us for 2 MFLOP -> ~419 GFLOP/s
    gf = spmv_roofline_gflops(1_000_000, 1_000_000, 1_000_000, spec=spec)
    assert 400 < gf < 440


def test_nvidia_smi_card_reports_a_string():
    # "unavailable (...)" where the tool is missing, else name and limit
    assert isinstance(nvidia_smi_card(), str)
