"""chip_smoke.py's phases at tiny sizes on the CPU, and its refusal to
report a result without a GPU."""

import functools
import json

import pytest

import chip_smoke as cs


@pytest.fixture(scope="module")
def state():
    """Phases 2-6 at tiny sizes; later phases read what earlier ones left."""
    st = {}
    phases = [
        ("plan_reuse", functools.partial(
            cs.phase_spgemm_plan_reuse, scale=7, edge_factor=4, reps=1)),
        ("oneshot", functools.partial(cs.phase_spgemm_oneshot, reps=1)),
        ("f64", functools.partial(
            cs.phase_spgemm_f64, scale=6, edge_factor=4, reps=1)),
        ("block", functools.partial(
            cs.phase_block_spgemm, n_nodes=24, dof=4, neighbors=2,
            bandwidth=4, reps=1)),
        ("spmv", functools.partial(
            cs.phase_spmv, stencil_n=12, rmat_scale=7, rmat_ef=4,
            bsr_block=4, trials=2)),
    ]
    st["results"] = {name: fn(st) for name, fn in phases}
    return st


@pytest.mark.parametrize(
    "name", ["plan_reuse", "oneshot", "f64", "block", "spmv"])
def test_phase_passes_at_tiny_size(state, name):
    res = state["results"][name]
    assert res["ok"], res


def test_route_timings_phase(state):
    from nsparse_jax.utils.roofline import _SPECS

    h100 = _SPECS["NVIDIA H100 80GB HBM3"]
    res = cs.phase_route_timings(state, edges=(4, 8), reps=1, spec=h100)
    assert res["ok"], res
    assert set(res["bsr_tile"]) == {4, 8}
    assert res["spgemm_numeric"]["products"] == state["plan"].n_products


def test_four_cards_phase_on_virtual_mesh():
    res = cs.phase_four_cards({}, n_devices=4, grid=16, rmat_scale=6,
                              rmat_ef=4)
    assert res["ok"], res
    assert res["devices"] == 4


def test_run_phases_reports_a_raising_phase(capsys):
    def boom(state):
        raise RuntimeError("phase failure")

    assert not cs.run_phases([("boom", boom)])
    assert "verdict=FAIL" in capsys.readouterr().out


def test_main_without_gpu_exits_nonzero(capsys):
    rc = cs.main([])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert rc != 0
    line = json.loads(last)
    assert line["ok"] is False
    assert line["device"]["platform"] == "cpu"
