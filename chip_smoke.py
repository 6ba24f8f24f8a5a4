"""Smoke test of the library's main path on an NVIDIA GPU.

Runs every phase in this one process (a second JAX process could not get
the card's memory), prints one line per phase with its sizes, seconds,
peak device memory and a verdict against scipy, and ends with one JSON
line::

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

Usage::

    python chip_smoke.py               # one card: phases 1-7
    python chip_smoke.py --four-cards  # the distributed path on four cards

Phases on one card: 1 environment; 2 SpGEMM A^2 of R-MAT-15 (edge factor
16) with a reused host plan; 3 one-shot SpGEMM through the device planner;
4 float64 SpGEMM; 5 block SpGEMM on an FEM matrix; 6 tuned SpMV on a
2048^2 stencil and an R-MAT-20 graph, and BSR SpMV; 7 the timings that
chose the routes (SpGEMM numeric route, DIA against the memory floor, BSR
tile edge and the path cost model).  It exits non-zero, with ``"ok":
false``, when JAX finds no GPU or any phase fails.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import time
import traceback

import numpy as np


def _time(fn, *args, reps: int = 5):
    """(first-call seconds, median ms of ``reps`` warm calls, last output),
    each call ending in ``block_until_ready``."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first_s = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return first_s, statistics.median(ts) * 1e3, out


def _new_values(a, seed: int):
    """``a`` with fresh random values on the same pattern."""
    import jax.numpy as jnp

    val = np.zeros(a.capacity, dtype=np.asarray(a.val).dtype)
    val[: a.nnz] = np.random.default_rng(seed).standard_normal(a.nnz)
    out = dataclasses.replace(a, val=jnp.asarray(val))
    rpt, col, _ = a.host_arrays()
    object.__setattr__(out, "_host", (rpt, col, val))
    return out


def _spgemm_ok(c, a, b) -> bool:
    from nsparse_jax.utils.checking import (
        check_spgemm_answer, spgemm_abs_oracle, spgemm_oracle,
    )

    return bool(check_spgemm_answer(
        c, spgemm_oracle(a, b), abs_ref=spgemm_abs_oracle(a, b)
    ))


def _spmv_ok(y, a, x) -> bool:
    from nsparse_jax.utils.checking import (
        ans_check, spmv_abs_oracle, spmv_oracle,
    )

    return bool(ans_check(
        np.asarray(y), spmv_oracle(a, x), dtype=np.asarray(y).dtype,
        scale=spmv_abs_oracle(a, x),
    )[0])


def _memory(compiled) -> dict:
    ma = compiled.memory_analysis()
    if ma is None:
        return {}
    return {
        k: int(getattr(ma, f"{k}_size_in_bytes"))
        for k in ("argument", "output", "temp")
        if hasattr(ma, f"{k}_size_in_bytes")
    }


# ---------------------------------------------------------------------------
# phases: each returns a dict of fields; "ok" is its verdict
# ---------------------------------------------------------------------------


def phase_spgemm_plan_reuse(state, scale=15, edge_factor=16, seed=1,
                            reps=5):
    """A^2 of an R-MAT graph, f32: host plan, numeric, numeric re-run with
    new values on the same plan."""
    import jax

    from nsparse_jax.io.generate import rmat_csr
    from nsparse_jax.ops.spgemm import spgemm_numeric, spgemm_plan

    a = rmat_csr(scale, edge_factor=edge_factor, dtype=np.float32, seed=seed)
    t0 = time.perf_counter()
    plan = spgemm_plan(a, a)
    plan_s = time.perf_counter() - t0
    f = jax.jit(spgemm_numeric)
    mem = _memory(f.lower(plan, a, a).compile())
    first_s, ms, c = _time(f, plan, a, a, reps=reps)
    ok = _spgemm_ok(c, a, a)
    a2 = _new_values(a, seed + 100)
    ok_rerun = _spgemm_ok(f(plan, a2, a2), a2, a2)
    state.update(rmat=a, plan=plan)
    return dict(
        rows=a.shape[0], nnz=a.nnz, products=plan.n_products,
        c_nnz=plan.c_nnz, plan_s=plan_s, compile_s=first_s,
        numeric_ms=ms, numeric_memory=mem, ok_first=ok, ok_rerun=ok_rerun,
        ok=ok and ok_rerun,
    )


def phase_spgemm_oneshot(state, reps=3):
    """spgemm(a, a): device planner + numeric per call, on phase 2's A."""
    from nsparse_jax.ops.spgemm import spgemm

    a = state["rmat"]
    first_s, ms, c = _time(lambda: spgemm(a, a), reps=reps)
    return dict(rows=a.shape[0], first_call_s=first_s, oneshot_ms=ms,
                ok=_spgemm_ok(c, a, a))


def phase_spgemm_f64(state, scale=14, edge_factor=8, seed=5, reps=5):
    """f64 A^2 through the same host plan and numeric route, checked at
    the float64 tolerance (1e-8 relative to |A||B|)."""
    import jax

    from nsparse_jax.io.generate import rmat_csr
    from nsparse_jax.ops.spgemm import spgemm_numeric, spgemm_plan

    with jax.enable_x64(True):
        a = rmat_csr(scale, edge_factor=edge_factor, dtype=np.float64,
                     seed=seed)
        plan = spgemm_plan(a, a)
        first_s, ms, c = _time(jax.jit(spgemm_numeric), plan, a, a,
                               reps=reps)
        assert c.val.dtype == np.float64
        ok = _spgemm_ok(c, a, a)
    return dict(rows=a.shape[0], nnz=a.nnz, products=plan.n_products,
                compile_s=first_s, numeric_ms=ms, ok=ok)


def phase_block_spgemm(state, n_nodes=512, dof=16, neighbors=6,
                       bandwidth=24, seed=3, reps=5):
    """FEM block matrix A^2 with method="bsr" and method="auto"."""
    import jax

    from nsparse_jax.io.generate import fem_block_csr
    from nsparse_jax.ops.spgemm import spgemm
    from nsparse_jax.ops.spgemm_bsr import (
        choose_spgemm_path, plan_spgemm_bsr, spgemm_bsr_blocks,
    )

    a = fem_block_csr(n_nodes, dof=dof, neighbors=neighbors,
                      bandwidth=bandwidth, dtype=np.float32, seed=seed)
    plan = plan_spgemm_bsr(a, a)
    first_s, ms, _ = _time(jax.jit(spgemm_bsr_blocks), plan, reps=reps)
    ok_bsr = _spgemm_ok(spgemm(a, a, method="bsr"), a, a)
    path = choose_spgemm_path(a, a)
    ok_auto = _spgemm_ok(spgemm(a, a, method="auto"), a, a)
    state.update(fem=a)
    return dict(rows=a.shape[0], nnz=a.nnz, products=plan.flops // 2,
                tile=plan.bs, pairs=plan.n_pairs, compile_s=first_s,
                numeric_ms=ms, auto_path=path, ok_bsr=ok_bsr,
                ok_auto=ok_auto, ok=ok_bsr and ok_auto)


def _spmv_cases(stencil_n, rmat_scale, rmat_ef):
    from nsparse_jax.io.generate import rmat_csr, stencil_csr
    from nsparse_jax.tune.plan import Plan

    return {
        "stencil": (lambda: stencil_csr(stencil_n, stencil_n,
                                        dtype=np.float32), [
            Plan(format="dia"),
            Plan(format="ell", min_width=8, max_slabs=8, sigma=0),
            Plan(format="csr"),
        ]),
        "rmat": (lambda: rmat_csr(rmat_scale, edge_factor=rmat_ef,
                                  dtype=np.float32, seed=2), [
            Plan(format="ell", min_width=2, max_slabs=10, sigma=1024),
            Plan(format="csr"),
        ]),
    }


def phase_spmv(state, stencil_n=2048, rmat_scale=20, rmat_ef=16,
               bsr_block=16, trials=6):
    """Measured autotuning on a stencil and a power-law graph; the chosen
    format and every measured candidate checked against scipy; BSR SpMV
    on the FEM matrix at the float32 tolerance."""
    import jax
    import jax.numpy as jnp

    from nsparse_jax.formats.bsr import BSR
    from nsparse_jax.ops.spmv import spmv
    from nsparse_jax.tune.autotune import SWEEP, autotune_spmv, build_format

    out, oks = {}, []
    spmv_jit = jax.jit(spmv)
    for name, (make, cands) in _spmv_cases(
            stencil_n, rmat_scale, rmat_ef).items():
        a = make()
        x = jnp.asarray(np.random.default_rng(0).standard_normal(a.shape[1]),
                        dtype=jnp.float32)
        fmt, plan = autotune_spmv(a, x, candidates=cands, trials=trials)
        measured = {s["cand"]: s["ms_per_op"] for s in SWEEP
                    if s["fate"] == "measured"}
        ok_chosen = _spmv_ok(spmv_jit(fmt, x), a, x)
        ok_cands = [_spmv_ok(spmv_jit(build_format(a, c), x), a, x)
                    for c in cands]
        all_measured = len(measured) == len(cands)
        oks += [ok_chosen, all_measured, *ok_cands]
        out[name] = dict(rows=a.shape[0], nnz=a.nnz, chosen=plan.format,
                         ms=measured, ok_chosen=ok_chosen,
                         ok_candidates=all(ok_cands))
        if name == "stencil":
            state.update(stencil=a, stencil_x=x)
    fem = state["fem"]
    b = BSR.from_csr(fem, blocksize=(bsr_block, bsr_block))
    x = jnp.asarray(np.random.default_rng(1).standard_normal(fem.shape[1]),
                    dtype=jnp.float32)
    _, ms, y = _time(spmv_jit, b, x, reps=trials)
    ok_bsr = _spmv_ok(y, fem, x)
    out["bsr_fem"] = dict(rows=fem.shape[0], block=bsr_block, ms=ms,
                          ok=ok_bsr)
    return dict(out, ok=all(oks) and ok_bsr)


def _scan_numeric(plan, a, b, ends):
    """The scan route timed against ``spgemm_numeric``: Hillis-Steele
    segmented inclusive scan over the products, then one gather at each
    output entry's last product."""
    import jax.numpy as jnp

    v = a.val[plan.apos] * b.val[plan.bpos]
    f = jnp.concatenate(
        [jnp.ones((1,), bool), plan.out_pos[1:] != plan.out_pos[:-1]]
    )
    n, d = int(v.shape[0]), 1
    while d < n:
        vs = jnp.concatenate([jnp.zeros((d,), v.dtype), v[:-d]])
        fs = jnp.concatenate([jnp.ones((d,), bool), f[:-d]])
        v = v + jnp.where(f, jnp.zeros_like(v), vs)
        f = f | fs
        d *= 2
    cap = plan.c_capacity
    return jnp.where(jnp.arange(cap) < plan.c_nnz, v[ends], 0)


def phase_route_timings(state, edges=(64, 128, 256), reps=5, spec=None):
    """Timings that chose the routes: the two SpGEMM numeric routes on
    phase 2's plan, the DIA chain against the memory floor of ``spec``
    (default: this device's published peaks), the BSR tile edge and the
    ESC/BSR path costs on the FEM matrix."""
    import jax
    import jax.numpy as jnp

    from nsparse_jax.formats.dia import DIA
    from nsparse_jax.ops.spgemm import spgemm_numeric, spgemm_plan_device
    from nsparse_jax.ops.spgemm_bsr import plan_spgemm_bsr, spgemm_bsr_blocks
    from nsparse_jax.ops.spmv import spmv_dia
    from nsparse_jax.utils.roofline import chip_specs, spmv_bytes
    from nsparse_jax.utils.timing import time_marginal

    out = {}
    a, plan = state["rmat"], state["plan"]
    n = int(plan.out_pos.shape[0])
    ends = jnp.zeros(plan.c_capacity + 1, jnp.int32).at[plan.out_pos].max(
        jnp.arange(n, dtype=jnp.int32))[: plan.c_capacity]
    _, ms_seg, c_seg = _time(jax.jit(spgemm_numeric), plan, a, a, reps=reps)
    _, ms_scan, v_scan = _time(jax.jit(_scan_numeric), plan, a, a, ends,
                               reps=reps)
    ok_scan = _spgemm_ok(
        dataclasses.replace(c_seg, val=v_scan.astype(c_seg.val.dtype)), a, a
    )
    out["spgemm_numeric"] = dict(products=plan.n_products,
                                 segment_sum_ms=ms_seg, scan_ms=ms_scan,
                                 scan_agrees=ok_scan)

    s, x = state["stencil"], state["stencil_x"]
    dia = DIA.from_csr(s)
    # device time per call, without the dispatch a sub-ms host-clock
    # reading would include
    ms_dia = time_marginal(lambda c, i, f: spmv_dia(f, c), x, aux=dia)
    byts = spmv_bytes(s.nnz, *s.shape, val_bytes=4, idx_bytes=0,
                      padded_nnz=dia.padded_nnz)
    spec = spec or chip_specs()
    floor_ms = byts / (spec.hbm_gbps * 1e9) * 1e3
    out["dia"] = dict(rows=s.shape[0], bytes=byts, ms=ms_dia,
                      floor_ms=floor_ms,
                      hbm_share=floor_ms / ms_dia if ms_dia > 0 else None)

    fem = state["fem"]
    tiles = {}
    for bs in edges:
        bplan = plan_spgemm_bsr(fem, fem, bs)
        _, ms, _ = _time(jax.jit(spgemm_bsr_blocks), bplan, reps=reps)
        tiles[bs] = dict(pairs=bplan.n_pairs, ms=ms,
                         us_per_pair=ms * 1e3 / bplan.n_pairs)
    out["bsr_tile"] = tiles
    eplan = spgemm_plan_device(fem, fem)
    _, ms_esc, _ = _time(jax.jit(spgemm_numeric), eplan, fem, fem, reps=reps)
    out["fem_esc"] = dict(products=eplan.n_products, ms=ms_esc,
                          ns_per_product=ms_esc * 1e6 / eplan.n_products)
    return dict(out, ok=ok_scan)


def phase_four_cards(state, n_devices=4, grid=1024, rmat_scale=15,
                     rmat_ef=16):
    """parallel/ on ``n_devices`` cards: replicated-x SpMV, row-sharded
    SpGEMM with plan reuse, halo SpMV and SpGEMM, and both R.A.P."""
    import jax
    import jax.numpy as jnp
    import scipy.sparse as sp

    from nsparse_jax.formats.csr import CSR
    from nsparse_jax.io.generate import rmat_csr, stencil_csr
    from nsparse_jax.parallel import (
        gather_partitioned, make_mesh, partition_banded, partition_rows,
        rap_dist, rap_halo, shard_x, spgemm_halo, spmv_dist, spmv_halo,
    )
    from nsparse_jax.parallel.spgemm import (
        spgemm_numeric_dist, spgemm_plan_dist,
    )
    from nsparse_jax.utils.checking import check_spgemm_answer

    mesh = make_mesh(n_devices)
    devices = set(mesh.devices.flat)

    def spread(arr) -> bool:
        """True when ``arr``'s shards sit on all the mesh's devices."""
        return {s.device for s in arr.addressable_shards} == devices

    def rap_ok(got, r, a, p) -> bool:
        rs, as_, ps = r.to_scipy(), a.to_scipy(), p.to_scipy()
        ref = (rs @ as_ @ ps).tocsr()
        scale = (abs(rs) @ abs(as_) @ abs(ps)).tocsr()
        for m in (ref, scale):
            m.sum_duplicates()
            m.sort_indices()
        return bool(check_spgemm_answer(got, ref, abs_ref=scale))

    out = {}
    a = stencil_csr(grid, grid, dtype=np.float32)
    n = a.shape[0]
    x = np.random.default_rng(0).standard_normal(n).astype(np.float32)
    part = partition_rows(a, n_devices)
    y = spmv_dist(part, jnp.asarray(x), mesh, gather=False)
    out["spmv_dist"] = dict(
        rows=n, ok=_spmv_ok(np.asarray(y).reshape(-1)[:n], a, x),
        spread=spread(y))

    g = rmat_csr(rmat_scale, edge_factor=rmat_ef, dtype=np.float32, seed=1)
    gpart = partition_rows(g, n_devices)
    t0 = time.perf_counter()
    dplan = spgemm_plan_dist(gpart, g)
    plan_s = time.perf_counter() - t0
    c = spgemm_numeric_dist(dplan, gpart, g, mesh)
    ok1 = _spgemm_ok(gather_partitioned(c), g, g)
    g2 = _new_values(g, 7)
    c2 = spgemm_numeric_dist(dplan, partition_rows(g2, n_devices), g2, mesh)
    ok2 = _spgemm_ok(gather_partitioned(c2), g2, g2)
    out["spgemm_dist"] = dict(rows=g.shape[0], products=dplan.n_products,
                              plan_s=plan_s, ok_first=ok1, ok_rerun=ok2,
                              spread=spread(c.val))

    hp = partition_banded(a, n_devices)
    yh = spmv_halo(hp, shard_x(jnp.asarray(x), n_devices, hp.m_loc), mesh)
    out["spmv_halo"] = dict(
        halo=hp.halo, ok=_spmv_ok(np.asarray(yh).reshape(-1)[:n], a, x),
        spread=spread(yh))

    ch = spgemm_halo(part, part, mesh)
    out["spgemm_halo"] = dict(ok=_spgemm_ok(gather_partitioned(ch), a, a),
                              spread=spread(ch.val))

    nc = n // 4
    p_s = sp.csr_matrix(
        (np.ones(n, np.float32), (np.arange(n), np.arange(n) // 4)),
        shape=(n, nc))
    p, r = CSR.from_scipy(p_s), CSR.from_scipy(p_s.T.tocsr())
    out["rap_dist"] = dict(coarse=nc, ok=rap_ok(rap_dist(r, a, p, mesh),
                                                r, a, p))
    rh = rap_halo(partition_rows(r, n_devices), part,
                  partition_rows(p, n_devices), mesh)
    out["rap_halo"] = dict(ok=rap_ok(gather_partitioned(rh), r, a, p),
                           spread=spread(rh.val))
    ok = all(
        v.get("ok", True) and v.get("ok_first", True)
        and v.get("ok_rerun", True) and v.get("spread", True)
        for v in out.values()
    )
    return dict(out, devices=len(devices), ok=ok)


ONE_CARD_PHASES = (
    ("spgemm_plan_reuse", phase_spgemm_plan_reuse),
    ("spgemm_oneshot", phase_spgemm_oneshot),
    ("spgemm_f64", phase_spgemm_f64),
    ("block_spgemm", phase_block_spgemm),
    ("spmv", phase_spmv),
    ("route_timings", phase_route_timings),
)
FOUR_CARD_PHASES = (("four_cards", phase_four_cards),)


def run_phases(phases, state=None) -> bool:
    """Run each phase, print its line, return whether all passed.  A
    phase that raises fails; its traceback goes to stderr."""
    import jax

    state = {} if state is None else state
    dev = jax.devices()[0]
    all_ok = True
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            res = fn(state)
        except Exception:  # reported as this phase's failure
            traceback.print_exc()
            res = dict(ok=False, error="raised")
        res["seconds"] = round(time.perf_counter() - t0, 3)
        stats = dev.memory_stats() or {}
        res["peak_bytes"] = stats.get("peak_bytes_in_use")
        ok = bool(res.pop("ok"))
        all_ok &= ok
        print(f"phase {name}: {json.dumps(res, default=str)} "
              f"verdict={'pass' if ok else 'FAIL'}", flush=True)
    return all_ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the distributed phase, on four cards")
    args = ap.parse_args(argv)

    device = {}
    ok = False
    try:
        import jax

        from nsparse_jax.utils.compile_cache import enable_compile_cache
        from nsparse_jax.utils.roofline import nvidia_smi_card

        cache = enable_compile_cache()
        devs = jax.devices()
        device = dict(platform=devs[0].platform, kind=devs[0].device_kind,
                      count=len(devs))
        print(f"phase environment: devices={device} jax={jax.__version__} "
              f"compile_cache={cache}", flush=True)
        print(f"card: {nvidia_smi_card()}", flush=True)
        if device["platform"] != "gpu":
            print("error: no GPU found; this script measures the card only",
                  file=sys.stderr)
        elif args.four_cards and device["count"] < 4:
            print(f"error: --four-cards needs 4 GPUs, found "
                  f"{device['count']}", file=sys.stderr)
        else:
            ok = run_phases(
                FOUR_CARD_PHASES if args.four_cards else ONE_CARD_PHASES
            )
    except Exception:  # set-up failed: report, exit non-zero
        traceback.print_exc()
        ok = False
    print(json.dumps({"ok": ok, "device": device}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
