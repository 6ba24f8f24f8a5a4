"""Benchmark / sample CLI — analog of the reference sample binaries.

Reference mapping (SURVEY.md section 2, L4):
  ./bin/amb_s file.mtx            -> python -m nsparse_jax spmv file.mtx
  ./bin/cu_csr_s file.mtx         -> python -m nsparse_jax spmv-xla file.mtx
  ./bin/spgemm_hash_s file.mtx    -> python -m nsparse_jax spgemm file.mtx
  ./bin/spgemm_cu_csr_s file.mtx  -> python -m nsparse_jax spgemm-xla file.mtx

Same harness shape as the reference samples (``spmv_amb.cu:75-118``,
``spgemm_hash.cu:79-94``): load matrix -> convert/tune -> timed trials ->
GFLOPS -> verify vs oracle; plus what the reference lacks: a roofline %
readout on a device with published peaks.  The "-xla" variants play
cuSPARSE's role via ``jax.experimental.sparse`` (BCOO).
Synthetic matrices: pass ``gen:stencil:NX:NY``, ``gen:rmat:SCALE:EF`` or
``gen:random:M:N:DENSITY`` instead of a path.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def _load(spec: str, dtype):
    from nsparse_jax.io.generate import (fem_block_csr, random_csr, rmat_csr,
                                         stencil_csr)
    from nsparse_jax.io.matrix_market import read_mtx

    if spec.startswith("gen:"):
        parts = spec.split(":")
        kind = parts[1]
        if kind == "stencil":
            return stencil_csr(int(parts[2]), int(parts[3]), dtype=dtype)
        if kind == "rmat":
            return rmat_csr(int(parts[2]), int(parts[3]), dtype=dtype)
        if kind == "fem":
            return fem_block_csr(int(parts[2]), dof=int(parts[3]),
                                 dtype=dtype)
        if kind == "random":
            return random_csr(int(parts[2]), int(parts[3]), float(parts[4]),
                              dtype=dtype)
        raise SystemExit(f"unknown generator {kind}")
    return read_mtx(spec, dtype=dtype)


def cmd_spmv(args):
    import jax
    import jax.numpy as jnp

    from nsparse_jax.formats.bsr import BSR
    from nsparse_jax.formats.dia import DIA
    from nsparse_jax.formats.ell import ELL
    from nsparse_jax.ops.spmv import spmv
    from nsparse_jax.tune.autotune import autotune_spmv
    from nsparse_jax.tune.plan import Plan
    from nsparse_jax.utils.checking import (ans_check_device, spmv_abs_oracle,
                                            spmv_oracle)
    from nsparse_jax.utils.roofline import spmv_roofline_gflops
    from nsparse_jax.utils.timing import time_fn, gflops

    dtype = np.float32 if args.precision == "single" else np.float64
    a = _load(args.matrix, dtype)
    m, n = a.shape
    print(f"matrix: {args.matrix}  M={m} N={n} nnz={a.nnz}")

    x = jnp.asarray(np.random.default_rng(0).standard_normal(n), dtype=dtype)

    import time

    t0 = time.perf_counter()
    if args.format == "auto":
        fmt, plan = autotune_spmv(a, x, trials=args.tune_trials,
                                  measure=args.tune_mode == "measure",
                                  cache_dir=args.plan_cache)
    else:
        plan = Plan(format=args.format)
        if args.format == "ell":
            fmt = ELL.from_csr(a)
        elif args.format == "bsr":
            fmt = BSR.from_csr(a)
        elif args.format == "dia":
            fmt = DIA.from_csr(a)
        else:
            fmt = a
    conv_ms = (time.perf_counter() - t0) * 1e3
    print(f"conversion/tuning: {conv_ms:.1f} ms  format={plan.format}")

    f = jax.jit(lambda fmt, x: spmv(fmt, x))
    if args.profile:
        from nsparse_jax.utils.profiling import profile_op

        _, pms, tdir = profile_op(f, fmt, x, trace_dir=args.profile)
        print(f"trace written to {tdir} ({pms:.4f} ms/iter)")
    ms = time_fn(lambda: f(fmt, x), trials=args.trials, warmup=1)
    flops = 2.0 * a.nnz
    gf = gflops(flops, ms)
    padded = getattr(fmt, "padded_nnz", a.nnz)
    line = f"SpMV [{plan.format}]: {ms:.4f} ms  {gf:.2f} GFLOPS"
    spec = _device_spec()
    if spec is not None:
        roof = spmv_roofline_gflops(
            a.nnz, m, n, val_bytes=dtype().itemsize,
            idx_bytes=0 if plan.format == "dia" else 4,
            padded_nnz=padded, spec=spec,
        )
        line += f"  ({100 * gf / roof:.1f}% of {spec.name} roofline)"
    print(line)

    ok, nf = ans_check_device(
        f(fmt, x), spmv_oracle(a, x), dtype=dtype, scale=spmv_abs_oracle(a, x)
    )
    print("pass" if ok else f"FAIL ({nf} mismatches)")
    return 0 if ok else 1


def cmd_spmv_xla(args):
    """Vendor-baseline role: jax.experimental.sparse BCOO matvec."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import sparse as jsparse

    from nsparse_jax.utils.checking import ans_check, spmv_oracle
    from nsparse_jax.utils.timing import time_fn, gflops

    dtype = np.float32 if args.precision == "single" else np.float64
    a = _load(args.matrix, dtype)
    m, n = a.shape
    print(f"matrix: {args.matrix}  M={m} N={n} nnz={a.nnz}")
    s = a.to_scipy().tocoo()
    bcoo = jsparse.BCOO(
        (jnp.asarray(s.data), jnp.asarray(np.stack([s.row, s.col], 1))),
        shape=(m, n),
    )
    x = jnp.asarray(np.random.default_rng(0).standard_normal(n), dtype=dtype)
    f = jax.jit(lambda x: bcoo @ x)
    ms = time_fn(lambda: f(x), trials=args.trials, warmup=1)
    gf = gflops(2.0 * a.nnz, ms)
    print(f"SpMV [bcoo-xla]: {ms:.4f} ms  {gf:.2f} GFLOPS")
    ok, nf = ans_check(np.asarray(f(x)), spmv_oracle(a, x), dtype=dtype)
    print("pass" if ok else f"FAIL ({nf} mismatches)")
    return 0 if ok else 1


def cmd_spgemm(args):
    import jax

    from nsparse_jax.ops.spgemm import (spgemm_numeric, spgemm_plan,
                                        spgemm_plan_device)
    from nsparse_jax.ops.spgemm_bsr import (choose_spgemm_path,
                                            plan_spgemm_bsr, spgemm_bsr,
                                            spgemm_bsr_blocks)
    from nsparse_jax.utils.checking import (check_spgemm_answer,
                                            check_spgemm_answer_device,
                                            spgemm_abs_oracle, spgemm_oracle)
    from nsparse_jax.utils.roofline import spgemm_roofline_gflops
    from nsparse_jax.utils.timing import time_fn, gflops

    dtype = np.float32 if args.precision == "single" else np.float64
    a = _load(args.matrix, dtype)
    m, n = a.shape
    print(f"matrix: {args.matrix}  M={m} N={n} nnz={a.nnz}")

    import time

    method = args.method
    if method == "auto":
        method = choose_spgemm_path(a, a)
        print(f"method: {method} (auto)")

    if method == "bsr":
        t0 = time.perf_counter()
        plan = plan_spgemm_bsr(a, a)
        sym_ms = (time.perf_counter() - t0) * 1e3
        print(f"nnz(A): {a.nnz}  block pairs: {plan.n_pairs}  "
              f"fill: {plan.fill:.1f}x")
        print(f"symbolic (block plan): {sym_ms:.1f} ms")
        fblk = jax.jit(spgemm_bsr_blocks)
        ms = time_fn(lambda: fblk(plan), trials=args.trials, warmup=1)
        gf = gflops(plan.flops, ms)
        tile_tf = 2 * plan.n_pairs * plan.bs**3 / (ms * 1e-3) / 1e12
        print(f"SpGEMM bsr: {ms:.4f} ms  {gf:.2f} GFLOPS useful  "
              f"({tile_tf:.2f} TFLOPS of dense tile products)")
        c = spgemm_bsr(a, a, plan)
        ok = check_spgemm_answer(
            c, spgemm_oracle(a, a), abs_ref=spgemm_abs_oracle(a, a)
        )
        print("pass" if ok else "FAIL")
        return 0 if ok else 1

    planner = args.planner
    if planner == "auto":
        # one-shot default: symbolic on device (the reference's model —
        # binning + symbolic + numeric per call); a plan cache selects the
        # host planner, whose plans serialize
        planner = "host" if args.plan_cache else "device"
    t0 = time.perf_counter()
    if planner == "device":
        plan, hit = spgemm_plan_device(a, a), False
    elif args.plan_cache:
        from nsparse_jax.tune.spgemm_cache import spgemm_plan_cached

        plan, hit = spgemm_plan_cached(a, a, args.plan_cache)
    else:
        plan, hit = spgemm_plan(a, a), False
    sym_ms = (time.perf_counter() - t0) * 1e3
    # the compression funnel the reference prints (spgemm_hash.cu:64)
    print(f"nnz(A): {a.nnz}  intermediate products: {plan.n_products}  "
          f"nnz(C): {plan.c_nnz}")
    print(f"symbolic ({planner} plan): {sym_ms:.1f} ms"
          + ("  [cache hit]" if hit else ""))

    f = jax.jit(spgemm_numeric)
    ms = time_fn(lambda: f(plan, a, a), trials=args.trials, warmup=1)
    gf = gflops(plan.flops, ms)
    line = f"SpGEMM numeric: {ms:.4f} ms  {gf:.2f} GFLOPS"
    spec = _device_spec()
    if spec is not None:
        roof = spgemm_roofline_gflops(
            a.nnz, a.nnz, plan.c_nnz, plan.n_products,
            val_bytes=dtype().itemsize, spec=spec,
        )
        line += f"  ({100 * gf / roof:.1f}% of {spec.name} roofline)"
    print(line)

    c = f(plan, a, a)
    ok = check_spgemm_answer_device(
        c, spgemm_oracle(a, a), abs_ref=spgemm_abs_oracle(a, a)
    )
    print("pass" if ok else "FAIL")
    return 0 if ok else 1


def cmd_spgemm_xla(args):
    """Vendor-baseline role: jax.experimental.sparse BCOO @ BCOO."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import sparse as jsparse

    from nsparse_jax.ops.spgemm import spgemm_flops
    from nsparse_jax.utils.timing import time_fn, gflops

    dtype = np.float32 if args.precision == "single" else np.float64
    a = _load(args.matrix, dtype)
    m, n = a.shape
    print(f"matrix: {args.matrix}  M={m} N={n} nnz={a.nnz}")
    s = a.to_scipy().tocoo()
    bcoo = jsparse.BCOO(
        (jnp.asarray(s.data), jnp.asarray(np.stack([s.row, s.col], 1))),
        shape=(m, n),
    )
    flop = spgemm_flops(a, a)
    f = jax.jit(lambda l, r: (l @ r).data)
    try:
        ms = time_fn(lambda: f(bcoo, bcoo), trials=args.trials, warmup=1)
        print(f"SpGEMM [bcoo-xla]: {ms:.4f} ms  {gflops(flop, ms):.2f} GFLOPS")
    except Exception as e:  # BCOO spgemm support varies by backend
        print(f"SpGEMM [bcoo-xla]: unsupported on this backend ({e})")
        return 1
    return 0


def cmd_rap(args):
    """Distributed R @ A @ P demo over the devices present — BASELINE.md
    config 5's shape.  With ``JAX_PLATFORMS=cpu`` it runs on a virtual CPU
    mesh of ``--devices`` devices instead."""
    import os

    if os.environ.get("JAX_PLATFORMS") == "cpu":
        # must be set before the CPU backend initializes
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.devices}"
        )
    import jax
    import scipy.sparse as sp

    from nsparse_jax.formats.csr import CSR
    from nsparse_jax.io.generate import stencil_csr
    from nsparse_jax.parallel import (
        make_mesh, partition_rows, rap_halo, gather_partitioned,
    )
    from nsparse_jax.utils.checking import check_spgemm_answer

    d = len(jax.devices())
    mesh = make_mesh(d)
    n = args.n
    a = _load(args.matrix, np.float64) if args.matrix else stencil_csr(
        int(n ** 0.5), n // int(n ** 0.5)
    )
    n = a.shape[0]
    nc = n // 4
    agg = np.arange(n) // 4
    p_dense = sp.csr_matrix(
        (np.ones(n), (np.arange(n), agg)), shape=(n, nc)
    )
    p = CSR.from_scipy(p_dense)
    r = CSR.from_scipy(p_dense.T.tocsr())
    print(f"R({nc}x{n}) @ A({n}x{n}, nnz={a.nnz}) @ P({n}x{nc}) "
          f"over a {d}-device mesh")

    got = gather_partitioned(
        rap_halo(partition_rows(r, d), partition_rows(a, d),
                 partition_rows(p, d), mesh)
    )
    ref = (r.to_scipy() @ a.to_scipy() @ p.to_scipy()).tocsr()
    ref.sum_duplicates(); ref.sort_indices()
    sa = (abs(r.to_scipy()) @ abs(a.to_scipy()) @ abs(p.to_scipy())).tocsr()
    sa.sum_duplicates(); sa.sort_indices()
    ok = check_spgemm_answer(got, ref, abs_ref=sa)
    print(f"halo R.A.P: nnz(RAP)={got.nnz}  "
          f"{'pass' if ok else 'FAIL'} (all comm = neighbor ppermutes)")
    return 0 if ok else 1


def _device_spec():
    """Published peaks of the device, or None off the GPU: a roofline share
    of a CPU run is not a device metric."""
    import jax

    from nsparse_jax.utils.roofline import chip_specs

    if jax.devices()[0].platform != "gpu":
        return None
    return chip_specs()


def main(argv=None):
    from nsparse_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    ap = argparse.ArgumentParser(prog="nsparse_jax")
    ap.add_argument("--precision", choices=["single", "double"],
                    default="double")
    sub = ap.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("spmv")
    sp.add_argument("matrix")
    sp.add_argument("--format", choices=["auto", "dia", "ell", "bsr", "csr"],
                    default="auto")
    sp.add_argument("--trials", type=int, default=101)
    sp.add_argument("--tune-trials", type=int, default=5)
    sp.add_argument("--plan-cache", default=None)
    sp.add_argument("--tune-mode", choices=["model", "measure"],
                    default="model",
                    help="tuning objective: modeled HBM footprint (fast; "
                         "the reference's non-AT mode) or measured time "
                         "per candidate (the reference's AT mode; compiles "
                         "every candidate)")
    sp.add_argument("--profile", default=None, metavar="TRACE_DIR",
                    help="write a jax.profiler trace of the kernel")
    sp.set_defaults(fn=cmd_spmv)

    sx = sub.add_parser("spmv-xla")
    sx.add_argument("matrix")
    sx.add_argument("--trials", type=int, default=101)
    sx.set_defaults(fn=cmd_spmv_xla)

    sg = sub.add_parser("spgemm")
    sg.add_argument("matrix")
    sg.add_argument("--trials", type=int, default=11)
    sg.add_argument("--planner", default="auto",
                    choices=("auto", "host", "device"),
                    help="symbolic phase: device = one-shot on the "
                         "accelerator (default without a cache); host = "
                         "native host planner")
    sg.add_argument("--plan-cache", default=None, metavar="DIR",
                    help="directory for serialized SpGEMM plans (symbolic "
                         "phase cached per sparsity fingerprint)")
    sg.add_argument("--method", choices=["auto", "esc", "bsr"],
                    default="auto")
    sg.set_defaults(fn=cmd_spgemm)

    sgx = sub.add_parser("spgemm-xla")
    sgx.add_argument("matrix")
    sgx.add_argument("--trials", type=int, default=11)
    sgx.set_defaults(fn=cmd_spgemm_xla)

    sr = sub.add_parser("rap", help="distributed R.A.P demo over a mesh")
    sr.add_argument("matrix", nargs="?", default=None)
    sr.add_argument("--devices", type=int, default=8,
                    help="virtual CPU mesh size under JAX_PLATFORMS=cpu")
    sr.add_argument("--n", type=int, default=1024)
    sr.set_defaults(fn=cmd_rap)

    args = ap.parse_args(argv)
    if args.precision == "double":
        import jax

        jax.config.update("jax_enable_x64", True)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
