"""SpMV auto-tuner.

Analog of ``sf_csr2amb`` / ``AMB::convert_from_csr``'s search
(``convert_amb.cu:556-600, 758-800, 835-929``): build candidate formats,
time the actual kernel on each (the ``#define AT`` measured-time objective),
keep the fastest, optionally fall back to the modeled-footprint objective
when timing is disabled (the ``#else`` branch, ``convert_amb.cu:785-798``).

Where the reference searches seg_size x block_size(1..20) x launch geometry,
the search space here is format (DIA vs ELL slabs vs BSR tiles vs raw CSR) x
the ELL width-binning knobs x BSR tile shape — the knobs XLA's compiled code
responds to.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from nsparse_jax.formats.bsr import BSR
from nsparse_jax.formats.csr import CSR
from nsparse_jax.formats.ell import ELL
from nsparse_jax.ops.spmv import spmv
from nsparse_jax.tune.plan import Plan, matrix_fingerprint
from nsparse_jax.utils.timing import time_fn


def build_format(a: CSR, plan: Plan):
    """The format object ``plan`` describes, converted from ``a``."""
    if plan.format == "ell":
        return ELL.from_csr(a, min_width=plan.min_width,
                            max_slabs=plan.max_slabs, sigma=plan.sigma)
    if plan.format == "bsr":
        return BSR.from_csr(a, blocksize=plan.blocksize)
    if plan.format == "dia":
        from nsparse_jax.formats.dia import DIA

        return DIA.from_csr(a)
    return a


def _footprint(fmt) -> int:
    """Modeled HBM bytes per SpMV (non-AT objective)."""
    leaves = jax.tree_util.tree_leaves(fmt)
    return int(sum(l.size * l.dtype.itemsize for l in leaves))


# Per-sweep audit trail: one entry per candidate with its fate
# ("measured" + ms, or the drop stage).  Reset on each autotune_spmv call;
# bench.py publishes it so a dropped candidate is distinguishable from a
# measured loss.
SWEEP: list = []


def _cand_repr(plan: Plan) -> str:
    bits = [plan.format]
    if plan.format == "ell":
        bits.append(f"w{plan.min_width}x{plan.max_slabs}")
        if plan.sigma is not None:
            bits.append(f"s{plan.sigma}")
    return "-".join(bits)


def _log_drop(plan: Plan, stage: str, why) -> None:
    """A candidate silently vanishing from the search hides real breakage
    (a broken format class looks like 'the tuner chose CSR'); say why."""
    import sys

    SWEEP.append({"cand": _cand_repr(plan), "fate": stage})
    print(
        f"[autotune] dropped candidate {plan.format}"
        f"({plan.knobs_repr() if hasattr(plan, 'knobs_repr') else ''}) "
        f"at {stage}: {why}",
        file=sys.stderr,
    )


def default_candidates(a: CSR) -> Iterable[Plan]:
    cands = [
        Plan(format="dia"),  # build_format raises for non-diagonal matrices
        Plan(format="csr"),
        # ELL knob sweep: sigma (sort window: 0 keeps banded structure,
        # larger windows balance skewed rows) x width binning — the analog
        # of the reference's seg_size x block_size(1..20) sweep
        # (convert_amb.cu:556-600,878-916)
        Plan(format="ell", min_width=8, max_slabs=8, sigma=1024),
        Plan(format="ell", min_width=8, max_slabs=8, sigma=0),  # keep order
        Plan(format="ell", min_width=8, max_slabs=8, sigma=256),
        Plan(format="ell", min_width=8, max_slabs=8, sigma=None),  # global
        Plan(format="ell", min_width=16, max_slabs=6),
        Plan(format="ell", min_width=8, max_slabs=4),
        Plan(format="ell", min_width=32, max_slabs=8, sigma=1024),
    ]
    # BSR only pays when block fill-in is sane; probe mean degree first.
    m, n = a.shape
    if a.nnz / max(m, 1) >= 4:  # skip for ultra-sparse rows
        for bs in ((8, 128), (8, 256), (128, 128)):
            cands.append(Plan(format="bsr", blocksize=bs))
    return cands


def _rank_chained(fmt, x, iters: int = 6):
    """Marginal per-op ms of a chained SpMV loop, ONE compile.

    The iteration count rides as a traced argument (fori_loop lowers to
    a while), so the same compiled program runs at two counts and the
    per-op cost is the blocked-time difference — the sync offset that
    made r4's sweep audit report whole-trial times as candidate "ms"
    cancels.  Returns (per_op_ms, total_ms_at_hi, hi)."""
    import time as _time

    # fmt rides as an argument: closure arrays would inline as literal
    # constants into the compiled program
    loop = jax.jit(
        lambda c, f, n: jax.lax.fori_loop(
            0, n,
            lambda i, cc: jax.lax.optimization_barrier(
                spmv(f, cc) * 0.124
            ),
            c,
        )
    )
    lo, hi = 2, max(iters, 8)
    c = jax.block_until_ready(loop(x, fmt, hi))  # compile + warm
    t_lo = t_hi = float("inf")
    for _ in range(2):
        t0 = _time.perf_counter()
        c = jax.block_until_ready(loop(c, fmt, hi))
        t_hi = min(t_hi, _time.perf_counter() - t0)
        t0 = _time.perf_counter()
        c = jax.block_until_ready(loop(c, fmt, lo))
        t_lo = min(t_lo, _time.perf_counter() - t0)
    per_op = max(t_hi - t_lo, 0.0) / (hi - lo) * 1e3
    return per_op, t_hi * 1e3, hi


def autotune_spmv(
    a: CSR,
    x: Optional[jax.Array] = None,
    candidates: Optional[Sequence[Plan]] = None,
    measure: bool = True,
    trials: int = 5,
    max_bytes_ratio: Optional[float] = None,
    cache_dir: Optional[str] = None,
):
    """Pick the fastest SpMV format for ``a``.

    Returns (format_object, Plan).  ``measure=False`` uses the modeled
    footprint objective only (the reference's non-AT mode).
    ``max_bytes_ratio`` prunes candidates whose storage exceeds that multiple
    of CSR's (protects against pathological BSR fill-in before timing).
    When not given it defaults per mode: 8x in model mode (the footprint IS
    the objective there) and a loose 128x guard in measured mode, where
    time decides.  An explicitly-passed cap is honored as-is in BOTH modes.
    """
    chip = jax.devices()[0].device_kind.replace(" ", "_")
    key = matrix_fingerprint(a)
    if cache_dir:
        cached = Plan.load(cache_dir, key, chip)
        if cached is not None:
            return build_format(a, cached), cached

    if x is None:
        x = jnp.asarray(np.random.default_rng(0).standard_normal(a.shape[1]),
                        dtype=a.dtype)
    csr_bytes = _footprint(a)
    SWEEP.clear()

    cap = max_bytes_ratio if max_bytes_ratio is not None else (
        128.0 if measure else 8.0
    )
    best_fmt, best_plan, best_score = None, None, float("inf")
    for plan in (candidates or default_candidates(a)):
        try:
            fmt = build_format(a, plan)
        except Exception as e:
            _log_drop(plan, "build", e)
            continue
        fb = _footprint(fmt)
        if fb > cap * csr_bytes:
            _log_drop(plan, "footprint",
                      f"{fb} > {cap:g}x csr ({csr_bytes})")
            continue
        plan = dataclasses.replace(plan, memory_bytes=fb, chip=chip,
                                   matrix_key=key, isPlan=True)
        if measure:
            try:
                m, n = a.shape
                if m == n:
                    # marginal per-op ranking, one compile per candidate
                    ms, total_ms, k_hi = _rank_chained(
                        fmt, x, iters=max(trials, 16)
                    )
                    sweep_extra = {
                        "total_ms": round(total_ms, 4), "iters": k_hi
                    }
                else:
                    f = jax.jit(lambda fmt, x: spmv(fmt, x))
                    ms = time_fn(lambda: f(fmt, x), trials=trials, warmup=1)
                    sweep_extra = {}
            except Exception as e:
                _log_drop(plan, "measure", e)
                continue
            plan = dataclasses.replace(plan, measured_ms=ms)
            SWEEP.append(
                {"cand": _cand_repr(plan), "fate": "measured",
                 "ms_per_op": round(ms, 4), **sweep_extra}
            )
            score = ms
        else:
            score = float(fb)
        if score < best_score:
            best_fmt, best_plan, best_score = fmt, plan, score

    if best_plan is None:  # everything failed -> raw CSR
        best_fmt, best_plan = a, Plan(format="csr", chip=chip, matrix_key=key,
                                      isPlan=True)
    if cache_dir:
        best_plan.save(cache_dir)
    return best_fmt, best_plan
