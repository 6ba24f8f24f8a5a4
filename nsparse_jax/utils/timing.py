"""Benchmark timing harness.

Analog of the reference's cudaEvent timing loops (``spmv_amb.cu:46-58``,
``spgemm_hash.cu:40-49``): run ``trials`` iterations, discard ``warmup``,
report average milliseconds.  ``block_until_ready`` plays the role of
``cudaDeviceSynchronize``.  Matches the reference's trial counts by default
(TRI_NUM=101 with 1 warmup for SpMV; SPGEMM_TRI_NUM=11, ``nsparse.h:22-26``)
— callers pass smaller counts for quick runs.
"""

from __future__ import annotations

import time
from typing import Callable

import jax

SPMV_TRIALS = 101      # reference TRI_NUM (nsparse.h:22)
SPGEMM_TRIALS = 11     # reference SPGEMM_TRI_NUM (nsparse.h:26)


def time_fn(fn: Callable[[], object], trials: int = 10, warmup: int = 1) -> float:
    """Average wall ms per call over ``trials - warmup`` timed runs."""
    for _ in range(warmup):
        jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(trials - warmup):
        out = fn()
    jax.block_until_ready(out)
    t1 = time.perf_counter()
    return (t1 - t0) * 1e3 / max(trials - warmup, 1)


def gflops(flops: float, ms: float) -> float:
    return flops / (max(ms, 1e-6) * 1e-3) / 1e9


def time_marginal(
    step, init, iters_lo: int = 2, iters_hi: int = 10, reps: int = 3,
    aux=None,
) -> float:
    """Device ms per iteration of ``carry = step(carry, i)``.

    Runs the step chained in a jitted ``fori_loop`` at two iteration
    counts and reports ``(T_hi - T_lo) / (iters_hi - iters_lo)`` — the
    marginal cost of one more iteration, which cancels the per-dispatch
    latency and the ``block_until_ready`` round-trip.  The carry must
    feed the next iteration so XLA cannot hoist work out of the loop;
    an ``optimization_barrier`` stops cross-iteration fusion.

    Role analog: the reference times kernels with cudaEvent around an
    N-trial loop (``spgemm_hash.cu:40-49``).

    Large structures the step reads (plans, formats) go through ``aux``,
    not a Python closure: closed-over device arrays are inlined as literal
    constants at lowering.  With ``aux``, the step is called as
    ``step(c, i, aux)``.
    """

    def run(iters):
        if aux is None:
            def body(i, c):
                return jax.lax.optimization_barrier(step(c, i))

            loop = jax.jit(
                lambda c, n_=iters: jax.lax.fori_loop(0, n_, body, c)
            )
            args = lambda c: (c,)
        else:
            def body_a(a):
                def b(i, c):
                    return jax.lax.optimization_barrier(step(c, i, a))

                return b

            loop = jax.jit(
                lambda c, a, n_=iters: jax.lax.fori_loop(
                    0, n_, body_a(a), c
                )
            )
            args = lambda c: (c, aux)
        c = jax.block_until_ready(loop(*args(init)))  # compile + warm
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            c = jax.block_until_ready(loop(*args(c)))
            best = min(best, time.perf_counter() - t0)
        return best

    t_lo = run(iters_lo)
    t_hi = run(iters_hi)
    return max((t_hi - t_lo), 0.0) * 1e3 / (iters_hi - iters_lo)
