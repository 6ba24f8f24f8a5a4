"""Native (C++) runtime components, loaded via ctypes.

The reference's host runtime is C/CUDA host code (file parsing, format
conversion bookkeeping).  This library keeps the device path in JAX/XLA and
puts the genuinely host-bound work — Matrix Market parsing (``mmio.cpp``)
and the SpGEMM symbolic planner (``planner.cpp``) — in C++, built on demand
into ``libnsparse_native.so`` and loaded through ctypes.  Everything has a
NumPy fallback so the library works without a compiler.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_LIB_PATH = os.path.join(_HERE, "libnsparse_native.so")
_lock = threading.Lock()
_lib = None
_build_failed = False


_SOURCES = ("mmio.cpp", "planner.cpp")


def _build() -> bool:
    srcs = [os.path.join(_HERE, s) for s in _SOURCES]
    if not all(os.path.exists(s) for s in srcs):
        return False
    cmd = [
        "g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
        "-pthread", "-o", _LIB_PATH, *srcs,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        return True
    except Exception:
        return False


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _lib, _build_failed
    if _lib is not None:
        return _lib
    if _build_failed or os.environ.get("NSPARSE_NO_NATIVE"):
        return None
    with _lock:
        if _lib is not None:
            return _lib
        stale = not os.path.exists(_LIB_PATH) or any(
            os.path.exists(os.path.join(_HERE, s))
            and os.path.getmtime(os.path.join(_HERE, s))
            > os.path.getmtime(_LIB_PATH)
            for s in _SOURCES
        )
        if stale:
            if not _build():
                _build_failed = True
                return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            _build_failed = True
            return None
        lib.nsp_read_mtx.restype = ctypes.c_int64
        lib.nsp_read_mtx.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64),  # m
            ctypes.POINTER(ctypes.c_int64),  # n
            ctypes.POINTER(ctypes.c_int64),  # nnz out (after symmetrize)
        ]
        lib.nsp_fill_mtx.restype = ctypes.c_int
        lib.nsp_fill_mtx.argtypes = [
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        ]
        lib.nsp_free_mtx.restype = None
        lib.nsp_free_mtx.argtypes = []
        _i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        _i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        lib.nsp_spgemm_plan.restype = ctypes.c_int64
        lib.nsp_spgemm_plan.argtypes = [
            _i32, _i32, ctypes.c_int64,  # rpt_a, col_a, m
            _i32, _i32,                  # rpt_b, col_b
            _i32, _i32, _i32,            # apos, bpos, out_pos
            _i32, _i32, _i64,            # c_rpt, c_col, prodoff scratch
            ctypes.c_int64,              # P
        ]
        _lib = lib
        return _lib


def spgemm_plan_host(rpt_a, col_a, deg_a, rpt_b, col_b, deg_b, m, n, nnz_a):
    """Host SpGEMM symbolic phase: expansion + per-row column sort + dedup.

    Returns (apos, bpos, out_pos, c_rpt, c_col, p_total, c_nnz) with the
    first five as int32 numpy arrays sized exactly (no padding; the caller
    pads for the device).  Dispatches to the C++ planner when available,
    else a vectorized numpy fallback.
    """
    rpt_a = np.ascontiguousarray(rpt_a, dtype=np.int32)
    rpt_b = np.ascontiguousarray(rpt_b, dtype=np.int32)
    col_a32 = np.ascontiguousarray(col_a[:nnz_a], dtype=np.int32)
    col_b32 = np.ascontiguousarray(col_b, dtype=np.int32)

    cnt = deg_b[col_a32]  # products per A-entry (int64)
    p_total = int(cnt.sum())

    lib = get_lib()
    if lib is not None:
        apos = np.empty(max(p_total, 1), dtype=np.int32)
        bpos = np.empty(max(p_total, 1), dtype=np.int32)
        out_pos = np.empty(max(p_total, 1), dtype=np.int32)
        c_rpt = np.empty(m + 1, dtype=np.int32)
        c_col = np.empty(max(p_total, 1), dtype=np.int32)
        prodoff = np.empty(m + 1, dtype=np.int64)
        c_nnz = lib.nsp_spgemm_plan(
            rpt_a, col_a32, m, rpt_b, col_b32,
            apos, bpos, out_pos, c_rpt, c_col, prodoff, p_total,
        )
        if c_nnz >= 0:
            return (
                apos[:p_total], bpos[:p_total], out_pos[:p_total],
                c_rpt, c_col[:c_nnz], p_total, int(c_nnz),
            )
        # fall through to numpy on planner error

    # numpy fallback: global stable argsort on a packed (row, col) key
    off = np.zeros(nnz_a + 1, dtype=np.int64)
    np.cumsum(cnt, out=off[1:])
    k = np.repeat(np.arange(nnz_a, dtype=np.int64), cnt)
    t_in = np.arange(p_total, dtype=np.int64) - off[k]
    row = np.repeat(
        np.repeat(np.arange(m, dtype=np.int64), deg_a[:m]), cnt
    )
    bpos = rpt_b[col_a32[k]].astype(np.int64) + t_in
    ccol = col_b32[bpos].astype(np.int64)
    key = row * int(n) + ccol
    order = np.argsort(key, kind="stable")
    ks = key[order]
    if p_total:
        new = np.empty(p_total, dtype=bool)
        new[0] = True
        np.not_equal(ks[1:], ks[:-1], out=new[1:])
    else:
        new = np.zeros(0, dtype=bool)
    out_pos = (np.cumsum(new) - 1).astype(np.int32)
    c_nnz = int(out_pos[-1]) + 1 if p_total else 0
    c_col = ccol[order][new].astype(np.int32)
    row_b = row[order][new]
    c_counts = np.bincount(row_b, minlength=m)
    c_rpt = np.zeros(m + 1, dtype=np.int32)
    np.cumsum(c_counts, out=c_rpt[1:])
    return (
        k[order].astype(np.int32), bpos[order].astype(np.int32), out_pos,
        c_rpt, c_col, p_total, c_nnz,
    )


def try_native_read_mtx(path: str):
    """Fast C++ .mtx parse; returns (rows, cols, vals, (m, n)) or None."""
    lib = get_lib()
    if lib is None:
        return None
    m = ctypes.c_int64()
    n = ctypes.c_int64()
    nnz = ctypes.c_int64()
    rc = lib.nsp_read_mtx(path.encode(), ctypes.byref(m), ctypes.byref(n), ctypes.byref(nnz))
    if rc < 0:
        return None
    rows = np.empty(nnz.value, dtype=np.int64)
    cols = np.empty(nnz.value, dtype=np.int64)
    vals = np.empty(nnz.value, dtype=np.float64)
    if nnz.value:
        lib.nsp_fill_mtx(rows, cols, vals)
    lib.nsp_free_mtx()
    return rows, cols, vals, (m.value, n.value)
