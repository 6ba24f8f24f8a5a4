"""SpGEMM plan serialization + on-disk cache.

The symbolic phase is one-time precompute per sparsity pattern (the
reference's amortization model: ``SpGEMM_Hash_Numeric`` re-runs the numeric
phase against a saved structure, ``HashSpGEMM.hpp:1014-1027``, and tuned
kernels are committed as build artifacts).  This module makes that
amortization cross-process: a ``SpgemmPlan`` round-trips through one
``.npz`` file keyed by (A fingerprint, B fingerprint, plan version).

Encoding: a small recursive scheme over the plan's value kinds (arrays,
static scalars/tuples, registered dataclasses, None); array leaves live
as npz entries, everything else in one JSON metadata entry.  Loading
reconstructs the exact pytree with ``jnp.asarray`` leaves.  ``save`` pulls
every device-resident array back to the host once.
"""

from __future__ import annotations

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np

from nsparse_jax.tune.plan import matrix_fingerprint

# bump when SpgemmPlan or any nested plan changes incompatibly
PLAN_VERSION = 11  # v11: plain gather + segment-sum plan


def _registry():
    from nsparse_jax.ops.spgemm import SpgemmPlan

    return {SpgemmPlan.__name__: SpgemmPlan}


def _encode(obj, name: str, arrays: dict):
    if obj is None:
        return {"k": "none"}
    if isinstance(obj, (bool, int, float, str)):
        return {"k": "val", "v": obj}
    if isinstance(obj, (tuple, list)):
        return {
            "k": "tup",
            "items": [
                _encode(o, f"{name}.{i}", arrays) for i, o in enumerate(obj)
            ],
        }
    if dataclasses.is_dataclass(obj):
        cls = type(obj).__name__
        if cls not in _registry():
            raise TypeError(f"unregistered plan dataclass {cls}")
        return {
            "k": "dc",
            "c": cls,
            "f": {
                f.name: _encode(getattr(obj, f.name), f"{name}.{f.name}",
                                arrays)
                for f in dataclasses.fields(obj)
            },
        }
    arr = np.asarray(obj)  # device arrays: one D->H pull
    arrays[name] = arr
    return {"k": "arr", "id": name}


def _decode(meta, arrays: dict):
    k = meta["k"]
    if k == "none":
        return None
    if k == "val":
        return meta["v"]
    if k == "tup":
        return tuple(_decode(m, arrays) for m in meta["items"])
    if k == "dc":
        cls = _registry()[meta["c"]]
        return cls(**{n: _decode(m, arrays) for n, m in meta["f"].items()})
    if k == "arr":
        return jnp.asarray(arrays[meta["id"]])
    raise ValueError(f"bad plan encoding kind {k!r}")


def save_spgemm_plan(plan, path: str) -> str:
    """Serialize a SpgemmPlan (and nested routed plans) to one .npz."""
    arrays: dict = {}
    meta = _encode(plan, "p", arrays)
    arrays["__meta__"] = np.frombuffer(
        json.dumps({"version": PLAN_VERSION, "tree": meta}).encode(),
        dtype=np.uint8,
    )
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)
    return path


def load_spgemm_plan(path: str):
    """Load a plan saved by ``save_spgemm_plan``; None when missing or from
    an incompatible version."""
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(bytes(arrays.pop("__meta__")).decode())
    if meta.get("version") != PLAN_VERSION:
        return None
    return _decode(meta["tree"], arrays)


def plan_cache_path(directory: str, a, b) -> str:
    key = f"{matrix_fingerprint(a)}_{matrix_fingerprint(b)}"
    return os.path.join(directory, f"spgemm_{key}_v{PLAN_VERSION}.npz")


def spgemm_plan_cached(a, b, directory: str):
    """``spgemm_plan`` with an on-disk cache keyed by the two sparsity
    fingerprints.  Returns (plan, hit)."""
    from nsparse_jax.ops.spgemm import spgemm_plan

    path = plan_cache_path(directory, a, b)
    plan = load_spgemm_plan(path)
    if plan is not None:
        return plan, True
    plan = spgemm_plan(a, b)
    save_spgemm_plan(plan, path)
    return plan, False
