"""Serializable tuning plans.

Analog of the reference's ``sfPlan`` / ``Plan<idType>`` (``nsparse.h:50-59``,
``Plan.hpp:4-40``) — the record of an auto-tuner decision — extended with
what the reference leaves implicit: JSON persistence keyed by (matrix
fingerprint, chip), so tuning cost is paid once per matrix/chip pair
(the reference re-tunes every run unless seg/block are passed on argv,
``spmv_amb.cu:97-99``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Plan:
    """SpMV format/tuning decision.

    format: "dia", "ell", "bsr", or "csr".
    min_width / max_slabs: ELL width-binning params (AMB seg/block analog).
    blocksize: BSR tile shape.
    measured_ms: tuner's best time (the ``min_msec`` analog, Plan.hpp).
    memory_bytes: modeled footprint (the non-AT objective, convert_amb.cu:785).
    """

    format: str = "ell"
    min_width: int = 8
    max_slabs: int = 8
    sigma: Optional[int] = None
    blocksize: tuple = (8, 128)
    isPlan: bool = False  # parity with sfPlan.isPlan (nsparse.h:52)
    measured_ms: float = float("inf")
    memory_bytes: int = 0
    chip: str = ""
    matrix_key: str = ""

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["blocksize"] = list(d["blocksize"])
        return json.dumps(d, indent=1)

    @classmethod
    def from_json(cls, s: str) -> "Plan":
        d = json.loads(s)
        d["blocksize"] = tuple(d.get("blocksize", (8, 128)))
        return cls(**d)

    def save(self, directory: str) -> str:
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, f"{self.matrix_key}_{self.chip}.json")
        with open(path, "w") as f:
            f.write(self.to_json())
        return path

    @classmethod
    def load(cls, directory: str, matrix_key: str, chip: str) -> Optional["Plan"]:
        path = os.path.join(directory, f"{matrix_key}_{chip}.json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return cls.from_json(f.read())


def matrix_fingerprint(a) -> str:
    """Stable short key for a CSR matrix (shape, nnz, structure hash).

    Hashes the FULL rpt/col arrays: sampled hashing collided on matrices
    differing only between sample strides, silently returning stale cached
    SpGEMM plans.  sha1 over a few MB is negligible next to the symbolic
    phase it keys."""
    h = hashlib.sha1()
    h.update(str(a.shape).encode())
    h.update(str(a.nnz).encode())
    h.update(np.ascontiguousarray(np.asarray(a.rpt)).tobytes())
    h.update(np.ascontiguousarray(np.asarray(a.col)).tobytes())
    return h.hexdigest()[:16]
