"""Device mesh helpers.

The reference has no distributed layer (SURVEY.md section 2.4); this is the
new scale axis: a 1-D (or user-shaped) ``jax.sharding.Mesh`` whose
collectives XLA hands to NCCL.  The cards of one host are joined all to
all by NVLink, so a 1-D mesh loses nothing.  Works identically on a
virtual CPU mesh (``--xla_force_host_platform_device_count``) for tests.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(
    n_devices: Optional[int] = None,
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = ("x",),
) -> Mesh:
    devs = jax.devices()
    if n_devices is None:
        n_devices = int(np.prod(shape)) if shape else len(devs)
    if n_devices > len(devs):
        raise ValueError(f"need {n_devices} devices, have {len(devs)}")
    if shape is None:
        shape = (n_devices,)
    arr = np.array(devs[:n_devices]).reshape(shape)
    return Mesh(arr, axis_names=tuple(axis_names[: len(shape)]))
