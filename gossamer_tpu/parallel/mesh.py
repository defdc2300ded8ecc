"""Device mesh helpers for multi-chip execution."""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def accelerator_present() -> bool:
    """True when JAX's default backend is the GPU this system targets.

    The one place that asks which platform runs: every choice that
    depends on having an accelerator reads this predicate."""
    return jax.devices()[0].platform == "gpu"


def auto_num_devices() -> int:
    """What ``--num-devices 0`` means: every visible GPU on a GPU host,
    one device on the CPU backend (virtual CPU meshes opt in with an
    explicit count)."""
    return len(jax.devices()) if accelerator_present() else 1


def data_mesh(n_devices: int | None = None) -> Mesh:
    """1-D mesh over the first n devices (axis "d")."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), ("d",))
