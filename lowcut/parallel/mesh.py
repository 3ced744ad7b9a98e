"""Device mesh construction.

The reference's only parallel resource is a host thread pool
(reference ProcessFile.cp:60-83). The device equivalent is a
`jax.sharding.Mesh` over the visible GPUs with two logical axes
(SURVEY.md §2.3, §5 "distributed communication backend"):

- ``"data"``: file/channel parallelism (batch mode, BASELINE config 4)
- ``"time"``: sequence parallelism over the sample axis with halo
  exchange (BASELINE config 5)

Single-chip runs use a trivial 1x1 mesh and compile to the same program.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh

DATA_AXIS = "data"
TIME_AXIS = "time"


def make_mesh(shape: tuple[int, int] | None = None, devices=None) -> Mesh:
    """Build a ("data", "time") mesh.

    ``shape=None`` puts all devices on the time axis (the dominant need for
    single large files); batch mode passes an explicit (data, time) shape.
    """
    devices = list(devices if devices is not None else jax.devices())
    if shape is None:
        shape = (1, len(devices))
    d, t = shape
    if d * t > len(devices):
        raise ValueError(f"mesh shape {shape} needs {d * t} devices, "
                         f"have {len(devices)}")
    arr = np.asarray(devices[: d * t]).reshape(d, t)
    return Mesh(arr, (DATA_AXIS, TIME_AXIS))


def single_device_mesh() -> Mesh:
    return make_mesh((1, 1))
