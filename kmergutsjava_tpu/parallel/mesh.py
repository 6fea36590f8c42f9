"""Device mesh construction for the annotation engine.

Two mesh axes (the reference has no parallelism at all — SURVEY.md §2.2 —
so this is new design):

- ``data``: reads/contigs/query k-mers are sharded along this axis
  (data parallelism over the input stream);
- ``table``: signature-table slot ranges are sharded along this axis
  (model parallelism analog for tables too big to replicate in HBM).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh

DATA_AXIS = "data"
TABLE_AXIS = "table"


def make_mesh(data: int, table: int = 1, devices: Optional[Sequence] = None) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    need = data * table
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    arr = np.array(devices[:need]).reshape(data, table)
    return Mesh(arr, (DATA_AXIS, TABLE_AXIS))


def default_mesh_shape(n_devices: int) -> Tuple[int, int]:
    """Prefer a 2-way table shard when the device count allows it."""
    if n_devices % 2 == 0 and n_devices >= 2:
        return n_devices // 2, 2
    return n_devices, 1
