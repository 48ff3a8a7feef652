"""Device mesh + table sharding utilities.

The device-side replacement for the reference's PartitionScheme + NUMAPlacementScheme +
Shiftboss topology (catalog/PartitionScheme.hpp:53, NUMAPlacementScheme.hpp:61,
query_execution/ForemanDistributed.cpp): a 1-D `jax.sharding.Mesh` over chips; big
tables are row-sharded (hash/random partitioning becomes contiguous row sharding since
our operators are partition-oblivious until a key-shuffle is required), small tables
are replicated (the broadcast-join layout).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: Optional[int] = None, axis: str = "x") -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.asarray(devs[:n]), (axis,))


def shard_rows(mesh: Mesh, arr, axis: str = "x"):
    """Place a 1-D column array row-sharded over the mesh (pads must already make
    len divisible by mesh size)."""
    return jax.device_put(arr, NamedSharding(mesh, P(axis)))


def replicate(mesh: Mesh, arr):
    return jax.device_put(arr, NamedSharding(mesh, P()))


def pad_to_multiple(arr: np.ndarray, m: int) -> np.ndarray:
    n = arr.shape[0]
    target = ((n + m - 1) // m) * m
    if target == n:
        return arr
    return np.pad(arr, [(0, target - n)] + [(0, 0)] * (arr.ndim - 1))
