"""Multi-host (multi-process) execution: the Conductor/Executor analog.

The reference's distributed mode runs one Conductor (parse/optimize/route) and N
Executor processes (Shiftboss + Workers + block exchange), coordinating over TMB/
gRPC and pulling blocks peer-to-peer (cli/distributed/Conductor.hpp:47,
Executor.hpp:46; query_execution/ForemanDistributed.cpp:362-427;
storage/DataExchange.proto:22). The replacement here is SPMD at the process
level, matching how multi-host JAX programs run:

- every host process runs the SAME driver (parse -> optimize -> jit): the query
  plan is deterministic, so compiling it on each host replaces shipping
  WorkOrder protos (the QueryContext/CatalogDatabaseCache analog is that every
  process loads the same catalog);
- the device mesh spans all processes' chips; base tables are row-sharded
  across the GLOBAL mesh, each process materializing only its local rows
  (block-locality analog: data lives where it is scanned);
- cross-host data movement is XLA collectives inserted by the GSPMD
  partitioner (NVLink within a host, the network across hosts), replacing
  DataExchangerAsync block pulls;
- query results are replicated (an all-gather at the program tail), so every
  process can print/serve them — process 0 is the conventional "conductor"
  (it owns the REPL / network CLI).

Bootstrap: call `bootstrap(coordinator, num_processes, process_id)` before
creating the Database, or rely on env vars (QSTPU_COORDINATOR, QSTPU_NUM_PROCS,
QSTPU_PROC_ID). Nothing is auto-detected on a plain GPU host: give all three.
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np


def bootstrap(coordinator_address: Optional[str] = None,
              num_processes: Optional[int] = None,
              process_id: Optional[int] = None,
              local_device_count: Optional[int] = None) -> None:
    """Initialize jax.distributed from args or QSTPU_* env vars. Safe to call
    once per process, before any other JAX API touches devices."""
    coordinator_address = coordinator_address or os.environ.get(
        "QSTPU_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("QSTPU_NUM_PROCS", "0")) or None
    if process_id is None:
        pid = os.environ.get("QSTPU_PROC_ID")
        process_id = int(pid) if pid is not None else None
    local_ids = None if local_device_count is None \
        else list(range(local_device_count))
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id,
                               local_device_ids=local_ids)


def is_multiprocess() -> bool:
    return jax.process_count() > 1


def process_index() -> int:
    return jax.process_index()


def is_conductor() -> bool:
    """Process 0 owns user-facing IO (REPL, network CLI, result printing)."""
    return jax.process_index() == 0


def make_global_array(arr: np.ndarray, sharding):
    """Build a global jax.Array from a host copy of the FULL array, where this
    process materializes (transfers) only the rows its local devices own —
    the block-locality analog: every host has the table definition, but only
    local shards hit local HBM."""
    return jax.make_array_from_callback(arr.shape, sharding,
                                        lambda idx: arr[idx])


def all_gather_to_host(tree):
    """Fetch possibly cross-process-sharded arrays to every host: jit an
    identity with replicated out_shardings (an all-gather across
    processes), then device_get the fully-replicated result."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    leaves = jax.tree_util.tree_leaves(tree)
    if not leaves:
        return jax.device_get(tree)
    mesh = None
    for leaf in leaves:
        s = getattr(leaf, "sharding", None)
        if s is not None and getattr(s, "mesh", None) is not None:
            mesh = s.mesh
            break
    if mesh is None:
        return jax.device_get(tree)
    rep = NamedSharding(mesh, P())
    gathered = jax.jit(lambda x: x, out_shardings=rep)(tree)
    return jax.device_get(gathered)


def barrier(name: str = "qstpu") -> None:
    """Cross-process sync point (DDL/DML commit ordering analog)."""
    if is_multiprocess():
        from jax.experimental import multihost_utils
        multihost_utils.sync_global_devices(name)
