"""Distributed query execution primitives (round-1: SPMD aggregate + broadcast join).

The device-side replacement for the reference's distributed execution stack
(ForemanDistributed routing WorkOrder protos to Shiftbosses with block locality,
query_execution/ForemanDistributed.cpp:362-427; partitioned hash tables,
storage/PartitionedHashTablePool.hpp:49): instead of shipping work orders, the query
stage is a `shard_map` over a row-sharded mesh — each chip runs the identical compiled
kernel on its row shard; aggregation partial states are combined with `psum`
(pipeline-breaker == collective), and small build sides are replicated so probes are
chip-local (broadcast hash join). Key-partitioned shuffles (all_to_all) arrive with the
repartition rule in a later round.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, List, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from quickstep_tpu.ops import groupby as G
from quickstep_tpu.ops import join as J


def distributed_agg_join_step(mesh: Mesh, axis: str = "x"):
    """Build a jitted distributed step: filter + broadcast-join probe + dense
    group-by with psum'd partials — the distributed skeleton of TPC-H Q1/Q3-class
    queries (scan+filter+join+aggregate). Returns fn(sharded_inputs) -> outputs.

    Inputs (leading dim row-sharded over `axis` unless noted):
      l_key   int: join key column (FK)
      l_val   f64: measure column
      l_grp   int: group key in [0, n_groups)
      l_alive bool: live-row mask
      b_key   int: REPLICATED build-side unique key column
      b_alive bool: REPLICATED build-side mask
    Output: (group_sums f64[n_groups], group_counts i64[n_groups]) — replicated.
    """
    N_GROUPS = 8
    DOMAIN = 1 << 12

    def local_step(l_key, l_val, l_grp, l_alive, b_key, b_alive):
        # broadcast join: every chip builds the same small direct-address table
        table, _ = J.direct_build(b_key, b_alive, 0, DOMAIN)
        bidx, matched = J.direct_probe(table, l_key, l_alive, 0, DOMAIN)
        alive = l_alive & matched
        idx = G.pack_dense_index([l_grp], [0], [1], N_GROUPS, alive)
        _, results = G.dense_groupby(
            idx, N_GROUPS, [("sum", l_val, None), ("count", None, None)], alive)
        (sums, _), (counts, _) = results
        # pipeline breaker: combine partial aggregation states over the mesh
        sums = jax.lax.psum(sums, axis)
        counts = jax.lax.psum(counts, axis)
        return sums, counts

    fn = shard_map(
        local_step, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P(), P()),
        out_specs=(P(), P()),
    )
    return jax.jit(fn)


def make_example_inputs(mesh: Mesh, rows_per_chip: int = 256,
                        build_rows: int = 64, axis: str = "x"):
    """Tiny sharded inputs for the distributed step (dry-run scale)."""
    import numpy as np
    n = mesh.devices.size * rows_per_chip
    rng = np.random.default_rng(0)
    l_key = rng.integers(0, build_rows, n).astype(np.int64)
    l_val = rng.uniform(0, 100, n)
    l_grp = rng.integers(0, 8, n).astype(np.int64)
    l_alive = np.ones(n, bool)
    b_key = np.arange(build_rows, dtype=np.int64)
    b_alive = np.ones(build_rows, bool)
    from quickstep_tpu.parallel.mesh import shard_rows, replicate
    return (shard_rows(mesh, l_key, axis), shard_rows(mesh, l_val, axis),
            shard_rows(mesh, l_grp, axis), shard_rows(mesh, l_alive, axis),
            replicate(mesh, b_key), replicate(mesh, b_alive))
