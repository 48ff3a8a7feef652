"""Key-partitioned (radix) shuffle over the device mesh.

The device-side analog of the reference's partitioned parallelism core
(query_optimizer/rules/Partition.hpp:45-87 repartition planning,
storage/InsertDestination.hpp:75 PartitionAwareInsertDestination hash-routing,
storage/PartitionedHashTablePool.hpp:49 per-partition hash tables): instead of
hash-routing output tuples into per-partition blocks, each device radix-buckets
its local rows by key hash and exchanges whole buckets with `jax.lax.all_to_all`
over the mesh axis (NVLink between GPUs). After the exchange every device holds exactly the rows
whose keys hash to its partition, so joins/aggregations proceed device-local with
no further communication — per-partition hash tables by construction.

All shapes are static: each device sends `n_parts` buckets of `bucket_cap` rows;
bucket overflow (skew) raises a replicated flag that the executor's retry loop
handles by escalating `bucket_cap` (HashTablePutResult::kOutOfSpace analog,
storage/HashTableBase.hpp:65) — and heavy build keys can be pre-salted
(`salt > 1`): build rows are replicated to `salt` consecutive partitions and each
probe row picks one deterministically, splitting a hot key's probe stream across
`salt` devices (the skew answer the reference delegates to cost-model-driven
repartitioning).

These functions run INSIDE `shard_map` — arrays are device-local, and
communication is explicit collectives on `axis`.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp

from quickstep_tpu.ops.kernels import hash64, multi_gather


def _partition_of(packed_key: jnp.ndarray, n_parts: int) -> jnp.ndarray:
    """Hash-partition id in [0, n_parts) — hashed so that pre-sorted or
    range-clustered keys still spread evenly."""
    h = hash64(packed_key.astype(jnp.int64))
    return (h % jnp.uint64(n_parts)).astype(jnp.int32)


def radix_exchange(packed_key: jnp.ndarray, payload: List[jnp.ndarray],
                   alive: jnp.ndarray, n_parts: int, axis: str,
                   bucket_cap: int, salt: int = 1,
                   probe_side: bool = True):
    """Device-local radix partition + all_to_all exchange.

    packed_key int64[L], payload: list of 1-D arrays[L] (the key itself should
    be among them if needed downstream), alive bool[L]. Returns
    (payload', alive', overflow) with local length n_parts * bucket_cap.

    salt > 1 splits each logical partition across `salt` devices: probe rows
    scatter to one salted replica (by row parity), build rows
    (probe_side=False) are replicated to all `salt` replicas.
    """
    L = packed_key.shape[0]
    p0 = _partition_of(packed_key, n_parts)

    if salt > 1 and not probe_side:
        # replicate build rows to all salt replicas: tile rows salt times
        reps = []
        for s in range(salt):
            reps.append(((p0 + s) % n_parts, alive))
        p = jnp.concatenate([r[0] for r in reps])
        alive_x = jnp.concatenate([r[1] for r in reps])
        payload_x = [jnp.concatenate([c] * salt) for c in payload]
        Lx = L * salt
    else:
        if salt > 1:
            # probe row picks a deterministic replica by local row index
            s = (jnp.arange(L, dtype=jnp.int32) % salt)
            p = (p0 + s) % n_parts
        else:
            p = p0
        alive_x = alive
        payload_x = payload
        Lx = L

    # dead rows bucket out of range (dropped by the scatter)
    p = jnp.where(alive_x, p, n_parts)

    # stable sort by partition id -> per-partition ranks via run starts
    order = jnp.argsort(p, stable=True).astype(jnp.int32)
    sorted_p = p[order]
    starts = jnp.searchsorted(sorted_p, jnp.arange(n_parts, dtype=sorted_p.dtype),
                              side="left")
    pos = jnp.arange(Lx, dtype=jnp.int32)
    rank = pos - starts[jnp.clip(sorted_p, 0, n_parts - 1)].astype(jnp.int32)
    in_cap = (sorted_p < n_parts) & (rank < bucket_cap)
    overflow = jnp.any((sorted_p < n_parts) & (rank >= bucket_cap))
    dest = jnp.where(in_cap, sorted_p * bucket_cap + rank,
                     n_parts * bucket_cap)

    # one unique-index scatter of local row ids, then row-packed gathers
    buf_idx = jnp.full((n_parts * bucket_cap,), -1, jnp.int32).at[dest].set(
        order, mode="drop", unique_indices=True)
    occupied = buf_idx >= 0
    safe = jnp.clip(buf_idx, 0, Lx - 1)
    bufs = multi_gather(payload_x, safe)
    bufs = [jnp.where(occupied, b, jnp.zeros((), b.dtype))
            if b.dtype != jnp.bool_ else (b & occupied) for b in bufs]

    # exchange: bucket j of device i -> device j (segment i)
    exch = [jax.lax.all_to_all(b, axis, split_axis=0, concat_axis=0, tiled=True)
            for b in bufs]
    alive_out = jax.lax.all_to_all(occupied, axis, split_axis=0, concat_axis=0,
                                   tiled=True)
    overflow = jax.lax.pmax(overflow.astype(jnp.int32), axis) > 0
    return exch, alive_out, overflow
