"""Core vectorized building blocks: masks, compaction, hashing, packing.

These replace the reference's TupleIdSequence/BitVector machinery
(storage/TupleIdSequence.hpp:44, utility/BitVector.hpp): selection is a bool mask
aligned with column arrays; compaction is a cumsum-scatter; everything is static-shape
and jit-traceable so XLA fuses it into the surrounding query stage.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp


# Trace-time op counters (the WorkOrder profiling analog,
# query_execution/PolicyEnforcerBase.cpp:45 recordTimeForWorkOrder): counted
# host-side while a plan traces, snapshotted per compiled program by the
# executor and surfaced in \explain_analyze — each gather is one random
# device-memory access pass.
TRACE = {"gathers": 0, "gather_rows": 0}


def reset_trace():
    TRACE["gathers"] = 0
    TRACE["gather_rows"] = 0


def alive_mask(capacity: int, count) -> jnp.ndarray:
    """Rows [0, count) of a padded array are live."""
    return jnp.arange(capacity) < count


def compact_indices(mask: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Stable compaction: returns (dest_idx, count). Dead rows get dest capacity
    (out-of-range -> dropped by scatter mode='drop')."""
    capacity = mask.shape[0]
    pos = jnp.cumsum(mask.astype(jnp.int32)) - 1
    dest = jnp.where(mask, pos, capacity)
    return dest, jnp.sum(mask.astype(jnp.int32))


def scatter_compact(col: jnp.ndarray, dest: jnp.ndarray,
                    capacity: int, fill=0) -> jnp.ndarray:
    """Scatter col[i] -> out[dest[i]]; dest == capacity drops. Compaction
    destinations are unique by construction; the dropped rows all share the
    one out-of-range index, which the bounds check discards."""
    out = jnp.full((capacity,) + col.shape[1:], fill, dtype=col.dtype)
    return out.at[dest].set(col, mode="drop", unique_indices=True)


def _lane_dtype(dt) -> jnp.dtype:
    """Canonical gather-lane dtype. 64-bit types keep their own lane dtype
    (the earlier accelerator's x64 emulation forbade 64-bit bitcasts; no
    GPU reason is known); 32-bit
    types share int32 lanes; sub-byte/bool share int8 lanes."""
    dt = jnp.dtype(dt)
    if dt.itemsize == 8:
        return dt
    if dt.itemsize == 4:
        return jnp.dtype(jnp.int32)
    return jnp.dtype(jnp.int8)


def _to_lane(d: jnp.ndarray, lane: jnp.dtype) -> jnp.ndarray:
    if d.dtype == lane:
        return d
    if d.dtype.itemsize == lane.itemsize and d.dtype.kind in "fu":
        return jax.lax.bitcast_convert_type(d, lane)
    return d.astype(lane)


def _from_lane(d: jnp.ndarray, dt) -> jnp.ndarray:
    dt = jnp.dtype(dt)
    if d.dtype == dt:
        return d
    if d.dtype.itemsize == dt.itemsize and dt.kind in "fu":
        return jax.lax.bitcast_convert_type(d, dt)
    return d.astype(dt)


# Size ceiling for 2-D row-packed gathers (see multi_gather). Module
# mutable: the executor can tighten it when running under a strict HBM budget
# (streamed SF10+ plans keep headroom for their working sets).
PACK_PAD_LIMIT = 5 << 30


def pack_bytes(n: int, k: int, lane) -> int:
    """Device bytes of an [n, k] row pack of `lane` dtype: a GPU stores it
    unpadded."""
    return n * k * jnp.dtype(lane).itemsize


def multi_gather(cols: List[Optional[jnp.ndarray]], idx: jnp.ndarray):
    """Gather many equal-length columns by ONE index vector using row-packed
    gathers (one [n, k] gather per lane dtype instead of k 1-D gathers).

    k separate 1-D gathers each pay a random-access pass over the index,
    while a row gather shares it across the k lanes. Whether the pack wins on
    the GPU is unmeasured. Columns are grouped by canonical lane dtype (64-bit
    kinds keep their own group, see _lane_dtype). None entries pass through
    (absent null masks)."""
    out = list(cols)
    groups: dict = {}
    for i, c in enumerate(cols):
        if c is None:
            continue
        groups.setdefault(_lane_dtype(c.dtype), []).append(i)
    n_src = next((c.shape[0] for c in cols if c is not None), 0)
    m_idx = idx.shape[0]
    for lane, idxs in groups.items():
        # the [n, k] pack is a transient copy of the group; above the cap,
        # issue plain per-column 1-D gathers (no copy, k passes)
        if len(idxs) == 1 or \
                pack_bytes(max(n_src, m_idx), len(idxs), lane) > PACK_PAD_LIMIT:
            TRACE["gathers"] += len(idxs)
            TRACE["gather_rows"] += m_idx * len(idxs)
            for i in idxs:
                out[i] = cols[i][idx]
            continue
        TRACE["gathers"] += 1
        TRACE["gather_rows"] += m_idx
        packed = jnp.stack([_to_lane(cols[i], lane) for i in idxs], axis=1)
        g = packed[idx]  # [m, k] one row gather per lane group
        for j, i in enumerate(idxs):
            out[i] = _from_lane(g[:, j], cols[i].dtype)
    return out


def compact_order(alive: jnp.ndarray) -> jnp.ndarray:
    """Stable permutation putting live rows first (gather-based compaction).
    One payload-carrying sort instead of a scatter per column; the choice
    was made for the earlier accelerator's slow scatters and is unmeasured
    on the GPU against compact_indices + scatter_compact."""
    capacity = alive.shape[0]
    iota = jnp.arange(capacity, dtype=jnp.int32)
    _, order = jax.lax.sort(((~alive).astype(jnp.int8), iota),
                            num_keys=1, is_stable=True)
    return order


def hash64(x: jnp.ndarray) -> jnp.ndarray:
    """SplitMix64 finalizer — the device analog of farmhash in the reference
    (utility/BloomFilter.hpp uses farmhash; exact function is irrelevant, mixing
    quality is)."""
    h = x.astype(jnp.uint64)
    h = (h ^ (h >> 30)) * jnp.uint64(0xBF58476D1CE4E5B9)
    h = (h ^ (h >> 27)) * jnp.uint64(0x94D049BB133111EB)
    h = h ^ (h >> 31)
    return h


def hash_combine(hs: List[jnp.ndarray]) -> jnp.ndarray:
    """Combine per-column hashes (utility/CompositeHash.hpp analog)."""
    out = hs[0]
    for h in hs[1:]:
        out = out ^ (h + jnp.uint64(0x9E3779B97F4A7C15) +
                     (out << jnp.uint64(6)) + (out >> jnp.uint64(2)))
    return out


def next_pow2(n: int) -> int:
    n = max(int(n), 1)
    p = 1
    while p < n:
        p <<= 1
    return p


def round_up(n: int, m: int) -> int:
    return ((int(n) + m - 1) // m) * m


_MAX_SENTINELS = {
    "int32": jnp.iinfo(jnp.int32).max,
    "int64": jnp.iinfo(jnp.int64).max,
    "float32": jnp.inf,
    "float64": jnp.inf,
    "bool": True,
}
_MIN_SENTINELS = {
    "int32": jnp.iinfo(jnp.int32).min,
    "int64": jnp.iinfo(jnp.int64).min,
    "float32": -jnp.inf,
    "float64": -jnp.inf,
    "bool": False,
}


def max_sentinel(dtype) -> object:
    return _MAX_SENTINELS[jnp.dtype(dtype).name]


def min_sentinel(dtype) -> object:
    return _MIN_SENTINELS[jnp.dtype(dtype).name]
