"""LIP / bloom filters.

Device-side successors of the reference's lookahead-information-passing filters
(utility/lip_filter/: BitVectorExactFilter.hpp:53 — exact bit per key in [min,max],
giving exact semi-joins; SingleIdentityHashFilter.hpp:55 — one-hash bloom; BloomFilter
.hpp:48). A filter is a bool occupancy array in HBM: build is one masked scatter,
probe is one gather — XLA fuses the probe into the consuming scan, which is exactly
the LIP effect (filter rows before they reach the join). vs the reference's packed
bit-vectors: byte-per-slot costs 8x memory but builds in a single conflict-free
scatter (no atomic word OR).

The executor uses the exact variant for semi/anti joins over single integer keys with
plan-time ranges (FilterJoin strength reduction, rules/InjectJoinFilters.hpp:55
analog: no row-index table needed).
"""

from __future__ import annotations

import jax.numpy as jnp

from quickstep_tpu.ops.kernels import hash64


def exact_filter_build(key: jnp.ndarray, alive: jnp.ndarray, lo: int,
                       domain: int) -> jnp.ndarray:
    """BitVectorExactFilter: presence per key value in [lo, lo+domain)."""
    idx = key.astype(jnp.int64) - lo
    ok = alive & (idx >= 0) & (idx < domain)
    slot = jnp.where(ok, idx, domain)
    return jnp.zeros((domain,), bool).at[slot].set(True, mode="drop")


def exact_filter_probe(bits: jnp.ndarray, key: jnp.ndarray,
                       alive: jnp.ndarray, lo: int) -> jnp.ndarray:
    domain = bits.shape[0]
    idx = key.astype(jnp.int64) - lo
    ok = alive & (idx >= 0) & (idx < domain)
    return ok & bits[jnp.clip(idx, 0, domain - 1)]


def bloom_build(key_cols, alive: jnp.ndarray, nbits: int) -> jnp.ndarray:
    """One-hash bloom over arbitrary (composite) keys; nbits a power of two
    (SingleIdentityHashFilter analog, composite via hash_combine)."""
    from quickstep_tpu.ops.kernels import hash_combine
    hs = [hash64(k.astype(jnp.int64)) for k in key_cols]
    h = hs[0] if len(hs) == 1 else hash_combine(hs)
    slot = (h & jnp.uint64(nbits - 1)).astype(jnp.int64)
    slot = jnp.where(alive, slot, nbits)
    return jnp.zeros((nbits,), bool).at[slot].set(True, mode="drop")


def bloom_probe(bits: jnp.ndarray, key_cols, alive: jnp.ndarray) -> jnp.ndarray:
    from quickstep_tpu.ops.kernels import hash_combine
    nbits = bits.shape[0]
    hs = [hash64(k.astype(jnp.int64)) for k in key_cols]
    h = hs[0] if len(hs) == 1 else hash_combine(hs)
    slot = (h & jnp.uint64(nbits - 1)).astype(jnp.int64)
    return alive & bits[slot]
