"""Join kernels.

Device-side successors of the reference's join hash tables and work orders
(storage/HashTable.hpp:117 SeparateChaining/LinearOpenAddressing/
SimpleScalarSeparateChaining; relational_operators/HashJoinOperator.hpp:66 inner/
semi/anti/outer). No pointers, no chaining — three paths, all static-shape:

1. `direct_build/direct_probe` — the SimpleScalarSeparateChaining analog for dense
   integer keys (TPC-H PKs are 1..N): table = dense array indexed by (key - lo);
   build is one scatter, probe is one gather. Chosen when the plan-time key range
   fits `direct_domain_limit`.

2. `oa_build/oa_probe` — LinearOpenAddressing analog: power-of-two slot table
   storing build row indices; insertion resolves collisions with bounded
   scatter-retry rounds inside `lax.while_loop`; key equality is verified by
   gathering the actual build key columns (composite keys need no packing).

3. `sorted_build/expand_probe` — sort-based fallback for duplicate build keys
   (many-many joins, semi/anti with residuals over non-unique keys): build side is
   key-sorted; probes binary-search (searchsorted) the run of matches and expand up
   to a static K.

Uniqueness violations in paths 1-2 are detected on device (dup flag) so the executor
can retry with path 3 — the analog of HashTablePutResult::kOutOfSpace resize
(storage/HashTableBase.hpp:65).
"""

from __future__ import annotations

from functools import partial
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp

from quickstep_tpu.ops.kernels import hash64, hash_combine, next_pow2


# ---------------------------------------------------------------------
# path 1: direct-address (dense int keys)
# ---------------------------------------------------------------------

def direct_build(key: jnp.ndarray, alive: jnp.ndarray, lo: int, domain: int):
    """Returns (table[domain] of build row idx or -1, dup flag)."""
    idx = key.astype(jnp.int64) - lo
    in_dom = alive & (idx >= 0) & (idx < domain)
    idx = jnp.where(in_dom, idx, domain)
    rows = jnp.arange(key.shape[0], dtype=jnp.int32)
    # unique_indices: the planner picks this path for unique build keys. If
    # keys are unexpectedly duplicated the winner is unspecified, but every
    # slot still holds one of its rows (int32 stores are not torn), so the
    # read-back below raises the dup flag and the executor retries on the
    # expansion path — checked on an H100 by chip_smoke.dup_join_phase.
    table = jnp.full((domain,), -1, jnp.int32).at[idx].set(
        rows, mode="drop", unique_indices=True)
    # duplicate detection without a colliding scatter: a row that lost its slot
    # reads back a different winner
    read_back = table[jnp.clip(idx, 0, domain - 1)]
    dup = jnp.any(in_dom & (read_back != rows))
    return table, dup


def direct_probe(table: jnp.ndarray, key: jnp.ndarray, alive: jnp.ndarray,
                 lo: int, domain: int):
    """Returns (build_row_idx int32 (-1 if none), matched bool)."""
    idx = key.astype(jnp.int64) - lo
    in_range = (idx >= 0) & (idx < domain) & alive
    slot = jnp.clip(idx, 0, domain - 1)
    b = table[slot]
    matched = in_range & (b >= 0)
    return jnp.where(matched, b, -1), matched


# ---------------------------------------------------------------------
# path 2: open-addressing (generic / composite keys)
# ---------------------------------------------------------------------

def _hash_keys(key_cols: List[jnp.ndarray]) -> jnp.ndarray:
    hs = [hash64(k.astype(jnp.int64)) for k in key_cols]
    return hs[0] if len(hs) == 1 else hash_combine(hs)


def oa_build(key_cols: List[jnp.ndarray], alive: jnp.ndarray,
             table_size: int):
    """Insert build rows into an open-addressing table of row indices.

    table_size must be a power of two > number of live rows. Returns
    (table[table_size] int32 row idx or -1, dup flag). Collision resolution:
    last-writer-wins scatter, then losers re-probe at slot+1 — each while_loop
    round settles at least one contender per slot, so rounds are bounded by the
    longest collision chain.
    """
    n = key_cols[0].shape[0]
    mask_ts = jnp.uint64(table_size - 1)
    h = (_hash_keys(key_cols) & mask_ts).astype(jnp.int32)
    rows = jnp.arange(n, dtype=jnp.int32)
    table0 = jnp.full((table_size,), -1, jnp.int32)

    def key_eq(rows_a, rows_b):
        eq = jnp.ones(rows_a.shape, bool)
        for kc in key_cols:
            eq = eq & (kc[rows_a] == kc[rows_b])
        return eq

    def cond(state):
        _, pending, _, _ = state
        return jnp.any(pending)

    def body(state):
        table, pending, slots, dup = state
        # Inspect the CURRENT occupant first: a pending row must never scatter
        # into an occupied slot (it would evict a settled entry and silently
        # lose build rows — matches would vanish). Occupied-slot rows either
        # settle as duplicates (same key) or advance.
        cur = table[jnp.clip(slots, 0, table_size - 1)]
        occupied = cur >= 0
        same_key = pending & occupied & key_eq(jnp.clip(cur, 0, n - 1), rows)
        dup = dup | jnp.any(same_key)
        attempt = pending & (~occupied)
        sidx = jnp.where(attempt, slots, table_size)
        cand = table.at[sidx].set(rows, mode="drop")
        won = attempt & (cand[jnp.clip(slots, 0, table_size - 1)] == rows)
        still = pending & (~won) & (~same_key)
        slots = jnp.where(still, (slots + 1) & (table_size - 1), slots)
        return cand, still, slots, dup

    # run round 1 outside the loop: under shard_map the carry must enter the
    # while_loop already varying over the mesh axis (the raw zero-init table
    # is axis-invariant and trips the carry-type check)
    init = body((table0, alive, h, jnp.zeros((), bool)))
    table, _, _, dup = jax.lax.while_loop(cond, body, init)
    return table, dup


def oa_probe(table: jnp.ndarray, build_key_cols: List[jnp.ndarray],
             probe_key_cols: List[jnp.ndarray], alive: jnp.ndarray):
    """Probe: returns (build_row_idx (-1 if none), matched). Linear probing until
    an empty slot or a key match; all probes advance in lockstep under a
    while_loop with an active mask."""
    table_size = table.shape[0]
    nb = build_key_cols[0].shape[0]
    h = (_hash_keys(probe_key_cols) &
         jnp.uint64(table_size - 1)).astype(jnp.int32)

    def key_match(build_rows):
        eq = jnp.ones(build_rows.shape, bool)
        safe = jnp.clip(build_rows, 0, nb - 1)
        for bk, pk in zip(build_key_cols, probe_key_cols):
            eq = eq & (bk[safe] == pk)
        return eq & (build_rows >= 0)

    def cond(state):
        active, _, _, _ = state
        return jnp.any(active)

    def body(state):
        active, slots, result, steps = state
        occupant = table[slots]
        empty = occupant < 0
        match = key_match(occupant)
        found = active & match
        result = jnp.where(found, occupant, result)
        # stop on match or empty slot or table exhausted
        active = active & (~match) & (~empty) & (steps < table_size)
        slots = jnp.where(active, (slots + 1) & (table_size - 1), slots)
        return active, slots, result, steps + 1

    n = probe_key_cols[0].shape[0]
    # round 1 outside the loop: carry must enter while_loop varying over the
    # mesh axis under shard_map (see oa_build)
    init = body((alive, h, jnp.full((n,), -1, jnp.int32),
                 jnp.zeros((), jnp.int32)))
    _, _, result, _ = jax.lax.while_loop(cond, body, init)
    return result, result >= 0


# ---------------------------------------------------------------------
# path 3: sort-based merge join (duplicate build keys / generic fallback)
# ---------------------------------------------------------------------

def sorted_build(key: jnp.ndarray, alive: jnp.ndarray):
    """Single packed int64 key. Dead rows sort to +inf. Returns
    (sorted_key, order)."""
    k = jnp.where(alive, key, jnp.iinfo(key.dtype).max)
    order = jnp.argsort(k)
    return k[order], order


def merge_starts(sorted_key: jnp.ndarray, probe_key: jnp.ndarray):
    """For every probe key, (start, count) of its equal-key run in sorted_key
    — i.e. searchsorted left/right — via ONE concatenated stable sort plus
    prefix arithmetic, with NO random gathers.

    Why not jnp.searchsorted: binary search lowers to log2(n) rounds where
    every round is a full random-gather pass over the probe vector; this
    merge formulation is two lax.sorts and a few cumsums. The classic
    sort-merge-join counting trick: concat (build, probe) tagged, stable-sort
    by (key, tag); at a probe element, #builds before it = its merged rank
    minus its probe rank, and the builds of its own equal-key run all precede
    it (build tag sorts first), giving `right` and `count` directly."""
    n = sorted_key.shape[0]
    m = probe_key.shape[0]
    keys = jnp.concatenate([sorted_key,
                            probe_key.astype(sorted_key.dtype)])
    tag = jnp.concatenate([jnp.zeros((n,), jnp.int8),
                           jnp.ones((m,), jnp.int8)])
    iota = jnp.arange(n + m, dtype=jnp.int32)
    s_key, s_tag, s_iota = jax.lax.sort((keys, tag, iota), num_keys=2,
                                        is_stable=True)
    pos = jnp.arange(n + m, dtype=jnp.int32)
    t32 = s_tag.astype(jnp.int32)
    probe_rank = jnp.cumsum(t32)              # probes at positions <= pos
    bcnt = pos + 1 - probe_rank               # builds at positions <= pos
    # builds inside this equal-key run up to pos: bcnt - bcnt[run_start - 1],
    # the base propagated gather-free by cummax (bcnt is nondecreasing)
    change = (pos == 0) | (s_key != jnp.roll(s_key, 1))
    base = jax.lax.cummax(
        jnp.where(change, bcnt - (1 - t32), jnp.asarray(-1, jnp.int32)))
    run_builds = bcnt - base
    start = bcnt - run_builds   # searchsorted-left for probe elements
    # back to probe order: sort by original index; probes are the tail block
    _, r_start, r_count = jax.lax.sort((s_iota, start, run_builds),
                                       num_keys=1, is_stable=True)
    return r_start[n:], r_count[n:]


def expand_probe(sorted_key: jnp.ndarray, order: jnp.ndarray,
                 probe_key: jnp.ndarray, alive: jnp.ndarray,
                 max_matches: int):
    """For each probe row, the run [start, end) of equal build keys; returns
    (build_rows int32[n*K] flat, row-major (-1 pads), match_counts [n]).

    All intermediates stay 1-D (a 2-D [n, K<128] int32 was lane-padded on
    the earlier accelerator; no GPU reason is known)."""
    n = probe_key.shape[0]
    start, count = merge_starts(sorted_key, probe_key)
    count = jnp.where(alive, count, 0)
    k_r = jnp.arange(n * max_matches, dtype=jnp.int32) % max_matches
    pos = jnp.repeat(start.astype(jnp.int32), max_matches) + k_r
    ok = k_r < jnp.repeat(count.astype(jnp.int32), max_matches)
    safe = jnp.clip(pos, 0, sorted_key.shape[0] - 1)
    rows = jnp.where(ok, order[safe].astype(jnp.int32), -1)
    return rows, count


def merge_stats_probe(packed_build: jnp.ndarray, bmask: jnp.ndarray,
                      bval: jnp.ndarray, packed_probe: jnp.ndarray,
                      pmask: jnp.ndarray):
    """For every probe row: (matched, min, max) of the live build rows' int32
    `bval` within its equal-key run — the whole EXISTS-with-comparison
    semi/anti join (Q21's pattern) in ONE concatenated stable sort plus int32
    segmented scans and a sort-back. No group materialization, no
    binary-search rounds, no random gathers: replaces the former
    sort_groupby + merge_unique_probe + stats-gather pipeline (~5 full-width
    gathers) with two sorts and log(n) vector passes. The reference's
    equivalent is a full hash build + bulk probe (storage/HashTable.hpp:117
    getAllFromValueAccessor).

    Build rows tag-sort before probe rows inside an equal-key run, so a probe
    position's running segmented min/max covers exactly the live build rows
    of its run. `bval` must be int32-safe (caller checks); dead build rows
    contribute +INF/-INF sentinels.
    """
    nb = packed_build.shape[0]
    n_probe = packed_probe.shape[0]
    INF = jnp.iinfo(jnp.int32).max
    sent = jnp.iinfo(packed_build.dtype).max
    keys = jnp.concatenate([jnp.where(bmask, packed_build, sent),
                            packed_probe.astype(packed_build.dtype)])
    tag = jnp.concatenate([jnp.zeros((nb,), jnp.int8),
                           jnp.ones((n_probe,), jnp.int8)])
    vmin = jnp.concatenate([
        jnp.where(bmask, bval.astype(jnp.int32), INF),
        jnp.full((n_probe,), INF, jnp.int32)])
    iota = jnp.arange(nb + n_probe, dtype=jnp.int32)
    s_key, s_tag, s_iota, s_vmin = jax.lax.sort(
        (keys, tag, iota, vmin), num_keys=2, is_stable=True)
    pos = jnp.arange(nb + n_probe, dtype=jnp.int32)
    seg = (pos == 0) | (s_key != jnp.roll(s_key, 1))
    # Segmented running min/max WITHOUT lax.associative_scan (its unrolled
    # log-n lowering compiled slowly on the earlier accelerator): pack
    # (run_id << 32 | biased value) and take ONE native int64 cummax per
    # stat — a higher run_id always wins, so the cummax restarts at segment
    # boundaries by construction.
    run_id = jnp.cumsum(seg.astype(jnp.int32)).astype(jnp.int64)
    contrib = s_tag == 0          # only build rows carry values
    v64 = s_vmin.astype(jnp.int64)
    enc_min = jnp.where(contrib, jnp.int64(INF) - v64, jnp.int64(0))
    enc_max = jnp.where(contrib, v64 - jnp.int64(jnp.iinfo(jnp.int32).min),
                        jnp.int64(0))
    pk_min = jax.lax.cummax((run_id << 32) | enc_min)
    pk_max = jax.lax.cummax((run_id << 32) | enc_max)
    run_min = (jnp.int64(INF) - (pk_min & jnp.int64(0xFFFFFFFF))).astype(
        jnp.int32)
    run_max = ((pk_max & jnp.int64(0xFFFFFFFF)) +
               jnp.int64(jnp.iinfo(jnp.int32).min)).astype(jnp.int32)
    # live builds preceding this position within its run (merge_starts trick);
    # dead build rows were re-keyed to the sentinel, so every build row in a
    # real run is live — existence = run_builds > 0 (value-sentinel-proof)
    t32 = s_tag.astype(jnp.int32)
    bcnt = pos + 1 - jnp.cumsum(t32)
    base = jax.lax.cummax(
        jnp.where(seg, bcnt - (1 - t32), jnp.asarray(-1, jnp.int32)))
    run_builds = bcnt - base
    # back to original order; probes are the tail block
    _, r_min, r_max, r_nb = jax.lax.sort(
        (s_iota, run_min, run_max, run_builds), num_keys=1, is_stable=True)
    p_min = r_min[nb:]
    p_max = r_max[nb:]
    matched = pmask & (r_nb[nb:] > 0)
    return matched, p_min, p_max


def merge_cmp_probe(packed_build: jnp.ndarray, bmask: jnp.ndarray,
                    bval: jnp.ndarray, packed_probe: jnp.ndarray,
                    pmask: jnp.ndarray, pval: jnp.ndarray, op: str):
    """Fused EXISTS-with-comparison semi join: for every probe row, does its
    equal-key run contain a live build row x with (pval OP x)? Decided from
    the run's min/max (merge_stats_probe machinery) with the comparison
    evaluated IN SORTED ORDER, so the sort-back carries ONE int32
    (iota << 1 | hit) instead of three stat payloads — sort cost scales
    with operand count. Returns matched&hit bool in probe order.
    (Q21's correlated <>/</> EXISTS; reference bar: bulk hash probe,
    relational_operators/HashJoinOperator.hpp:420-422.)"""
    nb = packed_build.shape[0]
    n_probe = packed_probe.shape[0]
    INF = jnp.iinfo(jnp.int32).max
    sent = jnp.iinfo(packed_build.dtype).max
    keys = jnp.concatenate([jnp.where(bmask, packed_build, sent),
                            packed_probe.astype(packed_build.dtype)])
    tag = jnp.concatenate([jnp.zeros((nb,), jnp.int8),
                           jnp.ones((n_probe,), jnp.int8)])
    # one value slot: build rows carry bval (stat input), probe rows carry
    # their own comparison operand
    vals = jnp.concatenate([jnp.where(bmask, bval.astype(jnp.int32), INF),
                            pval.astype(jnp.int32)])
    iota = jnp.arange(nb + n_probe, dtype=jnp.int32)
    s_key, s_tag, s_iota, s_v = jax.lax.sort(
        (keys, tag, iota, vals), num_keys=2, is_stable=True)
    pos = jnp.arange(nb + n_probe, dtype=jnp.int32)
    seg = (pos == 0) | (s_key != jnp.roll(s_key, 1))
    run_id = jnp.cumsum(seg.astype(jnp.int32)).astype(jnp.int64)
    contrib = s_tag == 0
    v64 = s_v.astype(jnp.int64)
    enc_min = jnp.where(contrib, jnp.int64(INF) - v64, jnp.int64(0))
    enc_max = jnp.where(contrib, v64 - jnp.int64(jnp.iinfo(jnp.int32).min),
                        jnp.int64(0))
    run_min = (jnp.int64(INF) - (jax.lax.cummax((run_id << 32) | enc_min) &
                                 jnp.int64(0xFFFFFFFF))).astype(jnp.int32)
    run_max = ((jax.lax.cummax((run_id << 32) | enc_max) &
                jnp.int64(0xFFFFFFFF)) +
               jnp.int64(jnp.iinfo(jnp.int32).min)).astype(jnp.int32)
    t32 = s_tag.astype(jnp.int32)
    bcnt = pos + 1 - jnp.cumsum(t32)
    base = jax.lax.cummax(
        jnp.where(seg, bcnt - (1 - t32), jnp.asarray(-1, jnp.int32)))
    has_build = (bcnt - base) > 0
    if op == "<>":
        hit = (run_min != s_v) | (run_max != s_v)
    elif op == "<":
        hit = s_v < run_max
    elif op == "<=":
        hit = s_v <= run_max
    elif op == ">":
        hit = s_v > run_min
    elif op == ">=":
        hit = s_v >= run_min
    else:
        raise ValueError(op)
    hit = hit & has_build
    if (nb + n_probe) < (1 << 30):
        back = (s_iota.astype(jnp.int32) << 1) | hit.astype(jnp.int32)
    else:
        back = (s_iota.astype(jnp.int64) << 1) | hit.astype(jnp.int64)
    out = jax.lax.sort(back)          # (iota<<1|hit) sorts by iota
    return pmask & ((out[nb:] & 1) == 1)


def merge_unique_probe(packed_build: jnp.ndarray, bmask: jnp.ndarray,
                       packed_probe: jnp.ndarray, pmask: jnp.ndarray):
    """Merge-join probe against a (nominally unique-key) build side. Returns
    (build_row_idx (-1 if none), matched, dup) where dup flags duplicate live
    build keys (the executor's cue to retry on the expansion path — the
    kOutOfSpace analog). Replaces the open-addressing lockstep probe loop,
    whose per-round full gather passes dominate its join time."""
    sorted_key, order = sorted_build(packed_build, bmask)
    sent = jnp.iinfo(sorted_key.dtype).max
    live_sorted = sorted_key != sent
    dup = jnp.any((sorted_key == jnp.roll(sorted_key, 1)) & live_sorted &
                  (jnp.arange(sorted_key.shape[0]) > 0))
    start, count = merge_starts(sorted_key, packed_probe)
    matched = pmask & (count > 0)
    safe = jnp.clip(start, 0, order.shape[0] - 1)
    bidx = jnp.where(matched, order[safe].astype(jnp.int32), -1)
    return bidx, matched, dup
