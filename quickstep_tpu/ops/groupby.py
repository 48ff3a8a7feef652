"""Group-by aggregation kernels.

The device-side successors of the reference's four aggregation hash tables
(storage/CollisionFreeVectorTable.hpp:55, PackedPayloadHashTable.hpp:70,
ThreadPrivateCompactKeyHashTable.hpp:51, HashTablePool.hpp:52):

- `dense_groupby` — the CollisionFreeVectorTable analog: composite keys are radix-packed into a small integer domain and every aggregate
  becomes one masked scatter-add/min/max into a dense state array. Chosen by the
  planner when plan-time key ranges bound the domain (cost-model gate mirroring
  ExecutionGenerator::canUseCollisionFreeAggregation,
  query_optimizer/ExecutionGenerator.cpp:92-104).

- `sort_groupby` — the generic path (PackedPayload analog): lexsort rows by key
  columns, derive segment ids from boundaries, segment-reduce each aggregate. Fully
  static shapes; group count is a traced scalar; output rows [0, n_groups) are live.

All inputs are (columns, live-mask); aggregates skip masked rows and NULLs. Every
aggregate returns (data, non_null_count) — count 0 means the SQL result is NULL
(except COUNT itself).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp

from quickstep_tpu.ops.kernels import max_sentinel, min_sentinel, multi_gather

AggIn = Tuple[str, Optional[object], Optional[object]]  # (fn, vals, valid)


# ---------------------------------------------------------------------
# dense (collision-free) path
# ---------------------------------------------------------------------

def pack_dense_index(key_cols: List[jnp.ndarray], key_offsets: List[int],
                     key_strides: List[int], domain: int,
                     alive: jnp.ndarray) -> jnp.ndarray:
    """Radix-pack composite keys into [0, domain); dead/out-of-range rows -> domain
    (dropped by scatters)."""
    idx = jnp.zeros(alive.shape, dtype=jnp.int64)
    for col, off, stride in zip(key_cols, key_offsets, key_strides):
        idx = idx + (col.astype(jnp.int64) - off) * stride
    return jnp.where(alive & (idx >= 0) & (idx < domain), idx, domain)


# Below this domain size, aggregate via broadcast-compare reductions (D full
# elementwise passes) instead of colliding scatter-adds. The earlier
# accelerator serialized such scatters; a GPU adds atomically, and which form
# wins there is unmeasured.
BROADCAST_DOMAIN_LIMIT = 128


def dense_groupby(idx: jnp.ndarray, domain: int, agg_specs: List[AggIn],
                  alive: jnp.ndarray):
    """Collision-free aggregation: idx from pack_dense_index. Returns
    (occupied bool[domain], [(data[domain], nn_count[domain])...])."""
    if domain <= BROADCAST_DOMAIN_LIMIT:
        return _dense_groupby_broadcast(idx, domain, agg_specs, alive)
    return _dense_groupby_scatter(idx, domain, agg_specs, alive)


def _dense_groupby_broadcast(idx, domain: int, agg_specs: List[AggIn],
                             alive: jnp.ndarray):
    """One-hot membership (domain, n) + per-group masked reductions — zero
    scatters, the device-side CollisionFreeVectorTable."""
    in_dom = idx < domain
    onehot = (idx[None, :] == jnp.arange(domain, dtype=idx.dtype)[:, None])
    results = []
    nn_cache = {}
    for fn, vals, valid in agg_specs:
        live = alive & in_dom if valid is None else (alive & in_dom & valid)
        key = id(valid)
        if key not in nn_cache:
            nn_cache[key] = jnp.sum(onehot & live[None, :], axis=1,
                                    dtype=jnp.int32)
        nn = nn_cache[key]
        if fn == "count":
            data = nn
        elif fn in ("sum", "avg"):
            contrib = jnp.where(live, vals, jnp.zeros((), vals.dtype))
            acc = jnp.sum(jnp.where(onehot, contrib[None, :],
                                    jnp.zeros((), contrib.dtype)), axis=1)
            data = acc if fn == "sum" else \
                acc.astype(jnp.float64) / jnp.maximum(nn, 1)
        elif fn == "min":
            contrib = jnp.where(live, vals, max_sentinel(vals.dtype))
            data = jnp.min(jnp.where(onehot, contrib[None, :],
                                     max_sentinel(vals.dtype)), axis=1)
        elif fn == "max":
            contrib = jnp.where(live, vals, min_sentinel(vals.dtype))
            data = jnp.max(jnp.where(onehot, contrib[None, :],
                                     min_sentinel(vals.dtype)), axis=1)
        else:
            raise ValueError(fn)
        results.append((data, nn))
    occupied = jnp.any(onehot & alive[None, :] & in_dom[None, :], axis=1)
    return occupied, results


def _dense_groupby_scatter(idx, domain: int, agg_specs: List[AggIn],
                           alive: jnp.ndarray):
    in_dom = idx < domain
    results = []
    for fn, vals, valid in agg_specs:
        live = alive & in_dom if valid is None else (alive & in_dom & valid)
        # int32 counts: bounded by capacity; 64-bit scatter-adds are emulated
        nn = jnp.zeros((domain,), jnp.int32).at[idx].add(
            live.astype(jnp.int32), mode="drop")
        if fn == "count":
            data = nn
        elif fn in ("sum", "avg"):
            contrib = jnp.where(live, vals, jnp.zeros((), vals.dtype))
            acc = jnp.zeros((domain,), contrib.dtype).at[idx].add(
                contrib, mode="drop")
            data = acc if fn == "sum" else \
                acc.astype(jnp.float64) / jnp.maximum(nn, 1)
        elif fn == "min":
            contrib = jnp.where(live, vals, max_sentinel(vals.dtype))
            data = jnp.full((domain,), max_sentinel(vals.dtype),
                            contrib.dtype).at[idx].min(contrib, mode="drop")
        elif fn == "max":
            contrib = jnp.where(live, vals, min_sentinel(vals.dtype))
            data = jnp.full((domain,), min_sentinel(vals.dtype),
                            contrib.dtype).at[idx].max(contrib, mode="drop")
        else:
            raise ValueError(fn)
        results.append((data, nn))
    occupied = jnp.zeros((domain,), bool).at[idx].set(True, mode="drop")
    return occupied, results


# ---------------------------------------------------------------------
# generic sort-based path
# ---------------------------------------------------------------------

def _seg_fill(marks: jnp.ndarray, vals: jnp.ndarray) -> jnp.ndarray:
    """Forward-fill `vals` from marked rows to every following row (up to the
    next mark) WITHOUT a gather: pack (mark_rank << 32 | value_bits) and take
    one native int64 cummax per 32-bit half. Rank strictly increases at each
    mark and non-mark rows contribute 0, so the cummax propagates exactly the
    latest mark's bits — value bits are ballast, never compared (each segment
    has ONE mark). Rows before the first mark decode to zero-bits. 64-bit
    values ride as two independent halves. Replaces a random gather."""
    r = jnp.cumsum(marks.astype(jnp.int32)).astype(jnp.int64)

    def fill_field(field64):   # field64: int64 values in [0, 2^32)
        packed = jnp.where(marks, (r << 32) | field64, jnp.int64(0))
        return jax.lax.cummax(packed) & jnp.int64(0xFFFFFFFF)

    dt = vals.dtype
    # NO 64-bit bitcasts anywhere (the earlier accelerator's x64 emulation
    # could not compile them; no GPU reason is known); everything below is
    # plain int64 arithmetic.
    if dt == jnp.float32:
        iv = jax.lax.bitcast_convert_type(vals, jnp.uint32)  # 32-bit: fine
        out = fill_field(iv.astype(jnp.int64))
        return jax.lax.bitcast_convert_type(out.astype(jnp.uint32),
                                            jnp.float32)
    if dt == jnp.float64:
        raise ValueError("_seg_fill: f64 needs bitcasts; caller must use "
                         "the gather fallback")
    if dt.itemsize <= 4:
        v64 = vals.astype(jnp.int64) & jnp.int64(0xFFFFFFFF)
        f = fill_field(v64)
        # reinterpret the low 32 bits as two's-complement
        f = jnp.where(f >= jnp.int64(1) << 31, f - (jnp.int64(1) << 32), f)
        return f.astype(dt)
    iv = vals.astype(jnp.int64)
    hi = fill_field((iv >> 32) & jnp.int64(0xFFFFFFFF))
    lo = fill_field(iv & jnp.int64(0xFFFFFFFF))
    # (hi << 32) wraps negative for hi >= 2^31 — exactly the two's-complement
    # reinterpretation needed to reassemble the original int64
    return ((hi << 32) | lo).astype(dt)


def _seg_minmax32(change: jnp.ndarray, contrib: jnp.ndarray,
                  is_max: bool) -> jnp.ndarray:
    """Running segmented min/max for <=32-bit values via ONE int64 cummax of
    (segment_rank << 32 | biased value): a later segment's rank dominates, so
    the scan restarts at boundaries; within a segment the biased value
    decides. At each segment's last row this is the segment aggregate —
    replaces the scatter-into-slots + gather-back pair."""
    r = jnp.cumsum(change.astype(jnp.int32)).astype(jnp.int64)
    v64 = contrib.astype(jnp.int64)
    bias = jnp.int64(jnp.iinfo(jnp.int32).min)
    enc = (v64 - bias) if is_max else (jnp.int64(0xFFFFFFFF) - (v64 - bias))
    packed = jax.lax.cummax((r << 32) | enc)
    dec = packed & jnp.int64(0xFFFFFFFF)
    dec = (dec + bias) if is_max else ((jnp.int64(0xFFFFFFFF) - dec) + bias)
    return dec.astype(contrib.dtype)


def sort_groupby(key_cols: List[jnp.ndarray],
                 key_valids: List[Optional[jnp.ndarray]],
                 agg_specs: List[AggIn],
                 alive: jnp.ndarray,
                 packed_key: Optional[jnp.ndarray] = None,
                 sort_subset: Optional[List[int]] = None,
                 want_rows: bool = False):
    """Sort-based group-by, gather/scatter-free.

    ONE payload-carrying `lax.sort` moves the key(s) and every aggregate
    input together (instead of a random gather per input after the sort),
    then per-segment results come from
    segmented associative scans — no colliding scatters, no random gathers,
    no compaction. Group outputs live at each segment's LAST sorted row.

    Returns (out_key_cols, out_key_valids, occupied_mask, n_groups,
    [(data, nn_count)...]). Output arrays have input capacity; rows where
    occupied_mask is True carry the group results (one per group).
    """
    capacity = alive.shape[0]
    iota = jnp.arange(capacity, dtype=jnp.int32)

    # ---- assemble sort operands: keys first, then deduped payloads
    if packed_key is not None:
        # planner-provided injective integer packing of the composite key —
        # fold aliveness into the key (packed values are < 2^62 / 2^31, so the
        # dtype max is a safe dead-row sentinel)
        sent = jnp.iinfo(packed_key.dtype).max
        key_ops = [jnp.where(alive, packed_key, sent)]
    else:
        # sort_subset: a minimal key cover (ReduceGroupByAttributes analog) —
        # functionally-dependent keys need not participate in the sort.
        subset = list(sort_subset) if sort_subset is not None \
            else list(range(len(key_cols)))
        key_ops = [(~alive).astype(jnp.int8)]  # dead rows last
        for i in subset:
            col, valid = key_cols[i], key_valids[i]
            k = col
            if valid is not None:
                # NULL group keys group together at the max sentinel
                k = jnp.where(valid, col, max_sentinel(col.dtype))
            key_ops.append(k)
    n_keys = len(key_ops)

    payloads: List[jnp.ndarray] = []
    payload_pos = {}  # id(array) -> operand index (dedup shared inputs)

    def add_payload(arr):
        if arr is None:
            return None
        pos = payload_pos.get(id(arr))
        if pos is None:
            pos = n_keys + len(payloads)
            payload_pos[id(arr)] = pos
            payloads.append(arr.astype(jnp.int8)
                            if arr.dtype == jnp.bool_ else arr)
        return pos

    if packed_key is None:
        add_payload(alive)
    key_slots = [(add_payload(c), add_payload(v))
                 for c, v in zip(key_cols, key_valids)]
    agg_slots = [(add_payload(v), add_payload(vd))
                 for _, v, vd in agg_specs]
    # original-row payload: each output (group) row's representative input
    # row — lets callers fetch FD-determined group attributes lazily per
    # group instead of materializing them at input capacity (payload
    # operands are ~free; random gathers are not)
    rows_pos = add_payload(iota) if want_rows else None

    sorted_ops = jax.lax.sort(tuple(key_ops) + tuple(payloads),
                              num_keys=n_keys, is_stable=True)

    def sp(pos, ref):
        """Sorted payload at operand index pos, restored to ref's dtype."""
        if pos is None:
            return None
        s = sorted_ops[pos]
        return s.astype(jnp.bool_) if ref.dtype == jnp.bool_ else s

    if packed_key is not None:
        s_alive = sorted_ops[0] != jnp.iinfo(packed_key.dtype).max
        s_change_keys = [sorted_ops[0]]
    else:
        s_alive = sp(payload_pos[id(alive)], alive)
        s_change_keys = list(sorted_ops[1:n_keys])

    # ---- segment boundaries (dead rows form a suffix)
    change = iota == 0
    for k in s_change_keys:
        change = change | (k != jnp.roll(k, 1))
    change = change & s_alive
    n_groups = jnp.sum(change.astype(jnp.int32))
    # last row of each segment: next row starts a new one, is dead, or is end
    nxt_change = jnp.roll(change, -1)
    nxt_alive = jnp.roll(s_alive, -1)
    last = s_alive & ((iota == capacity - 1) | nxt_change | ~nxt_alive)

    # Segmented reductions WITHOUT jax.lax.associative_scan (its custom
    # combine compiled for hours on the earlier accelerator; unmeasured on
    # the GPU) and WITHOUT random gathers:
    #   SUM/COUNT — native prefix cumsum; per-segment total at each row is
    #     S[row] - S[segment_start - 1]. The base S[start-1] equals
    #     (S - contrib) AT the segment-start row, propagated to the rest of
    #     its segment by _seg_fill's packed cummax — gather-free, exact for
    #     integer/decimal sums; f64 sums lose only difference-of-prefix
    #     rounding (~1e-11 rel at 8M rows), inside oracle tolerance.
    #   MIN/MAX — <=32-bit signed values ride _seg_minmax32's single packed
    #     cummax; wider values keep the scatter-into-slots + gather-back.
    sid = jnp.cumsum(change.astype(jnp.int32)) - 1          # segment index
    sid_safe = jnp.clip(sid, 0, capacity - 1)
    seg_start = jax.lax.cummax(jnp.where(change, iota, -1))  # start row idx

    slot_ops = []     # arrays to gather at sid_safe (wide min/max only)
    plan_ops = []     # (fn-kind, nn, data-or-slot-index)

    def seg_sum(contrib):
        S = jnp.cumsum(contrib)
        if S.dtype == jnp.float64:
            # f64 can't ride _seg_fill (no 64-bit bitcasts, see above):
            # fetch the segment base with a gather instead
            base_idx = jnp.clip(seg_start - 1, 0, capacity - 1)
            base = jnp.where(seg_start <= 0, jnp.zeros((), S.dtype),
                             S[base_idx])
        else:
            base = _seg_fill(change, S - contrib)
        return S - base

    nn_cache = {}

    def live_count(live):
        key = id(live)
        if key not in nn_cache:
            nn_cache[key] = seg_sum(live.astype(jnp.int32))
        return nn_cache[key]

    for (fn, vals, valid), (vpos, vdpos) in zip(agg_specs, agg_slots):
        sv = sp(vpos, vals) if vals is not None else None
        svalid = sp(vdpos, valid) if valid is not None else None
        live = s_alive if svalid is None else (s_alive & svalid)
        # int32 prefix counts: nn is bounded by capacity (< 2^31); COUNT's
        # SQL LONG type is restored by the caller's output cast
        nn = live_count(live)
        if fn == "count":
            plan_ops.append(("count", nn, None))
        elif fn in ("sum", "avg"):
            contrib = jnp.where(live, sv, jnp.zeros((), sv.dtype))
            plan_ops.append((fn, nn, seg_sum(contrib)))
        elif fn in ("min", "max"):
            if jnp.issubdtype(sv.dtype, jnp.signedinteger) and \
                    sv.dtype.itemsize <= 4:
                sentinel = max_sentinel(jnp.int32) if fn == "min" \
                    else min_sentinel(jnp.int32)
                contrib = jnp.where(live, sv.astype(jnp.int32), sentinel)
                plan_ops.append(
                    (fn, nn,
                     _seg_minmax32(change, contrib, fn == "max").astype(
                         sv.dtype)))
            else:
                if fn == "min":
                    contrib = jnp.where(live, sv, max_sentinel(sv.dtype))
                    scat = jnp.full((capacity,), max_sentinel(sv.dtype),
                                    contrib.dtype).at[sid_safe].min(
                        contrib, mode="drop")
                else:
                    contrib = jnp.where(live, sv, min_sentinel(sv.dtype))
                    scat = jnp.full((capacity,), min_sentinel(sv.dtype),
                                    contrib.dtype).at[sid_safe].max(
                        contrib, mode="drop")
                slot_ops.append(scat)
                plan_ops.append((fn + "_slot", nn, len(slot_ops) - 1))
        else:
            raise ValueError(fn)

    slots_g = multi_gather(slot_ops, sid_safe) if slot_ops else []

    results = []
    for fn, nn, data in plan_ops:
        if fn == "count":
            data = nn
        elif fn == "avg":
            data = data.astype(jnp.float64) / jnp.maximum(nn, 1)
        elif fn.endswith("_slot"):  # wide min/max via slot gather
            data = slots_g[data]
        results.append((data, nn))

    # Group keys: any row of the segment holds the group's key values; the
    # occupied (last) rows are what callers read.
    out_keys = []
    out_valids = []
    for (cpos, vpos), col, valid in zip(key_slots, key_cols, key_valids):
        out_keys.append(sp(cpos, col))
        out_valids.append(sp(vpos, valid) if valid is not None else None)
    if want_rows:
        return out_keys, out_valids, last, n_groups, results, \
            sorted_ops[rows_pos]
    return out_keys, out_valids, last, n_groups, results


def sort_groupby_compact(key_cols, key_valids, agg_specs, alive,
                         packed_key=None, sort_subset=None):
    """sort_groupby + stable compaction of group rows to the front in
    key-sorted order: rows [0, n_groups) are live. Key-sorted placement makes
    outputs of *different* calls over the same key set positionally aligned
    (the DISTINCT-aggregate merge relies on this, mirroring the reference's
    distinctify tables, storage/AggregationOperationState.cpp)."""
    from quickstep_tpu.ops.kernels import compact_order, multi_gather
    out_keys, out_valids, mask, n_groups, results = sort_groupby(
        key_cols, key_valids, agg_specs, alive, packed_key=packed_key,
        sort_subset=sort_subset)
    order = compact_order(mask)
    flat = list(out_keys) + list(out_valids) + \
        [d for d, _ in results] + [nn for _, nn in results]
    g = multi_gather(flat, order)
    k = len(out_keys)
    r = len(results)
    out_keys_c = g[:k]
    out_valids_c = g[k:2 * k]
    datas_c = g[2 * k:2 * k + r]
    nns_c = g[2 * k + r:]
    return out_keys_c, out_valids_c, n_groups, \
        [(d, nn) for d, nn in zip(datas_c, nns_c)]


# ---------------------------------------------------------------------
# scalar (no group-by) aggregation — reference's single-state path
# (AggregationOperationState.hpp:223 aggregateBlockSingleState)
# ---------------------------------------------------------------------

def scalar_agg(fn: str, vals: Optional[jnp.ndarray],
               valid: Optional[jnp.ndarray], alive: jnp.ndarray):
    """Returns (result_scalar, non_null_count)."""
    live = alive if valid is None else (alive & valid)
    count = jnp.sum(live.astype(jnp.int64))
    if fn == "count":
        return count, count
    if fn in ("sum", "avg"):
        contrib = jnp.where(live, vals, jnp.zeros((), vals.dtype))
        s = jnp.sum(contrib)
        if fn == "sum":
            return s, count
        return s.astype(jnp.float64) / jnp.maximum(count, 1), count
    if fn == "min":
        return jnp.min(jnp.where(live, vals, max_sentinel(vals.dtype))), count
    if fn == "max":
        return jnp.max(jnp.where(live, vals, min_sentinel(vals.dtype))), count
    raise ValueError(fn)


def distinct_count(vals: jnp.ndarray, valid: Optional[jnp.ndarray],
                   alive: jnp.ndarray):
    """COUNT(DISTINCT x) without grouping: sort + boundary count."""
    live = alive if valid is None else (alive & valid)
    capacity = vals.shape[0]
    # Dead rows sort to the max sentinel; the first n_live sorted entries are the
    # live values (exact unless live data actually contains the sentinel value).
    k = jnp.where(live, vals, max_sentinel(vals.dtype))
    s = jnp.sort(k)
    n_live = jnp.sum(live.astype(jnp.int32))
    idx = jnp.arange(capacity)
    boundary = (idx == 0) | (s != jnp.roll(s, 1))
    return jnp.sum((boundary & (idx < n_live)).astype(jnp.int64))
