"""Window aggregation kernels.

Device-side successor of the reference's window aggregates
(expressions/window_aggregation/WindowAggregationHandle*, executed sequentially in ONE
WorkOrder over the whole relation — WindowAggregationOperator.cpp:37-52). Here the
whole computation is vectorized: sort rows by (partition, order) keys, run a segmented
prefix scan (associative_scan with segment-reset flags), pick the frame value per row,
and scatter results back to original row positions. No sequential pass anywhere.

Supported frames:
- no ORDER BY            -> whole partition (UNBOUNDED PRECEDING..UNBOUNDED FOLLOWING)
- ORDER BY, no frame     -> RANGE UNBOUNDED PRECEDING..CURRENT ROW (peers included)
- ROWS BETWEEN a PRECEDING|UNBOUNDED AND b FOLLOWING|CURRENT   (all five aggs)
- RANGE BETWEEN a PRECEDING|UNBOUNDED AND b FOLLOWING|CURRENT  (all five aggs;
  single numeric ORDER BY key, value-offset bounds found by a vectorized
  lexicographic binary search; MIN/MAX answered by a segmented sparse table)
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp

from quickstep_tpu.ops.kernels import max_sentinel, min_sentinel


def _lex_searchsorted(seg_sorted, val_sorted, qseg, qval, side: str):
    """Vectorized binary search for (qseg, qval) in rows sorted by
    (segment, value) — jnp.searchsorted has no lexicographic form."""
    n = seg_sorted.shape[0]
    lo = jnp.zeros(qseg.shape, jnp.int32)
    hi = jnp.full(qseg.shape, n, jnp.int32)
    for _ in range(max(1, math.ceil(math.log2(max(n, 2))) + 1)):
        mid = (lo + hi) // 2
        safe = jnp.minimum(mid, n - 1)
        ms = seg_sorted[safe]
        mv = val_sorted[safe]
        if side == "left":
            go_right = (ms < qseg) | ((ms == qseg) & (mv < qval))
        else:
            go_right = (ms < qseg) | ((ms == qseg) & (mv <= qval))
        lo = jnp.where(go_right, mid + 1, lo)
        hi = jnp.where(go_right, hi, mid)
    return lo


def _range_query_minmax(c, lo, hi, is_min):
    """Per-row [lo, hi] range min/max over c via a sparse table (log2(n) levels,
    each the pairwise combine at stride 2^k); empty windows (hi < lo) yield the
    sentinel."""
    n = c.shape[0]
    sent = max_sentinel(c.dtype) if is_min else min_sentinel(c.dtype)
    op = jnp.minimum if is_min else jnp.maximum
    levels = [c]
    k = 1
    while k < n:
        prev = levels[-1]
        pad = jnp.full((min(k, n),), sent, c.dtype)
        shifted = jnp.concatenate([prev[k:], pad])[:n]
        levels.append(op(prev, shifted))
        k *= 2
    table = jnp.stack(levels)                      # [log, n]
    length = jnp.maximum(hi - lo + 1, 1)
    j = (63 - jax.lax.clz(length.astype(jnp.int64))).astype(jnp.int32)
    pow_j = (jnp.int64(1) << j.astype(jnp.int64)).astype(jnp.int32)
    a = table[j, jnp.clip(lo, 0, n - 1)]
    b = table[j, jnp.clip(hi - pow_j + 1, 0, n - 1)]
    res = op(a, b)
    return jnp.where(hi < lo, sent, res)


def _segmented_scan(vals: jnp.ndarray, seg_start: jnp.ndarray, combine):
    """Inclusive segmented prefix scan: resets at rows where seg_start is
    True. Implemented WITHOUT jax.lax.associative_scan (its custom-combine
    form compiled for hours on the earlier accelerator): sums are
    a native cumsum minus the prefix gathered at each segment's start row
    (cummax-forward-filled, so the index is monotone); min/max are a
    range query from the segment start via the doubling sparse table."""
    n = vals.shape[0]
    iota = jnp.arange(n, dtype=jnp.int32)
    start_row = jax.lax.cummax(jnp.where(seg_start, iota, -1))
    if combine is jnp.add:
        S = jnp.cumsum(vals)
        base_idx = jnp.clip(start_row - 1, 0, n - 1)
        base = jnp.where(start_row <= 0, jnp.zeros((), S.dtype), S[base_idx])
        return S - base
    is_min = combine is jnp.minimum
    return _range_query_minmax(vals, jnp.clip(start_row, 0, n - 1), iota,
                               is_min)


def window_aggregate(
        part_keys: List[jnp.ndarray],
        order_keys: List[jnp.ndarray],
        order_desc: List[bool],
        fn: str,
        vals: Optional[jnp.ndarray],
        valid: Optional[jnp.ndarray],
        alive: jnp.ndarray,
        frame: Optional[Tuple[str, Optional[int], Optional[int]]]):
    """Returns (result array aligned with input rows, result_valid or None).

    frame: None for defaults, else (mode, start, end) where start=None means
    UNBOUNDED PRECEDING else the preceding offset; end=None means UNBOUNDED
    FOLLOWING else the following offset (0 = CURRENT ROW). mode: 'rows'|'range'.
    """
    n = alive.shape[0]
    # ---- sort by (aliveness, partition, order) ----
    okeys = []
    for k, desc in zip(order_keys, order_desc):
        okeys.append(jnp.invert(k) if (desc and not jnp.issubdtype(
            k.dtype, jnp.floating)) else (-k if desc else k))
    lex = tuple(reversed([*part_keys, *okeys])) + ((~alive).astype(jnp.int8),)
    order = jnp.lexsort(lex)
    s_alive = alive[order]
    idx = jnp.arange(n)
    seg_start = (idx == 0)
    for k in part_keys:
        sk = k[order]
        seg_start = seg_start | (sk != jnp.roll(sk, 1))
    seg_start = seg_start | (~s_alive & jnp.roll(s_alive, 1))

    s_vals = vals[order] if vals is not None else jnp.ones(n, jnp.int64)
    s_valid = valid[order] if valid is not None else None
    live = s_alive if s_valid is None else (s_alive & s_valid)

    contrib_sum = jnp.where(live, s_vals, jnp.zeros((), s_vals.dtype))
    contrib_cnt = live.astype(jnp.int64)

    seg_ids = jnp.cumsum(seg_start.astype(jnp.int32)) - 1

    if not order_keys and frame is None:
        # whole-partition aggregate broadcast to every row
        total = _seg_total(fn, contrib_sum, contrib_cnt, s_vals, live, seg_ids, n)
        res_sorted, nn_sorted = total
    elif frame is None or (frame[0] == "range" and frame[1] is None and
                           frame[2] == 0):
        # RANGE UNBOUNDED..CURRENT: prefix value at last peer row
        res_sorted, nn_sorted = _prefix_to_peers(
            fn, contrib_sum, contrib_cnt, s_vals, live, seg_start, order,
            order_keys, n)
    elif frame[0] in ("rows", "range"):
        idx = jnp.arange(n)
        seg_first = jnp.full(n, n, jnp.int32).at[seg_ids].min(
            idx.astype(jnp.int32), mode="drop")[seg_ids]
        seg_last = jnp.zeros(n, jnp.int32).at[seg_ids].max(
            idx.astype(jnp.int32), mode="drop")[seg_ids]
        _, start, end = frame
        if frame[0] == "rows":
            lo = seg_first if start is None else \
                jnp.maximum(seg_first, idx.astype(jnp.int32) - start)
            hi = seg_last if end is None else \
                jnp.minimum(seg_last, idx.astype(jnp.int32) + end)
        else:
            # RANGE offsets apply to the FIRST order key (the reference's
            # window handles accept secondary keys as tie-breakers); rows
            # sorted by (part, k1, k2) are also sorted by (part, k1), so the
            # lex-searchsorted bounds below stay valid.
            # For DESC keys the sort key was order-reversed by an affine
            # negation, under which [v'-a, v'+b] is exactly the SQL window
            # (PRECEDING = larger original values) — no offset swap needed.
            sv = okeys[0][order]
            if jnp.issubdtype(sv.dtype, jnp.integer):
                # merge_starts instead of binary search: _lex_searchsorted's
                # log2(n) rounds of full random-gather passes are the same
                # cliff the joins fell off (ops/join.py merge_starts
                # rationale); pack (segment, value) into one int64 key —
                # value field gets 34 bits so q = v ± offset can't cross a
                # segment — and resolve BOTH bounds in one concat sort.
                bias = (jnp.int64(1) << 31) - jnp.int64(
                    jnp.iinfo(jnp.int32).min)
                seg64 = seg_ids.astype(jnp.int64)
                v64 = sv.astype(jnp.int64) + bias          # [2^31, ~2^33)
                packed = (seg64 << 34) + v64
                qs = []
                if start is not None:
                    qs.append((seg64 << 34) + (v64 - start))
                if end is not None:
                    qs.append((seg64 << 34) + (v64 + end))
                from quickstep_tpu.ops.join import merge_starts
                st, cnt = merge_starts(packed, jnp.concatenate(qs)
                                       if len(qs) > 1 else qs[0])
                pos = 0
                if start is None:
                    lo = seg_first
                else:
                    lo = st[pos * n:(pos + 1) * n].astype(jnp.int32)
                    pos += 1
                if end is None:
                    hi = seg_last
                else:
                    hi = (st[pos * n:(pos + 1) * n] +
                          cnt[pos * n:(pos + 1) * n] - 1).astype(jnp.int32)
            else:
                lo = seg_first if start is None else _lex_searchsorted(
                    seg_ids, sv, seg_ids, sv - start,
                    "left").astype(jnp.int32)
                hi = seg_last if end is None else (_lex_searchsorted(
                    seg_ids, sv, seg_ids, sv + end,
                    "right") - 1).astype(jnp.int32)
        hi = jnp.maximum(hi, lo - 1)   # empty window
        res_sorted, nn_sorted = _eval_frame(
            fn, contrib_sum, contrib_cnt, s_vals, live, lo, hi,
            is_start=(idx.astype(jnp.int32) == seg_first))
    else:
        raise NotImplementedError(f"window frame {frame}")

    # ---- scatter back to original positions ----
    inv = jnp.zeros(n, jnp.int32).at[order].set(jnp.arange(n, dtype=jnp.int32))
    res = res_sorted[inv]
    nn = nn_sorted[inv] if nn_sorted is not None else None
    if fn == "count":
        return res, None
    return res, (nn > 0) if nn is not None else None


def _seg_total(fn, contrib_sum, contrib_cnt, s_vals, live, seg_ids, n):
    cnts = jax.ops.segment_sum(contrib_cnt, seg_ids, num_segments=n)
    if fn == "count":
        return cnts[seg_ids], cnts[seg_ids]
    if fn in ("sum", "avg"):
        sums = jax.ops.segment_sum(contrib_sum, seg_ids, num_segments=n)
        if fn == "sum":
            return sums[seg_ids], cnts[seg_ids]
        return (sums[seg_ids].astype(jnp.float64) /
                jnp.maximum(cnts[seg_ids], 1)), cnts[seg_ids]
    if fn == "min":
        c = jnp.where(live, s_vals, max_sentinel(s_vals.dtype))
        m = jax.ops.segment_min(c, seg_ids, num_segments=n)
        return m[seg_ids], cnts[seg_ids]
    c = jnp.where(live, s_vals, min_sentinel(s_vals.dtype))
    m = jax.ops.segment_max(c, seg_ids, num_segments=n)
    return m[seg_ids], cnts[seg_ids]


def _prefix_to_peers(fn, contrib_sum, contrib_cnt, s_vals, live, seg_start,
                     order, order_keys, n):
    idx = jnp.arange(n)
    # inclusive prefix within segment
    if fn in ("sum", "avg", "count"):
        psum = _segmented_scan(contrib_sum, seg_start, jnp.add)
        pcnt = _segmented_scan(contrib_cnt, seg_start, jnp.add)
    elif fn == "min":
        c = jnp.where(live, s_vals, max_sentinel(s_vals.dtype))
        psum = _segmented_scan(c, seg_start, jnp.minimum)
        pcnt = _segmented_scan(contrib_cnt, seg_start, jnp.add)
    else:
        c = jnp.where(live, s_vals, min_sentinel(s_vals.dtype))
        psum = _segmented_scan(c, seg_start, jnp.maximum)
        pcnt = _segmented_scan(contrib_cnt, seg_start, jnp.add)
    # peer groups: rows with equal (segment, order keys)
    peer_start = seg_start
    for k in order_keys:
        sk = k[order]
        peer_start = peer_start | (sk != jnp.roll(sk, 1)) | (idx == 0)
    peer_ids = jnp.cumsum(peer_start.astype(jnp.int32)) - 1
    # last row index of each peer group
    last_of_peer = jnp.zeros(n, jnp.int32).at[peer_ids].max(
        idx.astype(jnp.int32), mode="drop")
    take = last_of_peer[peer_ids]
    res = psum[take]
    cnt = pcnt[take]
    if fn == "count":
        return cnt, cnt
    if fn == "avg":
        return res.astype(jnp.float64) / jnp.maximum(cnt, 1), cnt
    return res, cnt


def _sliding_float_sums(contrib, lo, hi, is_start):
    """Per-row frame sums with the reference's exact rounding: a running sum
    slides over the partition, applying fl(sub) for each row leaving the
    window and fl(add) for each row entering (in index order). Sequential by
    construction (lax.scan with bounded inner loops); only used for
    float-typed bounded frames, which are always presentation-sized."""
    n = contrib.shape[0]
    end = hi + 1                       # exclusive
    prev_lo = jnp.concatenate([lo[:1], lo[:-1]])
    prev_end = jnp.concatenate([lo[:1], end[:-1]])
    if is_start is None:
        is_start = jnp.zeros((n,), bool).at[0].set(True)
    max_sub = jnp.max(jnp.maximum(lo - prev_lo, 0))
    max_add = jnp.max(jnp.maximum(end - jnp.minimum(prev_end, end), 0))

    def step(ssum, xs):
        lo_i, end_i, plo, pend, start = xs
        ssum = jnp.where(start, jnp.zeros((), contrib.dtype), ssum)
        plo = jnp.where(start, lo_i, plo)
        pend = jnp.where(start, lo_i, pend)

        def sub_body(k, s):
            j = plo + k
            v = contrib[jnp.clip(j, 0, n - 1)]
            return jnp.where(j < lo_i, s - v, s)

        ssum = jax.lax.fori_loop(0, max_sub, sub_body, ssum)

        def add_body(k, s):
            j = pend + k
            v = contrib[jnp.clip(j, 0, n - 1)]
            return jnp.where((j >= lo_i) & (j < end_i), s + v, s)

        ssum = jax.lax.fori_loop(0, max_add, add_body, ssum)
        return ssum, ssum

    _, sums = jax.lax.scan(
        step, jnp.zeros((), contrib.dtype),
        (lo, end, prev_lo, prev_end, is_start))
    return sums


def _eval_frame(fn, contrib_sum, contrib_cnt, s_vals, live, lo, hi,
                is_start=None):
    """Aggregate over per-row inclusive index windows [lo, hi] (already clipped
    to segment bounds): prefix-sum differences for SUM/COUNT/AVG, sparse-table
    range queries for MIN/MAX."""
    if fn in ("min", "max"):
        is_min = fn == "min"
        sent = max_sentinel(s_vals.dtype) if is_min else \
            min_sentinel(s_vals.dtype)
        c = jnp.where(live, s_vals, sent)
        m = _range_query_minmax(c, lo, hi, is_min)
        pcnt = jnp.cumsum(contrib_cnt)
        cnt = pcnt[jnp.maximum(hi, 0)] - jnp.where(
            lo > 0, pcnt[jnp.maximum(lo - 1, 0)], jnp.zeros((), pcnt.dtype))
        cnt = jnp.where(hi < lo, jnp.zeros((), cnt.dtype), cnt)
        return m, cnt
    pcnt = jnp.cumsum(contrib_cnt)

    def rangesum(p, c):
        total = p[jnp.maximum(hi, 0)]
        below = jnp.where(lo > 0, p[jnp.maximum(lo - 1, 0)],
                          jnp.zeros((), c.dtype))
        return jnp.where(hi < lo, jnp.zeros((), c.dtype), total - below)

    if jnp.issubdtype(contrib_sum.dtype, jnp.floating):
        # Bit-exact emulation of the reference's SLIDING window
        # (WindowAggregationHandleAvg.cpp:119-161: one running sum per
        # partition, values subtracted as they leave the window and added as
        # they enter) — prefix-sum differences round differently in the last
        # float ulps, which the byte-exact golden corpus catches.
        s = _sliding_float_sums(contrib_sum, lo, hi, is_start)
    else:
        psum = jnp.cumsum(contrib_sum)
        s = rangesum(psum, contrib_sum)
    c = rangesum(pcnt, contrib_cnt)
    if fn == "count":
        return c, c
    if fn == "avg":
        return s.astype(jnp.float64) / jnp.maximum(c, 1), c
    return s, c
