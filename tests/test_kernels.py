"""Unit tests: join/groupby/sort kernels vs numpy references
(reference storage/tests HashTable_unittest + AggregationOperationState_unittest
analog)."""

import numpy as np
import pytest

import jax.numpy as jnp

from quickstep_tpu.ops import join as J
from quickstep_tpu.ops import groupby as G
from quickstep_tpu.ops import sort as S
from quickstep_tpu.ops import kernels as K


def test_compact():
    mask = jnp.asarray([True, False, True, True, False])
    dest, count = K.compact_indices(mask)
    col = jnp.asarray([10, 20, 30, 40, 50])
    out = K.scatter_compact(col, dest, 5)
    assert int(count) == 3
    assert list(np.asarray(out)[:3]) == [10, 30, 40]


def test_direct_join():
    bkey = jnp.asarray([5, 9, 7, 0])
    table, dup = J.direct_build(bkey, jnp.asarray([True] * 4), 0, 10)
    assert not bool(dup)
    pkey = jnp.asarray([7, 8, 5, 0])
    bidx, matched = J.direct_probe(table, pkey, jnp.asarray([True] * 4), 0, 10)
    assert list(np.asarray(matched)) == [True, False, True, True]
    assert list(np.asarray(bidx)[[0, 2, 3]]) == [2, 0, 3]


def test_direct_join_dup_detect():
    bkey = jnp.asarray([5, 9, 5, 0])
    _, dup = J.direct_build(bkey, jnp.asarray([True] * 4), 0, 10)
    assert bool(dup)


def test_oa_join_composite():
    n = 64
    rng = np.random.default_rng(0)
    k1 = rng.integers(0, 1000, n)
    k2 = rng.integers(0, 1000, n)
    # make unique composite keys
    k1 = np.arange(n) * 3
    bkeys = [jnp.asarray(k1), jnp.asarray(k2)]
    table, dup = J.oa_build(bkeys, jnp.ones(n, bool), 256)
    assert not bool(dup)
    # probe with half-matching keys
    pk1 = jnp.asarray(np.concatenate([k1[:32], k1[:32] + 1]))
    pk2 = jnp.asarray(np.concatenate([k2[:32], k2[:32]]))
    bidx, matched = J.oa_probe(table, bkeys, [pk1, pk2], jnp.ones(64, bool))
    assert list(np.asarray(matched)[:32]) == [True] * 32
    assert list(np.asarray(bidx)[:32]) == list(range(32))
    assert not np.asarray(matched)[32:].any()


def test_oa_build_no_eviction_under_load():
    """Regression: collision-retry insertion must never scatter into an
    occupied slot (round-2 losers used to evict settled winners, silently
    losing build rows). High load factor + adversarial keys force multi-round
    collision chains; every build key must remain probe-able."""
    for n, tsize in [(100, 128), (120, 128), (64, 128), (100, 256)]:
        keys = jnp.asarray(np.arange(n, dtype=np.int64) * 7919 + 13)
        table, dup = J.oa_build([keys], jnp.ones(n, bool), tsize)
        assert not bool(dup)
        bidx, matched = J.oa_probe(table, [keys], [keys], jnp.ones(n, bool))
        assert bool(np.asarray(matched).all()), \
            f"lost {int((~np.asarray(matched)).sum())} of {n} keys at tsize {tsize}"
        assert list(np.asarray(bidx)) == list(range(n))


def test_expand_join():
    bkey = jnp.asarray([3, 1, 3, 3, 2, 9])
    skey, order = J.sorted_build(bkey, jnp.ones(6, bool))
    rows, counts = J.expand_probe(skey, order, jnp.asarray([3, 2, 7]),
                                  jnp.ones(3, bool), 4)
    assert list(np.asarray(counts)) == [3, 1, 0]
    # rows is flat row-major [n*K] (kept 1-D)
    got = sorted(int(r) for r in np.asarray(rows).reshape(3, 4)[0] if r >= 0)
    assert got == [0, 2, 3]


def test_dense_groupby():
    keys = jnp.asarray([1, 2, 1, 3, 2, 1])
    vals = jnp.asarray([10.0, 20.0, 30.0, 40.0, 50.0, 60.0])
    alive = jnp.asarray([True, True, True, True, True, False])
    idx = G.pack_dense_index([keys], [1], [1], 3, alive)
    occ, results = G.dense_groupby(
        idx, 3, [("sum", vals, None), ("count", None, None),
                 ("min", vals, None)], alive)
    (sums, _), (counts, _), (mins, _) = results
    assert list(np.asarray(occ)) == [True, True, True]
    assert list(np.asarray(sums)) == [40.0, 70.0, 40.0]
    assert list(np.asarray(counts)) == [2, 2, 1]
    assert list(np.asarray(mins)) == [10.0, 20.0, 40.0]


def test_sort_groupby_matches_dense():
    rng = np.random.default_rng(1)
    n = 200
    keys = rng.integers(0, 10, n)
    vals = rng.uniform(0, 100, n)
    alive = rng.random(n) < 0.8
    out_keys, _, occupied, n_groups, results = G.sort_groupby(
        [jnp.asarray(keys)], [None],
        [("sum", jnp.asarray(vals), None), ("count", None, None)],
        jnp.asarray(alive))
    ng = int(n_groups)
    occ = np.asarray(occupied)
    assert int(occ.sum()) == ng
    got = {}
    ks = np.asarray(out_keys[0])[occ]
    sums = np.asarray(results[0][0])[occ]
    cnts = np.asarray(results[1][0])[occ]
    for k, s, c in zip(ks, sums, cnts):
        got[int(k)] = (round(float(s), 6), int(c))
    expect = {}
    for k in np.unique(keys[alive]):
        m = alive & (keys == k)
        expect[int(k)] = (round(float(vals[m].sum()), 6), int(m.sum()))
    assert got == expect


def test_order_permutation_desc_nulls():
    keys = [jnp.asarray([3, 1, 2, 5])]
    valids = [jnp.asarray([True, True, False, True])]
    alive = jnp.ones(4, bool)
    # DESC with default NULLS LAST... SQL: desc -> nulls first default
    order = S.order_permutation(keys, valids, [False], [None], alive)
    ordered = list(np.asarray(order))
    # null (idx 2) first (desc default), then 5, 3, 1
    assert ordered == [2, 3, 0, 1]
    order = S.order_permutation(keys, valids, [False], [False], alive)
    assert list(np.asarray(order)) == [3, 0, 1, 2]


def test_scalar_agg_empty():
    vals = jnp.asarray([1.0, 2.0])
    alive = jnp.asarray([False, False])
    v, nn = G.scalar_agg("sum", vals, None, alive)
    assert int(nn) == 0


def test_distinct_count():
    vals = jnp.asarray([1, 2, 2, 3, 3, 3, 9])
    alive = jnp.asarray([True, True, True, True, True, True, False])
    assert int(G.distinct_count(vals, None, alive)) == 3


def test_merge_stats_probe():
    # build runs: key 3 -> vals {7, 2}(live) + 99(dead); key 5 -> {4};
    # key 8 -> only dead rows
    bkey = jnp.asarray([3, 5, 3, 3, 8], dtype=jnp.int64)
    bmask = jnp.asarray([True, True, True, False, False])
    bval = jnp.asarray([7, 4, 2, 99, 1], dtype=jnp.int32)
    pkey = jnp.asarray([3, 5, 8, 4, 3], dtype=jnp.int64)
    pmask = jnp.asarray([True, True, True, True, False])
    matched, mn, mx = J.merge_stats_probe(bkey, bmask, bval, pkey, pmask)
    assert list(np.asarray(matched)) == [True, True, False, False, False]
    assert int(mn[0]) == 2 and int(mx[0]) == 7
    assert int(mn[1]) == 4 and int(mx[1]) == 4


def test_merge_stats_probe_random():
    rng = np.random.default_rng(0)
    n, m = 5000, 4000
    bkey = rng.integers(0, 800, n)
    bval = rng.integers(-1000, 1000, m if False else n).astype(np.int32)
    bmask = rng.random(n) < 0.8
    pkey = rng.integers(0, 1000, m)
    pmask = rng.random(m) < 0.9
    matched, mn, mx = J.merge_stats_probe(
        jnp.asarray(bkey, jnp.int64), jnp.asarray(bmask),
        jnp.asarray(bval), jnp.asarray(pkey, jnp.int64), jnp.asarray(pmask))
    matched, mn, mx = (np.asarray(matched), np.asarray(mn), np.asarray(mx))
    for i in range(m):
        sel = bval[(bkey == pkey[i]) & bmask]
        want = pmask[i] and sel.size > 0
        assert bool(matched[i]) == want, i
        if want:
            assert mn[i] == sel.min() and mx[i] == sel.max(), i


@pytest.mark.parametrize("op", ["<>", "<", "<=", ">", ">="])
def test_merge_cmp_probe(op):
    rng = np.random.default_rng(3)
    n, m = 3000, 2500
    bkey = rng.integers(0, 500, n)
    bval = rng.integers(-50, 50, n).astype(np.int32)
    bmask = rng.random(n) < 0.8
    pkey = rng.integers(0, 600, m)
    pval = rng.integers(-50, 50, m).astype(np.int32)
    pmask = rng.random(m) < 0.9
    got = np.asarray(J.merge_cmp_probe(
        jnp.asarray(bkey, jnp.int32), jnp.asarray(bmask), jnp.asarray(bval),
        jnp.asarray(pkey, jnp.int32), jnp.asarray(pmask), jnp.asarray(pval),
        op))
    import operator
    fn = {"<>": operator.ne, "<": operator.lt, "<=": operator.le,
          ">": operator.gt, ">=": operator.ge}[op]
    for i in range(m):
        sel = bval[(bkey == pkey[i]) & bmask]
        want = bool(pmask[i]) and bool(np.any(fn(pval[i], sel)))
        assert bool(got[i]) == want, (i, op)


@pytest.mark.parametrize("limit,packed", [(768, True), (767, False)])
def test_multi_gather_footprint(monkeypatch, limit, packed):
    """An [n, k] row pack occupies n*k*itemsize bytes on the GPU (no lane
    pad): under PACK_PAD_LIMIT it is one row gather, above it one 1-D gather
    per column — same values either way."""
    n, k = 64, 3
    cols = [jnp.arange(n, dtype=jnp.int32) * (j + 1) for j in range(k)]
    idx = jnp.asarray([5, 0, 63, 7], jnp.int32)
    assert K.pack_bytes(n, k, jnp.int32) == n * k * 4 == 768
    monkeypatch.setattr(K, "PACK_PAD_LIMIT", limit)
    K.reset_trace()
    out = K.multi_gather(cols, idx)
    assert K.TRACE["gathers"] == (1 if packed else k)
    for j in range(k):
        np.testing.assert_array_equal(np.asarray(out[j]),
                                      np.asarray(idx) * (j + 1))
