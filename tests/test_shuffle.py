"""Key-partitioned (radix all_to_all) shuffle-join tests on the 8-device CPU mesh.

Covers that a large-large sharded join must plan a
shuffle (no build-side replication), match single-device rows, and survive
heavy-hitter key skew (salting / bucket escalation). Reference analog:
query_optimizer/rules/Partition.hpp:45-87 + PartitionedHashTablePool.hpp:49.
"""

import numpy as np
import pytest

from quickstep_tpu import Database
from quickstep_tpu.config import Config


def _mk(distributed: bool) -> Database:
    cfg = Config()
    cfg.distributed = distributed
    # force both sides over the replicate threshold so the planner must shuffle
    cfg.replicate_threshold_rows = 64
    db = Database(config=cfg)
    return db


def _fill(db: Database, rows_l, rows_r):
    db.execute("CREATE TABLE lt (k INT NOT NULL, v INT NOT NULL)")
    db.execute("CREATE TABLE rt (k INT NOT NULL, w INT NOT NULL)")
    db.execute("INSERT INTO lt VALUES " +
               ", ".join(f"({k}, {v})" for k, v in rows_l))
    db.execute("INSERT INTO rt VALUES " +
               ", ".join(f"({k}, {w})" for k, w in rows_r))
    db.execute("\\analyze")


def _pairs(seed, n, key_hi, skew_key=None, skew_frac=0.0):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, key_hi, n)
    if skew_key is not None:
        hot = rng.random(n) < skew_frac
        keys = np.where(hot, skew_key, keys)
    vals = rng.integers(0, 1000, n)
    return list(zip(keys.tolist(), vals.tolist()))


@pytest.fixture(scope="module")
def meshes():
    import jax
    if len(jax.devices()) < 2:
        pytest.skip("needs a multi-device mesh")
    return True


def _run_both(rows_l, rows_r, sql):
    single = _mk(False)
    _fill(single, rows_l, rows_r)
    dist = _mk(True)
    _fill(dist, rows_l, rows_r)
    assert dist.executor.mesh is not None
    a = sorted(single.execute(sql).rows)
    b = sorted(dist.execute(sql).rows)
    return a, b


def test_shuffle_unique_join(meshes):
    # unique build side (PK): shuffled inner join matches
    rows_l = _pairs(0, 2000, 500)
    rows_r = [(k, k * 7) for k in range(500)]
    a, b = _run_both(rows_l, rows_r,
                     "SELECT lt.v, rt.w FROM lt, rt WHERE lt.k = rt.k")
    assert a == b and len(a) == 2000


def test_shuffle_manymany_join(meshes):
    # duplicate keys on both sides: expansion join under shuffle
    rows_l = _pairs(1, 1000, 50)
    rows_r = _pairs(2, 600, 50)
    a, b = _run_both(
        rows_l, rows_r,
        "SELECT lt.k, lt.v, rt.w FROM lt, rt WHERE lt.k = rt.k")
    assert a == b and len(a) > 1000


def test_shuffle_skewed_join(meshes):
    # 40% of probe rows share one hot key: salting/bucket escalation must
    # still produce exact rows
    rows_l = _pairs(3, 2000, 400, skew_key=7, skew_frac=0.4)
    rows_r = _pairs(4, 300, 400)
    a, b = _run_both(
        rows_l, rows_r,
        "SELECT lt.k, lt.v, rt.w FROM lt, rt WHERE lt.k = rt.k")
    assert a == b


def test_shuffle_semi_anti(meshes):
    rows_l = _pairs(5, 1500, 300)
    rows_r = _pairs(6, 400, 150)
    a, b = _run_both(
        rows_l, rows_r,
        "SELECT v FROM lt WHERE k IN (SELECT k FROM rt)")
    assert a == b
    a, b = _run_both(
        rows_l, rows_r,
        "SELECT v FROM lt WHERE k NOT IN (SELECT k FROM rt)")
    assert a == b


def test_shuffle_left_join(meshes):
    rows_l = _pairs(7, 1200, 600)
    rows_r = [(k, k + 1) for k in range(0, 600, 3)]
    a, b = _run_both(
        rows_l, rows_r,
        "SELECT lt.k, lt.v, rt.w FROM lt LEFT OUTER JOIN rt ON lt.k = rt.k")
    assert a == b and len(a) == 1200


def test_shuffle_plans_no_replication(meshes):
    """The shuffle path (not broadcast) actually runs: the radix exchange
    always reports its (possibly False) overflow flag."""
    rows_l = _pairs(8, 1000, 200)
    rows_r = _pairs(9, 500, 200)
    dist = _mk(True)
    _fill(dist, rows_l, rows_r)
    dist.execute("SELECT lt.v, rt.w FROM lt, rt WHERE lt.k = rt.k")
    assert any(k.startswith("shuffle_overflow")
               for k in dist.executor.last_flags), \
        "large-large join did not take the shuffle path"


def test_overlap_chunked_matches_sync(meshes):
    """Exchange/compute overlap (chunked probe exchange): chunked and
    synchronous shuffles produce identical rows, and the chunked program
    really contains one probe all-to-all per chunk (the dependence structure
    XLA's latency-hiding scheduler overlaps with the per-chunk join)."""
    rows_l = _pairs(10, 2000, 300)
    rows_r = _pairs(11, 800, 300)
    sql = "SELECT lt.k, lt.v, rt.w FROM lt, rt WHERE lt.k = rt.k"

    sync = _mk(True)
    sync.config.shuffle_overlap_chunks = 1
    _fill(sync, rows_l, rows_r)
    a = sorted(sync.execute(sql).rows)

    over = _mk(True)
    over.config.shuffle_overlap_chunks = 4
    _fill(over, rows_l, rows_r)
    b = sorted(over.execute(sql).rows)
    assert any(k.startswith("shuffle_overflow")
               for k in over.executor.last_flags)
    assert a == b


def test_preshuffle_lip_filter_shrinks_exchange(meshes):
    """Distributed AttachLIPFilters analog: a build-side bloom probed BEFORE
    the all_to_all lets a selective join ship smaller probe buckets (fewer
    exchanged bytes), with identical rows."""
    from quickstep_tpu.exec.runner import PlanRunner
    # probe keys span 0..9999 but the build side only covers 0..99: the
    # range-based pass estimate is ~1%, floored to 1/8 of the sync cap
    rows_l = _pairs(12, 4000, 10000)
    rows_r = [(k, k * 2) for k in range(100)]
    sql = "SELECT lt.v, rt.w FROM lt, rt WHERE lt.k = rt.k"

    base = _mk(True)
    base.config.use_lip_filters = False
    _fill(base, rows_l, rows_r)
    a = sorted(base.execute(sql).rows)
    rows_nofilter = PlanRunner.trace_shuffle_info["probe_bucket_rows"]
    assert PlanRunner.trace_shuffle_info["lip_bits"] == 0

    lip = _mk(True)
    _fill(lip, rows_l, rows_r)
    b = sorted(lip.execute(sql).rows)
    info = PlanRunner.trace_shuffle_info
    assert info["lip_bits"] > 0
    assert info["probe_bucket_rows"] < rows_nofilter, info
    assert a == b
