"""Logical-plan cache (prepared-statement analog): repeated
SELECTs skip resolve+optimize; any DDL/DML/command invalidates (plans embed
dictionary LIKE bitmaps, stats-driven join orders, SMA folds)."""

from quickstep_tpu import Database


def test_plan_cache_hit_and_invalidation():
    db = Database()
    db.execute("CREATE TABLE t (a INT, s VARCHAR(20))")
    db.execute("INSERT INTO t VALUES (1,'foo'), (2,'foobar'), (3,'bar')")
    q = "SELECT a FROM t WHERE s LIKE '%foo%' ORDER BY a"
    assert db.execute(q).rows == [(1,), (2,)]
    assert len(db.executor._logical_plan_cache) == 1
    cached = next(iter(db.executor._logical_plan_cache.values()))
    assert db.execute(q).rows == [(1,), (2,)]
    assert next(iter(db.executor._logical_plan_cache.values())) is cached
    # DML invalidates: new row must appear (stale bitmap would miss 'xfoox')
    db.execute("INSERT INTO t VALUES (4,'xfoox')")
    assert len(db.executor._logical_plan_cache) == 0
    assert db.execute(q).rows == [(1,), (2,), (4,)]


def test_plan_cache_keyed_by_config():
    db = Database()
    db.execute("CREATE TABLE t (a INT)")
    db.execute("INSERT INTO t VALUES (1), (2)")
    q = "SELECT SUM(a) FROM t"
    assert db.execute(q).rows == [(3,)]
    db.config.hbm_budget_bytes = 123456789   # planning-relevant knob
    assert db.execute(q).rows == [(3,)]
    assert len(db.executor._logical_plan_cache) == 2
