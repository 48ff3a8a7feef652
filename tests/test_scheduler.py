"""Scheduler tests: PolicyEnforcer admission/fairness, ExecutionStats window,
ProbabilityStore (reference query_execution/tests/{PolicyEnforcer-adjacent,
ExecutionStats via Foreman, ProbabilityStore_unittest.cpp} analogs)."""

import threading
import time

import pytest

from quickstep_tpu.exec.scheduler import (ExecutionStats, PolicyEnforcer,
                                          ProbabilityStore)


def test_execution_stats_window():
    s = ExecutionStats(max_entries=3)
    for ms in (10.0, 20.0, 30.0, 40.0):
        s.add_entry("select", ms)
    total, n = s.stats("select")
    assert n == 3 and total == 90.0          # oldest (10.0) evicted
    assert s.average("select") == 30.0
    assert s.stats("missing") == (0.0, 0)
    assert s.average("missing") is None
    assert s.operators() == ["select"]


def test_probability_store():
    ps = ProbabilityStore()
    ps.add_or_update(1, 1.0)
    ps.add_or_update(2, 3.0)
    assert ps.probability(1) == pytest.approx(0.25)
    assert ps.probability(2) == pytest.approx(0.75)
    assert ps.pick_random(0.1) == 1
    assert ps.pick_random(0.9) == 2
    ps.remove(1)
    assert ps.probability(2) == pytest.approx(1.0)
    assert ps.probability(1) == 0.0
    ps.remove(2)
    with pytest.raises(KeyError):
        ps.pick_random(0.5)


def test_policy_enforcer_serializes_and_returns_results():
    log = []

    def exec_fn(sql):
        log.append(sql)
        return f"result:{sql}"

    pe = PolicyEnforcer(exec_fn, max_concurrent_queries=4)
    try:
        results = [None] * 8
        threads = [threading.Thread(
            target=lambda i=i: results.__setitem__(
                i, pe.submit(f"q{i}", session=f"s{i % 2}")))
            for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert sorted(results) == [f"result:q{i}" for i in range(8)]
        assert sorted(log) == [f"q{i}" for i in range(8)]
        total, n = pe.stats.stats("query")
        assert n == 8
    finally:
        pe.shutdown()


def test_policy_enforcer_priority_order():
    """While one query occupies the executor, higher-priority later arrivals
    are dispatched before lower-priority earlier ones."""
    started = []
    gate = threading.Event()

    def exec_fn(sql):
        if sql == "blocker":
            gate.wait(5)
        started.append(sql)
        return sql

    pe = PolicyEnforcer(exec_fn, max_concurrent_queries=8)
    try:
        tb = threading.Thread(target=lambda: pe.submit("blocker"))
        tb.start()
        time.sleep(0.15)                     # blocker is now executing
        tlo = threading.Thread(target=lambda: pe.submit("low", priority=0))
        tlo.start()
        time.sleep(0.05)                     # low arrives first
        thi = threading.Thread(target=lambda: pe.submit("high", priority=5))
        thi.start()
        time.sleep(0.05)
        gate.set()
        for t in (tb, tlo, thi):
            t.join()
        assert started == ["blocker", "high", "low"]
    finally:
        pe.shutdown()


def test_policy_enforcer_propagates_errors():
    def exec_fn(sql):
        raise ValueError(f"bad: {sql}")

    pe = PolicyEnforcer(exec_fn)
    try:
        with pytest.raises(ValueError, match="bad: q"):
            pe.submit("q")
    finally:
        pe.shutdown()


def test_network_server_concurrent_clients():
    """Concurrent clients through the network server route via the
    PolicyEnforcer and all get correct results."""
    from quickstep_tpu import Database
    from quickstep_tpu.cli.network import QueryClient, QueryServer

    db = Database()
    db.execute("CREATE TABLE t (a INT NOT NULL)")
    db.execute("INSERT INTO t VALUES (1), (2), (3), (4)")
    server = QueryServer(db, port=0, max_concurrent_queries=4)
    # the server shares the Database's enforcer, which also saw the two
    # setup statements above
    base_n = server.enforcer.stats.stats("query")[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        results = [None] * 6

        def worker(i):
            c = QueryClient("127.0.0.1", server.port)
            resp = c.query(f"SELECT sum(a) + {i} AS s FROM t")
            results[i] = resp["rows"][0][0]
            c.close()

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(6)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        assert results == [10 + i for i in range(6)]
        total, n = server.enforcer.stats.stats("query")
        assert n == base_n + 6
    finally:
        server.shutdown()


def test_embedded_api_routes_through_policy_enforcer():
    """The embedded Database.execute path must go through the
    PolicyEnforcer (reference: every query passes the Foreman/PolicyEnforcer,
    query_execution/PolicyEnforcerSingleNode.cpp:42-56). Two sessions issue
    queries concurrently; all succeed, are serialized by the single dispatch
    thread, and the enforcer's stats see every query."""
    import threading
    from quickstep_tpu import Database

    db = Database()
    db.execute("CREATE TABLE pe (a INT)")
    db.execute("INSERT INTO pe VALUES (1), (2), (3)")
    base_queries = db.policy_enforcer.stats.stats("query")[1]

    results = {}

    def run(session):
        rows = []
        for _ in range(5):
            r = db.execute("SELECT count(*) FROM pe", session=session)
            rows.append(r.rows[0][0])
        results[session] = rows

    threads = [threading.Thread(target=run, args=(f"s{i}",)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert all(v == [3] * 5 for v in results.values())
    assert db.policy_enforcer.stats.stats("query")[1] == base_queries + 15


def test_with_priority_clause_feeds_enforcer():
    """A SELECT ... WITH PRIORITY = n statement carries its priority into the
    enforcer (ParsePriority.hpp analog)."""
    from quickstep_tpu import Database
    from quickstep_tpu.parser import parse_one

    s = parse_one("SELECT a FROM t WITH PRIORITY = 7")
    assert s.priority == 7
    db = Database()
    db.execute("CREATE TABLE t (a INT)")
    db.execute("INSERT INTO t VALUES (42)")
    r = db.execute("SELECT a FROM t WITH PRIORITY = 7")
    assert r.rows == [(42,)]


def test_segment_granular_interleave():
    """A short query from another session completes WHILE a long streamed
    query is mid-flight: the streamed executor yields to
    the PolicyEnforcer between segments."""
    import numpy as np
    import threading
    import time
    from quickstep_tpu import Database
    db = Database()
    n = 400_000
    rng = np.random.default_rng(8)
    db.execute("CREATE TABLE big3 (k INT NOT NULL, v INT NOT NULL)")
    rel = db.catalog.default_database.get_relation("big3")
    from quickstep_tpu.storage.column import Column
    from quickstep_tpu.storage.table import TableData
    from quickstep_tpu.types import INT
    rel.set_data(TableData({
        "k": Column(INT, rng.integers(0, 50, n).astype(np.int32), None, None),
        "v": Column(INT, rng.integers(0, 100, n).astype(np.int32), None,
                    None)}))
    rel.analyze()
    db.execute("CREATE TABLE small (a INT NOT NULL)")
    db.execute("INSERT INTO small VALUES (1), (2), (3)")
    db.config.hbm_budget_bytes = 128 * 1024   # many segments
    finish_times = {}
    long_running = threading.Event()

    orig_yield = db.executor.segment_yield
    def traced_yield():
        long_running.set()
        orig_yield()
    db.executor.segment_yield = traced_yield

    def run_long():
        db.execute("SELECT k, sum(v) FROM big3 GROUP BY k ORDER BY k",
                   session="long")
        finish_times["long"] = time.perf_counter()

    def run_short():
        long_running.wait(10)   # only submit once the long query is streaming
        db.execute("SELECT count(*) FROM small", session="short")
        finish_times["short"] = time.perf_counter()

    t1 = threading.Thread(target=run_long)
    t2 = threading.Thread(target=run_short)
    t1.start(); t2.start()
    t1.join(60); t2.join(60)
    assert "short" in finish_times and "long" in finish_times
    assert finish_times["short"] < finish_times["long"], finish_times
