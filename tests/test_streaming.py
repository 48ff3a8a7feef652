"""Out-of-core streamed execution (>HBM working sets) + SMA segment pruning.

Reference capability: the buffer pool runs data sets larger than RAM
(storage/StorageManager.hpp:84, README.md:8); SMA indexes skip blocks whose
min/max cannot satisfy the predicate (storage/SMAIndexSubBlock.hpp:181).
Here: a tiny hbm_budget_bytes forces segment streaming; results must match
the unconstrained run."""

import numpy as np
import pytest

from quickstep_tpu import Database
from quickstep_tpu.config import Config


def _mkdb(budget=0):
    cfg = Config()
    cfg.display_timing = False
    cfg.hbm_budget_bytes = budget
    db = Database(config=cfg)
    db.execute("CREATE TABLE dim (k INT NOT NULL, name VARCHAR(8) NOT NULL)")
    db.execute("INSERT INTO dim VALUES " + ", ".join(
        f"({k}, 'd{k % 5}')" for k in range(1, 17)))
    db.execute("CREATE TABLE big (k INT NOT NULL, g INT NOT NULL, "
               "v DOUBLE NOT NULL, seq INT NOT NULL)")
    rows = []
    x = 7
    for i in range(20000):
        x = (x * 1103515245 + 12345) % (1 << 31)
        rows.append(f"({1 + x % 16}, {x % 3}, {(x % 1000) / 10.0}, {i})")
        if len(rows) == 5000:
            db.execute("INSERT INTO big VALUES " + ", ".join(rows))
            rows = []
    db.execute("\\analyze")
    return db


# big table bytes: 20k rows x (4 + 4 + 8 + 4 + padding) ~ 480KB.
BUDGET = 200_000   # forces ~4+ segments


@pytest.fixture(scope="module")
def dbs():
    return _mkdb(), _mkdb(budget=BUDGET)


QUERIES = [
    # Q6-class scalar aggregate
    "SELECT SUM(v), COUNT(*), MIN(v), MAX(v), AVG(v) FROM big WHERE g < 2",
    # Q1-class group aggregate
    "SELECT g, COUNT(*), SUM(v), AVG(v) FROM big GROUP BY g ORDER BY g",
    # probe-side streaming join, build side resident
    "SELECT d.name, SUM(b.v) FROM big b, dim d WHERE b.k = d.k "
    "GROUP BY d.name ORDER BY d.name",
    # selective scan (SMA prunable on the clustered seq column)
    "SELECT COUNT(*), SUM(v) FROM big WHERE seq < 1000",
]


@pytest.mark.parametrize("qi", range(len(QUERIES)))
def test_streamed_matches_resident(dbs, qi):
    full, streamed = dbs
    q = QUERIES[qi]
    a = full.execute(q).rows
    b = streamed.execute(q).rows
    info = streamed.executor.last_stream_info
    assert info is not None and info["segments"] > 1, \
        "query did not take the streamed path"
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        for x, y in zip(ra, rb):
            if isinstance(x, float):
                assert abs(x - y) <= 1e-9 * max(1.0, abs(x))
            else:
                assert x == y


def test_sma_pruning_skips_segments(dbs):
    _, streamed = dbs
    # seq is monotone, so seq < 1000 falls entirely in the first segment(s):
    # SMA min/max must prune the rest without touching the device.
    # (COUNT(*) alone only needs the small seq column and runs resident, so
    # SUM(v) keeps the plan over budget -> streamed.)
    q = "SELECT COUNT(*), SUM(v) FROM big WHERE seq < 1000"
    streamed.execute(q)
    info = streamed.executor.last_stream_info
    assert info is not None and info["segments_run"] < info["segments"], \
        f"no segments pruned: {info}"
    # and the result is still exact
    r = streamed.execute(q)
    assert r.rows[0][0] == 1000


def test_streamed_bytes_accounted(dbs):
    _, streamed = dbs
    streamed.execute("SELECT SUM(v) FROM big")
    info = streamed.executor.last_stream_info
    assert info["bytes_streamed"] > 0
    assert streamed.executor.last_scan_bytes >= info["bytes_streamed"]


# ---------------------------------------------------------------------
# widened coverage: join-only row streaming, DISTINCT decomposition,
# strict-budget error (round-3)
# ---------------------------------------------------------------------

ROW_STREAM_QUERIES = [
    # join-only plan (no aggregate anywhere): probe side streams, rows
    # materialize per segment, ORDER BY/LIMIT run over the union
    "SELECT b.seq, d.name FROM big b, dim d WHERE b.k = d.k AND b.g = 0 "
    "ORDER BY b.seq LIMIT 40",
    # DISTINCT over a join, no aggregate: per-segment dedup + merge dedup
    "SELECT DISTINCT d.name, b.g FROM big b, dim d WHERE b.k = d.k "
    "ORDER BY d.name, b.g",
    # filter-only plan with no aggregate
    "SELECT seq, v FROM big WHERE seq < 500 ORDER BY seq LIMIT 20",
]


@pytest.mark.parametrize("qi", range(len(ROW_STREAM_QUERIES)))
def test_row_streaming_matches_resident(dbs, qi):
    full, streamed = dbs
    q = ROW_STREAM_QUERIES[qi]
    a = full.execute(q).rows
    b = streamed.execute(q).rows
    info = streamed.executor.last_stream_info
    assert info is not None and info["segments"] > 1, \
        "query did not take the streamed path"
    assert a == b


def test_distinct_aggregate_streams(dbs):
    full, streamed = dbs
    q = ("SELECT g, COUNT(DISTINCT k) FROM big GROUP BY g ORDER BY g")
    a = full.execute(q).rows
    b = streamed.execute(q).rows
    info = streamed.executor.last_stream_info
    assert info is not None and info["segments"] > 1, \
        "distinct aggregate did not stream"
    assert a == b


def test_build_side_chain_streams(dbs):
    """big below the BUILD side of a semi join: the Filter->Scan chain under
    the join streams; the join itself runs once over the (filtered) union."""
    full, streamed = dbs
    q = ("SELECT d.name FROM dim d WHERE EXISTS "
         "(SELECT * FROM big b WHERE d.k = b.k AND b.v > 90.0) "
         "ORDER BY d.name")
    a = full.execute(q).rows
    b = streamed.execute(q).rows
    info = streamed.executor.last_stream_info
    assert info is not None and info["segments"] > 1
    assert a == b


def test_strict_budget_errors_on_unstreamable(dbs):
    _, streamed = dbs
    streamed.config.strict_hbm_budget = True
    try:
        # big scanned twice (self-join): the second resident scan would blow
        # the budget, so no streamable shape exists -> documented error
        with pytest.raises(Exception, match="streamable"):
            streamed.execute(
                "SELECT COUNT(*) FROM big b1, big b2 "
                "WHERE b1.seq = b2.seq AND b1.v < 1.0")
    finally:
        streamed.config.strict_hbm_budget = False


def test_adaptive_probe_ordering():
    """Runtime-adaptive SMA probe ordering (LIPFilterAdaptiveProber analog):
    data engineered so the PLAN-TIME conjunct order is misleading — the
    first-listed conjunct never rejects a segment while the second rejects
    almost all — must flip the probe order at runtime and cut the number of
    host conjunct evaluations below the naive filters*segments product."""
    from quickstep_tpu.config import Config
    cfg = Config()
    cfg.display_timing = False
    cfg.hbm_budget_bytes = 120_000
    db = Database(config=cfg)
    db.execute("CREATE TABLE t (a INT NOT NULL, b INT NOT NULL, "
               "v DOUBLE NOT NULL)")
    rows = []
    n = 30000
    for i in range(n):
        # a: 0/1 alternating -> `a = 0` estimated selectivity ~1/2e-? ... the
        # point: every segment contains a 0, so min<=0<=max never rejects.
        # b: monotonically increasing -> `b < 100` rejects every segment
        # except the first, but its plan-time estimate (~uniform) is weak.
        rows.append(f"({i % 2}, {i}, {float(i % 97)})")
        if len(rows) == 5000:
            db.execute("INSERT INTO t VALUES " + ", ".join(rows))
            rows = []
    db.execute("\\analyze")
    r = db.execute("SELECT COUNT(*), SUM(v) FROM t WHERE a = 0 AND b < 100")
    info = db.executor.last_stream_info
    assert info is not None and info["segments"] > 2, info
    nf = len(info["probe_rejects"])
    assert nf >= 2
    # the rejecting conjunct must have risen to the front of the probe order
    best = info["probe_order"][0]
    assert info["probe_rejects"][best] == max(info["probe_rejects"])
    assert info["probe_rejects"][best] > 0
    # adaptive stop-at-first-reject saves host evaluations vs naive all-pairs
    assert info["probe_evaluations"] < info["segments"] * nf
    # correctness unchanged
    assert r.rows[0][0] == 50


def test_out_of_core_order_by(db_factory=None):
    """ORDER BY over a table larger than the HBM budget rides the streamed
    external-sort path (per-segment device runs + host merge) and is
    row-exact (SortMergeRunOperator.hpp:72-129 analog)."""
    import numpy as np
    from quickstep_tpu import Database
    db = Database()
    n = 200_000
    rng = np.random.default_rng(5)
    k = rng.integers(0, 1_000_000, n)
    v = rng.integers(-500, 500, n)
    db.execute("CREATE TABLE big (k INT NOT NULL, v INT NOT NULL)")
    rel = db.catalog.default_database.get_relation("big")
    from quickstep_tpu.storage.column import Column
    from quickstep_tpu.storage.table import TableData
    from quickstep_tpu.types import INT
    rel.set_data(TableData({
        "k": Column(INT, k.astype(np.int32), None, None),
        "v": Column(INT, v.astype(np.int32), None, None)}))
    rel.analyze()
    # force streaming: table bytes (1.6MB) far exceed budget/2
    db.config.hbm_budget_bytes = 256 * 1024
    r = db.execute("SELECT k, v FROM big WHERE v >= 0 ORDER BY k, v")
    info = db.executor.last_stream_info
    assert info and info.get("mode") == "stream_sort", info
    assert info["segments"] > 1
    m = v >= 0
    want = sorted(zip(k[m].tolist(), v[m].tolist()))
    assert len(r.rows) == len(want)
    assert [tuple(row) for row in r.rows[:1000]] == want[:1000]
    assert [tuple(row) for row in r.rows[-1000:]] == want[-1000:]
    # with LIMIT
    r2 = db.execute("SELECT k, v FROM big ORDER BY v DESC, k LIMIT 7")
    want2 = sorted(zip(v.tolist(), k.tolist()), key=lambda t: (-t[0], t[1]))[:7]
    assert [(kk, vv) for kk, vv in ((row[0], row[1]) for row in r2.rows)] == \
        [(kk, vv) for vv, kk in want2]


def test_segment_device_cache_warm():
    """Second execution of a streamed query re-uses device-cached segments
    (seg_cache hits > 0, misses unchanged)."""
    import numpy as np
    from quickstep_tpu import Database
    db = Database()
    n = 100_000
    rng = np.random.default_rng(6)
    db.execute("CREATE TABLE big2 (k INT NOT NULL, v INT NOT NULL)")
    rel = db.catalog.default_database.get_relation("big2")
    from quickstep_tpu.storage.column import Column
    from quickstep_tpu.storage.table import TableData
    from quickstep_tpu.types import INT
    rel.set_data(TableData({
        "k": Column(INT, rng.integers(0, 50, n).astype(np.int32), None, None),
        "v": Column(INT, rng.integers(0, 100, n).astype(np.int32), None,
                    None)}))
    rel.analyze()
    db.config.hbm_budget_bytes = 256 * 1024
    sql = "SELECT k, sum(v) FROM big2 GROUP BY k ORDER BY k"
    r1 = db.execute(sql)
    misses_cold = db.executor._seg_cache_misses
    assert db.executor.last_stream_info["segments_run"] > 1
    r2 = db.execute(sql)
    warm_misses = db.executor._seg_cache_misses - misses_cold
    # the pinned prefix (half the budget) serves hits every warm run; the
    # tail beyond the cap still streams
    assert db.executor._seg_cache_hits > 0
    assert warm_misses < misses_cold
    assert [tuple(x) for x in r1.rows] == [tuple(x) for x in r2.rows]
