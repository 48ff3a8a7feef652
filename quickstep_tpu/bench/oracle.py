"""Indexed sqlite3 oracle for TPC-H and the comparator that checks the engine
against it.

The reference engine cannot be built offline, so sqlite over identical generated
data is the oracle (the reference's own correctness story is golden output
comparison, SURVEY.md §4.2). The oracle is a plain implementation of the same
SQL, independent of the engine's planner and device code. `expected_rows`
copies the generated tables into an indexed sqlite file, runs the queries on
the CPU and returns their rows.

Float tolerance (REL_TOL, ABS_TOL). TPC-H money columns are DECIMAL(9,2), which
the engine keeps as exact integer cents, so its SUMs are exact on any device;
AVG and the ratios in Q8/Q14/Q17 divide exact sums once. sqlite stores the same
values as binary64 REAL and adds them in its own order: a sum of N terms then
carries a relative error of at most N * 2^-53 against the exact value, 6.7e-10
for SF1 lineitem (6M rows) and 6.7e-9 at SF10. REL_TOL = 1e-8 covers both.
ABS_TOL = 1e-6 covers results that are exactly zero on one side. An engine DOUBLE
aggregate on a GPU is reduced in another order, and its scatter-adds are atomic
in an order that changes from run to run; no TPC-H query aggregates a DOUBLE
column, and such drift (relative 1e-15 per term) also sits far inside REL_TOL.
"""

from __future__ import annotations

import math
import os
import re
import sqlite3
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from quickstep_tpu.bench.tpch import (
    ORACLE_OVERRIDES, TPCH_QUERIES, to_sqlite_sql, with_tiebreak,
)
from quickstep_tpu.bench.tpchgen import TPCH_SCHEMAS
from quickstep_tpu.types import TypeID

REL_TOL = 1e-8
ABS_TOL = 1e-6

# Without these sqlite does not finish Q4 at SF0.1 in minutes (correlated
# EXISTS over lineitem); with them all 22 queries take seconds. il_ps also
# serves lookups by l_partkey alone.
INDEXES = [
    "CREATE INDEX il_ok ON lineitem(l_orderkey)",
    "CREATE INDEX il_ps ON lineitem(l_partkey, l_suppkey)",
    "CREATE INDEX il_sk ON lineitem(l_suppkey)",
    "CREATE INDEX io_ok ON orders(o_orderkey)",
    "CREATE INDEX io_ck ON orders(o_custkey)",
    "CREATE INDEX ic_ck ON customer(c_custkey)",
    "CREATE INDEX ip_pk ON part(p_partkey)",
    "CREATE INDEX ips_pk ON partsupp(ps_partkey)",
    "CREATE INDEX ips_sk ON partsupp(ps_suppkey)",
    "CREATE INDEX is_sk ON supplier(s_suppkey)",
]

_CHUNK_ROWS = 500_000


# ---------------------------------------------------------------------
# SQL text on each side
# ---------------------------------------------------------------------

def engine_sql(q: int) -> str:
    """Query q as the engine runs it (LIMIT ties broken deterministically)."""
    return with_tiebreak(q, TPCH_QUERIES[q])


def oracle_sql(q: int) -> str:
    """Query q in sqlite's dialect, with the same tiebreaks."""
    return to_sqlite_sql(with_tiebreak(q, ORACLE_OVERRIDES.get(
        q, TPCH_QUERIES[q])))


def is_ordered(sql: str) -> bool:
    return "order by" in sql.lower()


# ---------------------------------------------------------------------
# building the oracle
# ---------------------------------------------------------------------

def decode_columns(table, schema) -> List[np.ndarray]:
    """Host decode of every column of a TableData to values sqlite stores:
    str for strings and dates, float for DECIMAL/DOUBLE, int otherwise."""
    from quickstep_tpu.types.datetime_util import date_to_str
    cols = []
    for name, typ in schema:
        c = table.columns[name]
        arr = np.asarray(c.data)
        tid = typ.type_id
        if typ.is_string:
            vals = np.asarray(c.dictionary.values, dtype=object)[arr]
        elif tid == TypeID.DECIMAL:
            vals = arr.astype(np.float64) / (10 ** typ.scale)
        elif tid == TypeID.DATE:
            uniq, inv = np.unique(arr, return_inverse=True)
            vals = np.asarray([date_to_str(int(x)) for x in uniq],
                              dtype=object)[inv]
        elif typ.is_floating:
            vals = arr.astype(np.float64)
        else:
            vals = arr.astype(np.int64)
        if c.valid is not None:
            vals = np.where(np.asarray(c.valid), vals.astype(object), None)
        cols.append(vals)
    return cols


def _sqlite_type(typ) -> str:
    if typ.type_id in (TypeID.INT, TypeID.LONG):
        return "INTEGER"
    if typ.type_id in (TypeID.DOUBLE, TypeID.FLOAT, TypeID.DECIMAL):
        return "REAL"
    return "TEXT"


def columns_used(sqls: Iterable[str]) -> Dict[str, List[str]]:
    """table -> the columns the SQL texts name (TPC-H column names carry
    their table's prefix, so a name alone says where it lives)."""
    text = " ".join(sqls).lower()
    words = set(re.findall(r"[a-z_][a-z0-9_]*", text))
    return {t: [c for c, _ in schema if c in words]
            for t, schema in TPCH_SCHEMAS.items()}


def build_sqlite(tables: Dict, path: str,
                 columns: Optional[Dict[str, List[str]]] = None
                 ) -> sqlite3.Connection:
    """Load the TPC-H tables (name -> TableData) into a new sqlite file at
    `path`, keeping only `columns` (table -> names; all when None), then
    index and ANALYZE them. Returns the open connection. One file per table
    built on threads was slower: the inserts bind rows under the GIL."""
    if os.path.exists(path):
        os.unlink(path)
    conn = sqlite3.connect(path)
    conn.execute("PRAGMA journal_mode=OFF")
    conn.execute("PRAGMA synchronous=OFF")
    conn.execute("PRAGMA cache_size=-2000000")   # 2 GB page cache
    loaded = set()
    for name, schema in TPCH_SCHEMAS.items():
        keep = None if columns is None else set(columns.get(name, ()))
        schema = [(c, t) for c, t in schema if keep is None or c in keep]
        if not schema:
            continue
        loaded.update((name, c) for c, _ in schema)
        decls = ", ".join(f"{c} {_sqlite_type(t)}" for c, t in schema)
        conn.execute(f"CREATE TABLE {name} ({decls})")
        cols = decode_columns(tables[name], schema)
        n = len(cols[0])
        ph = ", ".join("?" * len(schema))
        for start in range(0, n, _CHUNK_ROWS):
            sl = slice(start, min(start + _CHUNK_ROWS, n))
            # .tolist() yields python scalars; numpy scalars would be stored
            # as BLOBs by the sqlite3 adapter
            conn.executemany(f"INSERT INTO {name} VALUES ({ph})",
                             zip(*[c[sl].tolist() for c in cols]))
        conn.commit()
    for ix in INDEXES:
        table, cols = re.match(r".* ON (\w+)\((.*)\)", ix).groups()
        if all((table, c.strip()) in loaded for c in cols.split(",")):
            conn.execute(ix)
    conn.execute("ANALYZE")
    conn.commit()
    return conn


def run_queries(path: str, queries: Iterable[int],
                threads: int = 4) -> Dict[int, dict]:
    """Run the queries on the sqlite file at `path`, `threads` at a time,
    each on its own connection (sqlite releases the GIL while it steps).
    Returns q -> {"rows": [...], "s": seconds} or {"error": str}."""
    pending = list(queries)
    out: Dict[int, dict] = {}
    lock = threading.Lock()

    def worker():
        conn = sqlite3.connect(f"file:{path}?mode=ro", uri=True)
        conn.execute("PRAGMA mmap_size=137438953472")   # share the OS cache
        try:
            while True:
                with lock:
                    if not pending:
                        return
                    q = pending.pop(0)
                t0 = time.perf_counter()
                try:
                    rows = conn.execute(oracle_sql(q)).fetchall()
                    res = {"rows": rows, "s": time.perf_counter() - t0}
                except sqlite3.Error as e:
                    res = {"error": f"{type(e).__name__}: {e}"}
                with lock:
                    out[q] = res
        finally:
            conn.close()

    pool = [threading.Thread(target=worker) for _ in range(max(threads, 1))]
    for t in pool:
        t.start()
    for t in pool:
        t.join()
    return out


def expected_rows(tables: Dict, queries: Iterable[int], path: str
                  ) -> Tuple[Dict[int, list], Dict[str, float]]:
    """The oracle's rows for `queries` over `tables` (name -> TableData):
    builds the indexed sqlite file at `path` with the columns the queries
    read, runs them on as many threads as there are queries or cores, and
    deletes the file. Returns (q -> rows, {"load_s", "query_s"}); raises
    RuntimeError when sqlite fails a query."""
    queries = list(queries)
    t0 = time.perf_counter()
    build_sqlite(tables, path,
                 columns_used(oracle_sql(q) for q in queries)).close()
    t1 = time.perf_counter()
    try:
        res = run_queries(path, queries,
                          threads=min(len(queries), os.cpu_count() or 1))
    finally:
        os.unlink(path)
    errors = {q: r["error"] for q, r in res.items() if "error" in r}
    if errors:
        raise RuntimeError(f"oracle failed: {errors}")
    return ({q: r["rows"] for q, r in res.items()},
            {"load_s": t1 - t0, "query_s": time.perf_counter() - t1})


# ---------------------------------------------------------------------
# comparing
# ---------------------------------------------------------------------

def _row_eq(a, b) -> bool:
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if isinstance(x, float) or isinstance(y, float):
            if x is None or y is None:
                return False
            if not math.isclose(float(x), float(y), rel_tol=REL_TOL,
                                abs_tol=ABS_TOL):
                return False
        elif x != y:
            return False
    return True


def _norm_key(r):
    """Canonical sort key for multiset matching: floats participate rounded
    to 4dp (bucketing only — equality is decided by _row_eq's isclose, so a
    .xxx5 representation boundary cannot produce a false mismatch)."""
    return tuple(("f", round(v, 4)) if isinstance(v, float)
                 else ("v", repr(v)) for v in r)


def compare(ours, oracle, ordered: bool) -> Optional[str]:
    """None when the engine's rows match the oracle's (in order when the
    query orders them, as a multiset otherwise), else what differs."""
    ours = [tuple(r) for r in ours]
    oracle = [tuple(r) for r in oracle]
    if len(ours) != len(oracle):
        return f"row count {len(ours)} vs {len(oracle)}"
    if not ordered:
        ours = sorted(ours, key=_norm_key)
        oracle = sorted(oracle, key=_norm_key)
    for i, (a, b) in enumerate(zip(ours, oracle)):
        if not _row_eq(a, b):
            return f"row {i}: {a!r} != {b!r}"
    return None
