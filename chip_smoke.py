"""Smoke run of the engine on NVIDIA GPUs through its public entry points.

    python chip_smoke.py                # one GPU: TPC-H SF1 (22 queries), COPY,
                                        # network CLI, duplicate-key join
    python chip_smoke.py --sf 10        # one GPU: TPC-H SF10 resident, Q1 Q3 Q6
                                        # Q9 Q18 Q21
    python chip_smoke.py --four-cards   # four GPUs: the shuffle join, then the
                                        # sharded path against the oracle

Phases, in order:

1. Device: fail unless JAX's first device is a GPU; print its kind, the device
   count, the JAX version, nvidia-smi's name and power limit, and the memory
   JAX may use.
2. TPC-H from seed 0: every query through `Database.execute`, once cold (it
   compiles) and three times warm, each checked row by row against an indexed
   sqlite oracle over the same generated data. The oracle is built and
   queried on the CPU before the first timed query, so nothing else runs on
   the host while the engine is timed.
3. Load and serve: `COPY ... FROM` a generated `.tbl` file through the native
   scanner, then one query through the network CLI's server and client.
4. Duplicate build keys: joins whose build side repeats keys, and the
   direct-address build and the compaction scatter that declare their indices
   unique, each checked against a plain reference.

Every phase raises on a wrong result, and the script then exits non-zero
without its last line. The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WORKDIR = os.path.join(REPO, "data", "chip_smoke")
SF10_QUERIES = (1, 3, 6, 9, 18, 21)
WARM_RUNS = 3


class SmokeFailure(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------
# phase 1: device
# ---------------------------------------------------------------------

def require_gpu(devices, count: int = 1) -> None:
    """Refuse anything but `count` or more GPUs: JAX falls back to the CPU
    with only a warning when its CUDA plug-in fails to load."""
    if not devices or devices[0].platform != "gpu":
        found = devices[0].platform if devices else "nothing"
        raise SmokeFailure(f"no GPU: JAX's first device is {found}")
    if len(devices) < count:
        raise SmokeFailure(f"{count} GPUs needed, JAX sees {len(devices)}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def device_phase(count: int = 1):
    import jax
    devices = jax.devices()
    require_gpu(devices, count)
    dev = devices[0]
    log(f"device_kind: {dev.device_kind}")
    log(f"device_count: {len(devices)}")
    log(f"jax: {jax.__version__}")
    log(nvidia_smi())   # name, power limit: one line per card
    log(f"bytes_limit: {dev.memory_stats()['bytes_limit']}")
    return dev


# ---------------------------------------------------------------------
# phase 2: TPC-H against the oracle
# ---------------------------------------------------------------------

def oracle_rows(tables, queries, workdir: str) -> dict:
    """q -> the indexed sqlite oracle's rows over the generated `tables`."""
    from quickstep_tpu.bench import oracle as O
    os.makedirs(workdir, exist_ok=True)
    try:
        expected, t = O.expected_rows(tables, queries,
                                      os.path.join(workdir, "oracle.sqlite"))
    except RuntimeError as e:
        raise SmokeFailure(str(e)) from e
    log(f"oracle: sqlite load+index {t['load_s']:.1f} s, "
        f"{len(queries)} queries {t['query_s']:.1f} s")
    return expected


def run_query(db, sql: str, warm_runs: int = WARM_RUNS) -> dict:
    """One cold and `warm_runs` warm executions; times in ms."""
    t0 = time.perf_counter()
    rows = db.execute(sql).rows
    cold = (time.perf_counter() - t0) * 1000
    warm = []
    for _ in range(warm_runs):
        t0 = time.perf_counter()
        rows = db.execute(sql).rows
        warm.append((time.perf_counter() - t0) * 1000)
    ex = db.executor
    return {"rows": rows, "cold_ms": cold,
            "warm_ms": statistics.median(warm) if warm else None,
            "pull_ms": (ex.last_profile or {}).get("pull_ms"),
            "attempts": ex.last_attempts,
            "sort": ex.last_sort_path or "none"}


def describe(r: dict) -> str:
    """One query's readings, printed as soon as it has run, so a run cut
    short still shows how far it got."""
    warm = "n/a" if r["warm_ms"] is None else f"{r['warm_ms']:.3f}"
    pull = "n/a" if r["pull_ms"] is None else f"{r['pull_ms']:.3f}"
    return (f"rows={len(r['rows'])} cold_ms={r['cold_ms']:.1f} "
            f"warm_ms={warm} pull_ms={pull} attempts={r['attempts']} "
            f"sort={r['sort']}")


def check(q: int, ours, *references) -> str:
    """'ok', or what differs between the rows of query q and each
    (name, rows) reference."""
    from quickstep_tpu.bench import oracle as O
    ordered = O.is_ordered(O.engine_sql(q))
    diffs = [f"vs {name}: {d}" for name, rows in references
             if (d := O.compare(ours, rows, ordered)) is not None]
    return "ok" if not diffs else ("MISMATCH " + "; ".join(diffs))[:300]


def tpch_phase(sf: float, queries, workdir: str = WORKDIR, seed: int = 0,
               warm_runs: int = WARM_RUNS):
    """Load TPC-H at `sf` from `seed`, run `queries` and check each against
    the oracle. Returns (db, tables, per-query records)."""
    from quickstep_tpu import Database
    from quickstep_tpu.bench import oracle as O
    from quickstep_tpu.bench.tpch import load_tpch

    t0 = time.perf_counter()
    db = Database()
    tables = load_tpch(db, scale=sf, seed=seed)
    n = db.catalog.default_database.get_relation("lineitem").num_tuples
    log(f"setup: TPC-H SF{sf:g} seed {seed} generated and loaded in "
        f"{time.perf_counter() - t0:.1f} s ({n} lineitem rows)")
    expected = oracle_rows(tables, queries, workdir)
    records, failed = {}, []
    for q in queries:
        r = records[q] = run_query(db, O.engine_sql(q), warm_runs)
        r["status"] = check(q, r["rows"], ("oracle", expected[q]))
        if r["status"] != "ok":
            failed.append(q)
        log(f"Q{q}: {describe(r)} {r['status']}")
    log(f"tolerance: rel {O.REL_TOL:g}, abs {O.ABS_TOL:g} "
        "(see quickstep_tpu/bench/oracle.py)")
    if failed:
        raise SmokeFailure(f"TPC-H SF{sf:g}: {len(failed)} queries differ "
                           f"from the oracle: {failed}")
    log(f"tpch: {len(queries)}/{len(queries)} row-exact at SF{sf:g}")
    return db, tables, records


def log_peak_memory(devices) -> None:
    for d in devices:
        st = d.memory_stats() or {}
        log(f"peak_bytes_in_use[{d.id}]: {st.get('peak_bytes_in_use')} "
            f"of bytes_limit {st.get('bytes_limit')}")


# ---------------------------------------------------------------------
# phase 3: COPY FROM a .tbl file, one query over the network CLI
# ---------------------------------------------------------------------

def write_tbl(table, schema, path: str) -> None:
    """dbgen-style text: '|' after every field."""
    from quickstep_tpu.bench.oracle import decode_columns
    cols = [c.tolist() for c in decode_columns(table, schema)]
    with open(path, "w") as f:
        for row in zip(*cols):
            f.write("|".join(map(str, row)) + "|\n")


def load_and_serve_phase(db, tables, workdir: str = WORKDIR) -> None:
    from quickstep_tpu.bench.tpch import _ddl_type
    from quickstep_tpu.bench.tpchgen import TPCH_SCHEMAS
    from quickstep_tpu.cli.network import QueryClient, QueryServer
    from quickstep_tpu.storage import native_io

    schema = TPCH_SCHEMAS["supplier"]
    os.makedirs(workdir, exist_ok=True)
    path = os.path.join(workdir, "supplier.tbl")
    write_tbl(tables["supplier"], schema, path)
    t0 = time.perf_counter()
    so = native_io.build_library()
    log(f"native scanner: {os.path.relpath(so, REPO)} ready in "
        f"{time.perf_counter() - t0:.2f} s")
    if not native_io.native_available():
        raise SmokeFailure("native scanner did not load")
    cols = ", ".join(f"{c} {_ddl_type(t)} NOT NULL" for c, t in schema)
    db.execute(f"CREATE TABLE supplier_copy ({cols})")
    t0 = time.perf_counter()
    res = db.execute(f"COPY supplier_copy FROM '{path}' WITH "
                     "(DELIMITER '|')")
    log(f"copy: {res.rows_affected} rows in "
        f"{(time.perf_counter() - t0) * 1000:.1f} ms")
    names = ", ".join(c for c, _ in schema)
    a = db.execute(f"SELECT {names} FROM supplier ORDER BY s_suppkey").rows
    b = db.execute(f"SELECT {names} FROM supplier_copy "
                   "ORDER BY s_suppkey").rows
    if a != b:
        raise SmokeFailure("COPY FROM did not reproduce the supplier table")

    sql = ("SELECT s_nationkey, count(*) AS n, sum(s_acctbal) AS bal "
           "FROM supplier_copy GROUP BY s_nationkey ORDER BY s_nationkey")
    want = [list(r) for r in db.execute(sql).rows]
    server = QueryServer(db, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        client = QueryClient("127.0.0.1", server.port)
        try:
            resp = client.query(sql)
        finally:
            client.close()
    finally:
        server.shutdown()
        thread.join(timeout=30)
    if resp["stderr"] or resp["rows"] != want:
        raise SmokeFailure(f"network query: {resp['stderr'] or resp['rows']}")
    log(f"network: {len(resp['rows'])} rows in {resp['time_ms']:.1f} ms "
        "(server time)")


# ---------------------------------------------------------------------
# phase 4: duplicated build keys
# ---------------------------------------------------------------------

def dup_join_phase(width: int = 1 << 22) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    from quickstep_tpu import Database
    from quickstep_tpu.config import Config
    from quickstep_tpu.ops import join as J
    from quickstep_tpu.ops import kernels as K

    # engine path: key 3 repeats past the expansion width, so the first
    # attempt overflows and the retry widens it
    db = Database()
    db.execute("CREATE TABLE probe (k INT NOT NULL, pv INT NOT NULL)")
    db.execute("INSERT INTO probe VALUES " + ", ".join(
        f"({k}, {k * 100 + r})" for k in range(1, 9) for r in range(10)))
    db.execute("CREATE TABLE build (k INT NOT NULL, bv INT NOT NULL)")
    db.execute("INSERT INTO build VALUES " + ", ".join(
        [f"(3, {i})" for i in range(20)] + ["(1, 100)", "(2, 200)"]))
    rows = db.execute("SELECT p.k, COUNT(*) AS c FROM probe p, build b "
                      "WHERE p.k = b.k GROUP BY p.k ORDER BY p.k").rows
    if rows != [(1, 10), (2, 10), (3, 200)]:
        raise SmokeFailure(f"duplicate-key inner join: {rows}")
    attempts = db.executor.last_attempts

    # semi join over the same duplicated keys through the direct-address
    # build (no bit-vector filter join): its dup flag must fire and the
    # retry must give the exact rows
    cfg = Config()
    cfg.use_filter_joins = False
    sdb = Database(config=cfg)
    for stmt in ("CREATE TABLE probe (k INT NOT NULL, pv INT NOT NULL)",
                 "CREATE TABLE build (k INT NOT NULL, bv INT NOT NULL)"):
        sdb.execute(stmt)
    sdb.execute("INSERT INTO probe VALUES " + ", ".join(
        f"({k}, {k})" for k in range(1, 41)))
    sdb.execute("INSERT INTO build VALUES " + ", ".join(
        f"({k % 7 + 1}, {k})" for k in range(50)))
    rows = sdb.execute("SELECT k FROM probe WHERE k IN "
                       "(SELECT k FROM build) ORDER BY k").rows
    if rows != [(k,) for k in range(1, 8)]:
        raise SmokeFailure(f"duplicate-key semi join: {rows}")

    # the kernels at width: direct_build declares unique scatter indices
    rng = np.random.default_rng(0)
    keys = rng.permutation(width).astype(np.int32) + 5
    dup_at = rng.choice(width, width // 100, replace=False)
    keys[dup_at] = keys[(dup_at + 1) % width]
    alive = np.ones(width, bool)
    alive[rng.choice(width, width // 50, replace=False)] = False
    table, dup = jax.jit(J.direct_build, static_argnums=(2, 3))(
        jnp.asarray(keys), jnp.asarray(alive), 5, width)
    table = np.asarray(table)
    live_keys = keys[alive]
    want_slots = np.zeros(width, bool)
    want_slots[live_keys - 5] = True
    occupied = table >= 0
    if not bool(dup):
        raise SmokeFailure("direct_build missed duplicated build keys")
    if not np.array_equal(occupied, want_slots):
        raise SmokeFailure("direct_build lost or invented slots")
    rows_at = table[occupied]
    if not (alive[rows_at].all() and
            np.array_equal(keys[rows_at] - 5, np.nonzero(occupied)[0])):
        raise SmokeFailure("direct_build slot holds a row of another key")
    uniq = np.arange(width, dtype=np.int32) + 5
    table_u, dup_u = jax.jit(J.direct_build, static_argnums=(2, 3))(
        jnp.asarray(uniq), jnp.asarray(alive), 5, width)
    want_u = np.where(alive, np.arange(width), -1)
    if bool(dup_u) or not np.array_equal(np.asarray(table_u), want_u):
        raise SmokeFailure("direct_build wrong on unique keys")

    # compaction scatter: every dead row shares one out-of-range index
    vals = rng.integers(0, 1 << 30, width).astype(np.int32)

    def compact(v, m):
        dest, count = K.compact_indices(m)
        return K.scatter_compact(v, dest, width), count
    got, count = jax.jit(compact)(jnp.asarray(vals), jnp.asarray(alive))
    want = vals[alive]
    got = np.asarray(got)
    if int(count) != want.size or not np.array_equal(got[:want.size], want):
        raise SmokeFailure("scatter_compact differs from the reference")
    log(f"dup_join: inner join rows exact after {attempts} attempts, semi "
        f"join exact, direct_build and scatter_compact exact at {width} rows")


# ---------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------

def shuffle_join_phase() -> None:
    """The key-partitioned shuffle join over the mesh: both sides over the
    replicate threshold, so neither is broadcast."""
    from quickstep_tpu import Database
    from quickstep_tpu.config import Config

    cfg = Config()
    cfg.distributed = True
    cfg.replicate_threshold_rows = 64
    sh = Database(config=cfg)
    sh.execute("CREATE TABLE lt (k INT NOT NULL, v INT NOT NULL)")
    sh.execute("CREATE TABLE rt (k INT NOT NULL, w INT NOT NULL)")
    sh.execute("INSERT INTO lt VALUES " +
               ", ".join(f"({i % 97}, {i})" for i in range(600)))
    sh.execute("INSERT INTO rt VALUES " +
               ", ".join(f"({i}, {i * 3})" for i in range(97)))
    rows = sh.execute(
        "SELECT lt.k, lt.v, rt.w FROM lt, rt WHERE lt.k = rt.k").rows
    if sorted(rows) != sorted((i % 97, i, (i % 97) * 3) for i in range(600)):
        raise SmokeFailure("shuffle join rows differ")
    if not any(k.startswith("shuffle_overflow")
               for k in sh.executor.last_flags):
        raise SmokeFailure("shuffle join path not taken")
    log("shuffle_join: 600 rows exact, radix-exchange path taken")


def four_cards_phase(workdir: str = WORKDIR, sf: float = 1.0,
                     seed: int = 0) -> None:
    """The 22 queries on a mesh over every device, each run once and checked
    against the oracle. The one-card run checks the single-device results of
    the same data against the same oracle. Nothing is timed here, so the
    oracle is built on a second thread while the mesh programs compile (XLA
    compiles without holding the GIL)."""
    import jax
    from quickstep_tpu import Database
    from quickstep_tpu.bench import oracle as O
    from quickstep_tpu.bench.tpch import TPCH_QUERIES, load_tpch
    from quickstep_tpu.config import Config

    queries = sorted(TPCH_QUERIES)
    t0 = time.perf_counter()
    cfg = Config()
    cfg.distributed = True
    dist = Database(config=cfg)
    tables = load_tpch(dist, scale=sf, seed=seed)
    mesh = dist.executor.mesh
    if mesh is None or mesh.devices.size != len(jax.devices()):
        raise SmokeFailure(f"no {len(jax.devices())}-device mesh")
    log(f"setup: TPC-H SF{sf:g} seed {seed} loaded in "
        f"{time.perf_counter() - t0:.1f} s; mesh {mesh.shape}")
    oracle: dict = {}

    def build_oracle():
        try:
            oracle["rows"] = oracle_rows(tables, queries, workdir)
        except SmokeFailure as e:
            oracle["error"] = e
    builder = threading.Thread(target=build_oracle)
    builder.start()
    records, checked, failed = {}, set(), []

    def check_ready():
        """Compare every query run so far once the oracle is there, so a
        run cut short still shows what it verified."""
        if builder.is_alive():
            return
        if "error" in oracle:
            raise oracle["error"]
        for q in [q for q in records if q not in checked]:
            checked.add(q)
            status = check(q, records[q]["rows"],
                           ("oracle", oracle["rows"][q]))
            if status != "ok":
                failed.append(q)
            log(f"Q{q}: {status}")
    try:
        for q in queries:
            records[q] = run_query(dist, O.engine_sql(q), warm_runs=0)
            log(f"Q{q} mesh: {describe(records[q])}")
            check_ready()
    finally:
        builder.join()
    check_ready()
    log_peak_memory(jax.devices())
    if failed:
        raise SmokeFailure(f"mesh results differ from the oracle: {failed}")
    log(f"four_cards: {len(queries)}/{len(queries)} mesh results equal to "
        "the oracle")


# ---------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Smoke run of the engine on NVIDIA GPUs.")
    ap.add_argument("--sf", type=float, default=1.0,
                    help="TPC-H scale; 10 runs Q1 Q3 Q6 Q9 Q18 Q21 only")
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded path over four GPUs")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    import jax
    from quickstep_tpu.bench.tpch import TPCH_QUERIES

    try:
        if args.four_cards:
            device_phase(count=4)
            shuffle_join_phase()
            four_cards_phase()
        else:
            dev = device_phase()
            queries = SF10_QUERIES if args.sf >= 10 else sorted(TPCH_QUERIES)
            db, tables, _ = tpch_phase(args.sf, queries)
            log_peak_memory([dev])
            if args.sf < 10:
                load_and_serve_phase(db, tables)
                dup_join_phase()
    except SmokeFailure as e:
        print(f"FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    log(f"elapsed: {time.perf_counter() - t_start:.1f} s")
    devs = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
