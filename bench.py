"""TPC-H benchmark entry point for one NVIDIA GPU.

Prints the device it runs on (platform, device_kind, count, and nvidia-smi's
name and power limit) and fails when JAX's first device is not a GPU. Then,
per query: one compile/warm run, one run that times the device program by
pipelined re-issues (profile_device_reps), and BENCH_TRIALS timed runs whose
median is reported — the reference harness's protocol
(benchmarks/tpch/run-benchmark.sh:79,91: warm-up run discarded, middle of
repeated trials). Everything compiles in this one process, against the
persistent compilation cache.

A JSON summary line is printed after every query (the last line printed is the
most complete), and per-query details go to stderr and to
data/bench_detail.json, so a run killed part-way keeps its results.

    BENCH_SF=1 BENCH_QUERIES=all BENCH_TRIALS=3 python bench.py
"""

import json
import os
import signal
import statistics
import subprocess
import sys
import time

REPO_ROOT = os.path.dirname(os.path.abspath(__file__))


def device_info():
    """Name the device, or fail: no number here may come from a CPU."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX's first device is "
                 f"{devs[0].platform}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "nvidia_smi": smi}


class Reporter:
    """Accumulates per-query results; emits the summary + detail file after
    every query and on SIGTERM/SIGINT, so no result is ever lost."""

    def __init__(self, sf, lrows, load_s, device, detail_path):
        self.sf = sf
        self.lrows = lrows
        self.load_s = load_s
        self.device = device
        self.detail_path = detail_path
        self.detail = {}
        self.skipped = []
        self.total_dev = 0.0
        self.total_wall = 0.0
        self.total_bytes = 0

    def record(self, q, entry, dev=0.0, wall=0.0, qbytes=0):
        self.detail[q] = entry
        self.total_dev += dev
        self.total_wall += wall
        self.total_bytes += qbytes
        self.emit()

    def emit(self, final=False):
        agg = self.total_bytes / self.total_dev / 1e9 \
            if self.total_dev > 0 else 0.0
        n_ok = sum(1 for d in self.detail.values() if "ms" in d)
        print(json.dumps({
            "metric": f"TPC-H SF{self.sf} {n_ok}-query achieved scan "
                      f"bandwidth/device",
            "value": agg, "unit": "GB/s", "device": self.device}),
            flush=True)
        try:
            os.makedirs(os.path.dirname(self.detail_path), exist_ok=True)
            with open(self.detail_path, "w") as f:
                json.dump({"sf": self.sf, "device": self.device,
                           "queries": self.detail, "skipped": self.skipped,
                           "load_s": self.load_s, "lineitem_rows": self.lrows,
                           "agg_gbps": agg, "final": final}, f, indent=1)
        except OSError:
            pass
        if final:
            print(f"# load={self.load_s:.1f}s lineitem={self.lrows} "
                  f"wall={self.total_wall*1000:.1f}ms "
                  f"dev={self.total_dev*1000:.1f}ms agg={agg:.3f}GB/s",
                  file=sys.stderr)
            if self.skipped:
                print(f"# SKIPPED (budget): {self.skipped}", file=sys.stderr)
            sys.stderr.flush()


def _profile_op_classes(db, sql):
    """Warm per-operator-class ms for one query: {scan|join|agg|sort|other}.
    Eager stepping attributes wall-clock to each plan node
    (utils/visualize.profile_plan — the per-WorkOrder timing analog)."""
    from quickstep_tpu.parser import parse_one
    from quickstep_tpu.optimizer.resolver import Resolver
    from quickstep_tpu.optimizer.rules import optimize_plan
    from quickstep_tpu.optimizer import logical as L
    from quickstep_tpu.utils.visualize import profile_plan
    dbase = db.catalog.default_database
    plan = optimize_plan(Resolver(dbase).resolve_select(parse_one(sql)),
                         db.config, dbase)
    times = profile_plan(db.executor, plan)
    classes = {}

    def cls(n):
        if isinstance(n, (L.TableScan, L.Filter)):
            return "scan"
        if isinstance(n, L.Join):
            return "join"
        if isinstance(n, (L.Aggregate, L.Distinct)):
            return "agg"
        if isinstance(n, L.Sort):
            return "sort"
        return "other"

    def walk(n):
        classes[cls(n)] = classes.get(cls(n), 0.0) + times.get(id(n), 0.0)
        for c in n.children():
            walk(c)
    walk(plan)
    return {k: v * 1000 for k, v in sorted(classes.items())}


def main():
    sf = float(os.environ.get("BENCH_SF", "1.0"))
    qspec = os.environ.get("BENCH_QUERIES", "all")
    trials = int(os.environ.get("BENCH_TRIALS", "3"))
    # Soft wall-clock budget for the measurement phase (excludes data
    # generation/load): stop starting new queries once spent; everything
    # measured so far has already been emitted.
    budget_s = float(os.environ.get("BENCH_BUDGET_S", "2400"))
    dev_reps = int(os.environ.get("BENCH_DEV_REPS", "4"))
    detail_path = os.path.join(REPO_ROOT, "data", "bench_detail.json")

    device = device_info()
    print(f"# device: {json.dumps(device)}", file=sys.stderr, flush=True)

    from quickstep_tpu import Database
    from quickstep_tpu.bench.tpch import TPCH_QUERIES, load_tpch
    qlist = sorted(TPCH_QUERIES) if qspec == "all" else \
        sorted(int(q) for q in qspec.split(","))

    t0 = time.perf_counter()
    cache_dir = os.environ.get("BENCH_CACHE",
                               os.path.join(REPO_ROOT, f"data/tpch_sf{sf}"))
    if os.path.exists(os.path.join(cache_dir, "catalog.json")):
        db = Database(storage_path=cache_dir)
    else:
        db = Database()
        load_tpch(db, scale=sf, seed=0)
        db.config.storage_path = cache_dir
        db.save()
    db.config.profile_device_reps = 0
    load_s = time.perf_counter() - t0
    lrows = db.catalog.default_database.get_relation("lineitem").num_tuples

    rep = Reporter(sf, lrows, load_s, device, detail_path)

    def on_signal(signum, frame):
        rep.emit(final=True)
        os._exit(0)

    for s in (signal.SIGTERM, signal.SIGINT):
        signal.signal(s, on_signal)

    t_meas = time.perf_counter()
    for q in qlist:
        if time.perf_counter() - t_meas > budget_s:
            rep.skipped.append(q)
            continue
        sql = TPCH_QUERIES[q]
        try:
            # compile + warm (reference skips run 1: QuickstepCli.cpp:143)
            db.execute(sql)
            # ONE device-time measurement run, then wall trials WITHOUT the
            # profiling re-issues — the wall must reflect a single execution
            db.config.profile_device_reps = dev_reps
            db.execute(sql)
            prof = db.executor.last_profile or {}
            dev = prof.get("device_ms", prof.get("exec_ms", 0.0)) / 1000
            db.config.profile_device_reps = 0
            times = []
            for _ in range(trials):
                t1 = time.perf_counter()
                db.execute(sql)
                times.append(time.perf_counter() - t1)
        except Exception as e:  # never lose the whole bench to one query
            rep.record(q, {"error": f"{type(e).__name__}: {e}"[:300]})
            print(f"# Q{q} FAILED: {type(e).__name__}: {e}"[:300],
                  file=sys.stderr)
            sys.stderr.flush()
            continue
        med = statistics.median(times)
        qbytes = getattr(db.executor, "last_scan_bytes", 0)
        gbps = qbytes / dev / 1e9 if dev > 0 else 0.0
        entry = {"ms": med * 1000, "dev_ms": dev * 1000,
                 "scan_mb": qbytes / 1e6, "gbps": gbps,
                 "dispatches": getattr(db.executor, "dispatches", None)}
        ops = (db.executor.last_profile or {}).get("op_stats")
        if ops:
            entry["gathers"] = ops["gathers"]
        if getattr(db.executor, "last_sort_path", None):
            entry["sort"] = db.executor.last_sort_path
        if os.environ.get("BENCH_PROFILE"):
            # per-operator-class attribution (eager node-by-node stepping,
            # the WorkOrder-timing analog): scan / join / agg / sort ms
            try:
                entry["ops"] = _profile_op_classes(db, sql)
            except Exception as e:
                entry["ops_error"] = str(e)[:120]
        rep.record(q, entry, dev=dev, wall=med, qbytes=qbytes)
        print(f"# Q{q}: {entry['ms']:.3f}ms (dev {entry['dev_ms']:.3f}ms) "
              f"scan={entry['scan_mb']:.1f}MB {entry['gbps']:.2f}GB/s",
              file=sys.stderr)
        sys.stderr.flush()

    rep.emit(final=True)


if __name__ == "__main__":
    main()
