"""Run streamed TPC-H Q1/Q6 at SF100 on the device and verify against the
exact big-int oracle produced by tools/sf100_gen.py.

The budget (default: the device's memory_stats()["bytes_limit"]) is set as
hbm_budget_bytes, so a store larger than it runs on the segment-streaming
path. Writes data/sf100_run.json with timing + row-exact status.

    python tools/sf100_run.py [budget_gb|device] [queries=6,1] [runs=2]
"""

import json
import math
import os
import sys
import time

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO_ROOT)


def close(a, b):
    if a is None or b is None:
        return a is b
    return math.isclose(float(a), float(b), rel_tol=1e-9, abs_tol=2e-2)


def main():
    budget = sys.argv[1] if len(sys.argv) > 1 else "device"
    qspec = sys.argv[2] if len(sys.argv) > 2 else "6,1"
    runs = int(sys.argv[3]) if len(sys.argv) > 3 else 2
    from quickstep_tpu import Database
    from quickstep_tpu.bench.tpch import TPCH_QUERIES
    with open(os.path.join(REPO_ROOT, "data", "sf100_oracle.json")) as f:
        oracle = json.load(f)

    db = Database(storage_path=os.path.join(REPO_ROOT, "data/tpch_sf100_li"))
    if budget == "device":
        import jax
        budget_bytes = jax.devices()[0].memory_stats()["bytes_limit"]
    else:
        budget_bytes = int(float(budget) * (1 << 30))
    db.config.hbm_budget_bytes = int(budget_bytes)
    out_path = os.path.join(REPO_ROOT, "data", "sf100_run.json")
    if os.path.exists(out_path):   # resume: keep already-measured queries
        out = json.load(open(out_path))
    else:
        out = {"sf": 100.0, "rows": oracle["rows"], "queries": {}}

    # Q6 first (4 columns ~9.6GB: single-pass streamed scan)
    for qname in qspec.split(","):
        sql = TPCH_QUERIES[int(qname)]
        t0 = time.time()
        r = db.execute(sql)
        wall = time.time() - t0
        warm = None
        if runs > 1:
            t1 = time.time()
            r = db.execute(sql)
            warm = round(time.time() - t1, 2)
        prof = db.executor.last_profile or {}
        rec = {"wall_cold_s": round(wall, 2), "wall_warm_s": warm,
               "rows": len(r.rows)}
        if qname == "6":
            want = oracle["q6"]
            rec["ok"] = len(r.rows) == 1 and close(r.rows[0][0], want)
        else:
            want_rows = oracle["q1"]
            ok = len(r.rows) == len(want_rows)
            got = {(row[0], row[1]): row for row in r.rows}
            for w in want_rows:
                g = got.get((w["l_returnflag"], w["l_linestatus"]))
                if g is None:
                    ok = False
                    break
                vals = [w["sum_qty"], w["sum_base_price"], w["sum_disc_price"],
                        w["sum_charge"], w["avg_qty"], w["avg_price"],
                        w["avg_disc"], w["count_order"]]
                for x, y in zip(g[2:], vals):
                    if not close(x, y):
                        print(f"  Q1 mismatch {w['l_returnflag']}"
                              f"{w['l_linestatus']}: {x} vs {y}", flush=True)
                        ok = False
            rec["ok"] = ok
        stream = getattr(db.executor, "last_stream_info", None)
        if stream:
            rec["stream"] = {k: stream[k] for k in ("segments", "mode")
                             if k in stream} if isinstance(stream, dict) \
                else str(stream)[:200]
        out["queries"][qname] = rec
        with open(out_path, "w") as f:   # incremental: survive timeouts
            json.dump(out, f, indent=1)
        print(f"Q{qname}: cold {wall:.1f}s warm {warm}s "
              f"ok={rec['ok']}", flush=True)

    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
