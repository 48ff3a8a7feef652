"""Run TPC-H queries against a fullgen store and verify row-exact vs its
streaming oracle (tools/sf100_fullgen.py). Used both to validate the
generator at small scale and as the SF100 measurement runner.

    python tools/sf100_full_verify.py <storedir> [budget_gb] [qlist] [out.json]

budget_gb <= 0 disables streaming (resident execution — small scales).
Results (timings + ok flags + stream info) are written incrementally to
out.json when given, so a timeout never loses completed queries.
"""

import datetime
import json
import math
import os
import sys
import time

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO_ROOT)

DEFAULT_QS = "6,1,12,14,19,4,3,5,7,10,18"


def norm(v):
    if isinstance(v, (datetime.date, datetime.datetime)):
        return v.isoformat()[:10]
    if isinstance(v, float):
        return v
    if isinstance(v, (int,)):
        return v
    return str(v)


def row_eq(a, b):
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        x, y = norm(x), norm(y)
        if isinstance(x, (int, float)) and isinstance(y, (int, float)):
            if not math.isclose(float(x), float(y), rel_tol=1e-9,
                                abs_tol=2e-2):
                return False
        elif str(x) != str(y):
            return False
    return True


def main():
    store = sys.argv[1]
    budget_gb = float(sys.argv[2]) if len(sys.argv) > 2 else 10.0
    qs = [int(q) for q in (sys.argv[3] if len(sys.argv) > 3
                           else DEFAULT_QS).split(",")]
    out_path = sys.argv[4] if len(sys.argv) > 4 else None

    from quickstep_tpu import Database
    from quickstep_tpu.bench.tpch import TPCH_QUERIES, with_tiebreak
    oracle = json.load(open(os.path.join(store, "oracle.json")))

    db = Database(storage_path=store)
    if budget_gb > 0:
        db.config.hbm_budget_bytes = int(budget_gb * (1 << 30))
    out = {"store": store, "rows": oracle["rows"], "budget_gb": budget_gb,
           "queries": {}}
    if out_path and os.path.exists(out_path):
        out = json.load(open(out_path))

    all_ok = True
    for qn in qs:
        key = str(qn)
        if out["queries"].get(key, {}).get("ok"):
            print(f"Q{qn}: already ok, skipping", flush=True)
            continue
        want = oracle.get(f"q{qn}")
        if want is None:
            print(f"Q{qn}: no oracle entry, skipping", flush=True)
            continue
        sql = with_tiebreak(qn, TPCH_QUERIES[qn])
        t0 = time.time()
        try:
            r = db.execute(sql)
            wall = time.time() - t0
            t1 = time.time()
            r = db.execute(sql)
            warm = time.time() - t1
        except Exception as e:  # noqa: BLE001 — record the failure and go on
            out["queries"][key] = {"ok": False,
                                   "error": f"{type(e).__name__}: {e}"[:300]}
            all_ok = False
            print(f"Q{qn}: ERROR {e}", flush=True)
            if out_path:
                json.dump(out, open(out_path, "w"), indent=1)
            continue
        got = [list(row) for row in r.rows]
        ok = len(got) == len(want)
        if ok:
            for g, w in zip(got, want):
                if not row_eq(g, w):
                    print(f"  Q{qn} row mismatch:\n   got  {g}\n   want {w}",
                          flush=True)
                    ok = False
                    break
        else:
            print(f"  Q{qn} row count {len(got)} vs {len(want)}", flush=True)
        prof = getattr(db.executor, "last_profile", None) or {}
        rec = {"ok": ok, "rows": len(got),
               "wall_cold_s": round(wall, 2), "wall_warm_s": round(warm, 2)}
        if isinstance(prof, dict):
            for k in ("device_ms", "total_device_ms"):
                if k in prof:
                    rec[k] = prof[k]
        stream = getattr(db.executor, "last_stream_info", None)
        if isinstance(stream, dict):
            rec["stream"] = {k: stream[k] for k in
                             ("segments", "mode", "pruned") if k in stream}
        out["queries"][key] = rec
        all_ok = all_ok and ok
        print(f"Q{qn}: ok={ok} cold={wall:.1f}s warm={warm:.1f}s "
              f"rows={len(got)}", flush=True)
        if out_path:
            json.dump(out, open(out_path, "w"), indent=1)

    out["all_ok"] = all_ok
    if out_path:
        json.dump(out, open(out_path, "w"), indent=1)
    print(json.dumps({k: v.get("ok") for k, v in out["queries"].items()}))


if __name__ == "__main__":
    main()
