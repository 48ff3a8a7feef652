"""SF1 -> SF10 device-time scaling table.

Reads two BENCH_DETAIL-style json files (SF1 and SF10) and emits a
per-query scaling table: dev_ms ratio vs the 10x row ratio. The reference
keeps per-block WorkOrder cost strictly linear in blocks
(relational_operators/SelectOperator.hpp:203-215); the committed bar here
is ratio <= 12x (1.2x linearity allowance) per query.

    python tools/scaling_check.py BENCH_SF1.json BENCH_SF10.json [out.json]
"""

import json
import sys


def main():
    sf1 = json.load(open(sys.argv[1]))
    sf10 = json.load(open(sys.argv[2]))
    out_path = sys.argv[3] if len(sys.argv) > 3 else "data/scaling.json"
    rows = []
    worst = None
    for q in sorted(sf1["queries"], key=int):
        a = sf1["queries"].get(q, {})
        b = sf10["queries"].get(q, {})
        if "dev_ms" not in a or "dev_ms" not in b or a["dev_ms"] <= 0:
            continue
        ratio = b["dev_ms"] / a["dev_ms"]
        rows.append({"q": int(q), "sf1_dev_ms": a["dev_ms"],
                     "sf10_dev_ms": b["dev_ms"], "ratio": round(ratio, 1),
                     "linear": ratio <= 12.0})
        if worst is None or ratio > worst["ratio"]:
            worst = rows[-1]
    n_ok = sum(1 for r in rows if r["linear"])
    summary = {"queries": rows, "n_linear": n_ok, "n_total": len(rows),
               "worst": worst, "bar": "dev_ms ratio <= 12x for 10x rows"}
    with open(out_path, "w") as f:
        json.dump(summary, f, indent=1)
    for r in rows:
        flag = "" if r["linear"] else "  <-- SUPERLINEAR"
        print(f"Q{r['q']:>2}: {r['sf1_dev_ms']:>8.1f} -> "
              f"{r['sf10_dev_ms']:>9.1f} ms  x{r['ratio']:<5}{flag}")
    print(f"{n_ok}/{len(rows)} within 12x; worst: Q{worst['q']} "
          f"x{worst['ratio']}" if worst else "no data")


if __name__ == "__main__":
    main()
