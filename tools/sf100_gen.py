"""SF100 lineitem store + exact Q1/Q6 oracle (BASELINE's last staged config).

Generates the SF100 lineitem columns that TPC-H Q1/Q6 touch (quantity,
extendedprice, discount, tax, returnflag, linestatus, shipdate) with the SAME
distributions/formulas as quickstep_tpu.bench.tpchgen — chunked so peak RAM
stays bounded — and writes a normal catalog store at data/tpch_sf100_li.
Text columns are omitted: at 600M rows they cost hours of generation and are
unread by the two staged queries (documented subset; the store is for the
SF100 Q1/Q6 datapoint, not full TPC-H).

While generating, an EXACT integer oracle for Q1 and Q6 is accumulated with
Python big-ints (split-sum so no chunk overflows int64) and written to
data/sf100_oracle.json. The engine's scale-6 decimal sums legitimately widen
to f64 (the stats-proven overflow guard; reference parity is double
arithmetic), so the verifier compares those with relative tolerance.

    python tools/sf100_gen.py [scale=100] [chunk_orders=10000000]
"""

import json
import os
import sys
import time

import numpy as np

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO_ROOT)


def main():
    scale = float(sys.argv[1]) if len(sys.argv) > 1 else 100.0
    chunk_orders = int(sys.argv[2]) if len(sys.argv) > 2 else 10_000_000
    import datetime as dt
    from quickstep_tpu.bench.tpchgen import (
        _dates_from_daynum, _EPOCH, MONEY)
    from quickstep_tpu.types import INT, DATE, Char
    from quickstep_tpu.storage.column import Column
    from quickstep_tpu.storage.dictionary import Dictionary
    from quickstep_tpu.storage.table import TableData

    O = int(1_500_000 * scale)
    P = int(200_000 * scale)
    t0 = time.time()

    parts = {name: [] for name in (
        "l_quantity", "l_extendedprice", "l_discount", "l_tax",
        "l_returnflag", "l_linestatus", "l_shipdate")}

    # oracle accumulators: Q1 per (rf, ls) group; Q6 single sum
    q1 = {}   # (rf, ls) -> [n, sum_qty, sum_price, sum_disc4, sum_charge6]
    q6_rev = 0
    cutoff_q1 = (dt.date(1998, 12, 1) - _EPOCH).days - 90   # date '1998-12-01' - 90 day
    q6_lo = (dt.date(1994, 1, 1) - _EPOCH).days
    q6_hi = (dt.date(1995, 1, 1) - _EPOCH).days
    cutoff_rf = (dt.date(1995, 6, 17) - _EPOCH).days

    def exact_sum(arr):
        """Exact big-int sum of an int64 array (split so chunks can't
        overflow)."""
        a = arr.astype(np.int64)
        lo = int((a % (1 << 30)).sum(dtype=np.int64))
        hi = int((a // (1 << 30)).sum(dtype=np.int64))
        return hi * (1 << 30) + lo

    done = 0
    ci = 0
    while done < O:
        n_orders = min(chunk_orders, O - done)
        rng = np.random.default_rng(9000 + ci)
        lines_per = rng.integers(1, 8, n_orders)
        L = int(lines_per.sum())
        o_daynum = rng.integers(0, 2406, n_orders)
        l_orderdate = np.repeat(o_daynum, lines_per)
        l_part = rng.integers(1, P + 1, L)
        l_qty = rng.integers(1, 51, L).astype(np.int64)
        # spec retail-price formula, evaluated per line (no 20M-part vector)
        retail = 90000 + ((l_part // 10) % 20001) + 100 * (l_part % 1000)
        l_extp = (l_qty * retail).astype(np.int64)          # cents
        l_disc = rng.integers(0, 11, L).astype(np.int64)    # scale-2 units
        l_tax = rng.integers(0, 9, L).astype(np.int64)
        ship = l_orderdate + rng.integers(1, 122, L)
        receipt = ship + rng.integers(1, 31, L)
        returnable = receipt <= cutoff_rf
        rf = np.where(returnable,
                      np.where(rng.random(L) < 0.5, 0, 1), 2)  # A/R/N
        ls_o = ship > cutoff_rf                                # False=F True=O

        parts["l_quantity"].append((l_qty * 100).astype(np.int32))
        parts["l_extendedprice"].append(l_extp.astype(np.int32))
        parts["l_discount"].append(l_disc.astype(np.int32))
        parts["l_tax"].append(l_tax.astype(np.int32))
        # dictionary codes over SORTED values: A,N,R -> 0,1,2 ; F,O -> 0,1
        rf_codes = np.array([0, 2, 1], np.int32)[rf]
        parts["l_returnflag"].append(rf_codes)
        parts["l_linestatus"].append(ls_o.astype(np.int32))
        parts["l_shipdate"].append(
            _dates_from_daynum(ship).astype(np.int32))

        # ---- oracle: Q1 ----
        in_q1 = ship <= cutoff_q1
        for rfv, rfs in ((0, "A"), (1, "R"), (2, "N")):
            for lsv, lss in ((False, "F"), (True, "O")):
                m = in_q1 & (rf == rfv) & (ls_o == lsv)
                if not m.any():
                    continue
                g = q1.setdefault((rfs, lss), [0, 0, 0, 0, 0, 0])
                g[0] += int(m.sum())
                g[1] += exact_sum(l_qty[m] * 100)
                g[2] += exact_sum(l_extp[m])
                g[3] += exact_sum(l_extp[m] * (100 - l_disc[m]))
                g[4] += exact_sum(l_extp[m] * (100 - l_disc[m]) *
                                  (100 + l_tax[m]))
                g[5] += exact_sum(l_disc[m])
        # ---- oracle: Q6 ----
        m6 = ((ship >= q6_lo) & (ship < q6_hi) &
              (l_disc >= 5) & (l_disc <= 7) & (l_qty < 24))
        q6_rev += exact_sum(l_extp[m6] * l_disc[m6])

        done += n_orders
        ci += 1
        print(f"chunk {ci}: {done}/{O} orders, {L} lines, "
              f"{time.time()-t0:.0f}s", flush=True)

    cols = {}
    typed = {
        "l_quantity": MONEY, "l_extendedprice": MONEY,
        "l_discount": MONEY, "l_tax": MONEY,
        "l_returnflag": Char(1), "l_linestatus": Char(1),
        "l_shipdate": DATE,
    }
    dicts = {"l_returnflag": Dictionary(["A", "N", "R"]),
             "l_linestatus": Dictionary(["F", "O"])}
    total = 0
    for name, chunks in parts.items():
        arr = np.concatenate(chunks)
        chunks.clear()
        total = len(arr)
        cols[name] = Column(typed[name], arr, None, dicts.get(name))
    print(f"assembled {total} rows in {time.time()-t0:.0f}s", flush=True)

    # oracle out (scaled to display units)
    oracle = {"q1": [], "q6": None, "rows": total}
    for (rfs, lss) in sorted(q1):
        n, sq, sp, sd4, sc6, sdisc = q1[(rfs, lss)]
        oracle["q1"].append({
            "l_returnflag": rfs, "l_linestatus": lss,
            "sum_qty": sq / 100, "sum_base_price": sp / 100,
            "sum_disc_price": sd4 / 10000, "sum_charge": sc6 / 1000000,
            "avg_qty": sq / 100 / n, "avg_price": sp / 100 / n,
            "avg_disc": sdisc / 100 / n, "count_order": n})
    oracle["q6"] = q6_rev / 10000
    with open(os.path.join(REPO_ROOT, "data", "sf100_oracle.json"), "w") as f:
        json.dump(oracle, f)

    # build the store through the normal catalog path
    from quickstep_tpu import Database
    db = Database()
    db.execute(
        "CREATE TABLE lineitem (l_quantity DECIMAL(9,2) NOT NULL, "
        "l_extendedprice DECIMAL(9,2) NOT NULL, "
        "l_discount DECIMAL(9,2) NOT NULL, l_tax DECIMAL(9,2) NOT NULL, "
        "l_returnflag CHAR(1) NOT NULL, l_linestatus CHAR(1) NOT NULL, "
        "l_shipdate DATE NOT NULL)")
    rel = db.catalog.default_database.get_relation("lineitem")
    rel.set_data(TableData(cols))
    _fast_analyze(rel)
    db.config.storage_path = os.path.join(REPO_ROOT, "data/tpch_sf100_li")
    db.save()
    print(f"store saved in {time.time()-t0:.0f}s -> data/tpch_sf100_li",
          flush=True)


def _fast_analyze(rel):
    """Exact stats without np.unique's 600M-row sorts: every column here is
    small-domain int32, so bincount over the offset range is exact and
    linear."""
    from quickstep_tpu.catalog.catalog import (CatalogRelationStatistics,
                                               _stat_value)
    st = CatalogRelationStatistics(exact=True, num_tuples=rel.data.num_rows)
    for a in rel.attributes:
        col = rel.data.columns[a.name]
        arr = np.asarray(col.data)
        lo, hi = int(arr.min()), int(arr.max())
        st.min_values[a.name] = _stat_value(col, arr.min())
        st.max_values[a.name] = _stat_value(col, arr.max())
        counts = np.bincount((arr.astype(np.int64) - lo).astype(np.int64),
                             minlength=hi - lo + 1)
        st.num_distinct[a.name] = int((counts > 0).sum())
        st.max_counts[a.name] = int(counts.max())
    rel.statistics = st


if __name__ == "__main__":
    import sys
    main()
