"""TPC-H data generator (clean-room, vectorized numpy).

Replaces the reference's third-party C dbgen (benchmarks/tpch/dbgen/) with an
independent implementation of the TPC-H schema and distributions: same table
cardinalities per scale factor, the spec's partsupp/lineitem supplier formula (join-key
distribution fidelity), date windows, and comment text with the pattern phrases the
queries probe for ('special…requests', 'Customer…Complaints', 'forest…'). Output is not
byte-identical to official dbgen — correctness is checked against a sqlite3 oracle over
the *same* generated data, so only distributional fidelity matters for benchmarking.

Deterministic for a given (scale, seed).
"""

from __future__ import annotations

import datetime as _dt
from typing import Dict, List

import numpy as np

from quickstep_tpu.types import (
    Type, TypeID, INT, DOUBLE, DATE, Char, VarChar, Decimal,
)
from quickstep_tpu.types.datetime_util import date_encode
from quickstep_tpu.storage.column import Column
from quickstep_tpu.storage.dictionary import Dictionary
from quickstep_tpu.storage.table import TableData

# ---------------------------------------------------------------------
# vocabularies (TPC-H spec 4.2.2.13 style)
# ---------------------------------------------------------------------

REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
INSTRUCTS = ["DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN"]
MODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
TYPE_S1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPE_S2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPE_S3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
CONTAINER_S1 = ["SM", "LG", "MED", "JUMBO", "WRAP"]
CONTAINER_S2 = ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]
COLORS = [
    "almond", "antique", "aquamarine", "azure", "beige", "bisque", "black",
    "blanched", "blue", "blush", "brown", "burlywood", "burnished", "chartreuse",
    "chiffon", "chocolate", "coral", "cornflower", "cornsilk", "cream", "cyan",
    "dark", "deep", "dim", "dodger", "drab", "firebrick", "floral", "forest",
    "frosted", "gainsboro", "ghost", "goldenrod", "green", "grey", "honeydew",
    "hot", "hazelnut", "indian", "ivory", "khaki", "lace", "lavender", "lawn",
    "lemon", "light", "lime", "linen", "magenta", "maroon", "medium", "metallic",
    "midnight", "mint", "misty", "moccasin", "navajo", "navy", "olive", "orange",
    "orchid", "pale", "papaya", "peach", "peru", "pink", "plum", "powder",
    "puff", "purple", "red", "rose", "rosy", "royal", "saddle", "salmon",
    "sandy", "seashell", "sienna", "sky", "slate", "smoke", "snow", "spring",
    "steel", "tan", "thistle", "tomato", "turquoise", "violet", "wheat", "white",
    "yellow",
]
WORDS = COLORS + ["the", "quick", "ironic", "final", "bold", "furious", "slyly",
                  "carefully", "blithely", "express", "regular", "pending",
                  "deposits", "foxes", "pinto", "beans", "accounts", "packages",
                  "theodolites", "instructions", "dependencies", "requests",
                  "platelets", "ideas", "asymptotes", "somas", "dugouts"]

_EPOCH = _dt.date(1992, 1, 1)
_DATE_CODES = None  # lazily built day-number -> packed code lookup


def _date_code_table(n_days: int = 2700) -> np.ndarray:
    global _DATE_CODES
    if _DATE_CODES is None or len(_DATE_CODES) < n_days:
        codes = np.empty(n_days, dtype=np.int32)
        for i in range(n_days):
            d = _EPOCH + _dt.timedelta(days=i)
            codes[i] = date_encode(d.year, d.month, d.day)
        _DATE_CODES = codes
    return _DATE_CODES


def _dates_from_daynum(day_nums: np.ndarray) -> np.ndarray:
    tbl = _date_code_table(int(day_nums.max()) + 1 if day_nums.size else 1)
    return tbl[day_nums]


def _word_matrix(rng, n: int, min_words: int, max_words: int,
                 inject: str = None, inject_prob: float = 0.0):
    """Random word text as (vocab, m): `vocab` is the sorted word list and
    row i of the uint8 matrix `m` holds the 1-based vocab ranks of string
    i's words, 0 past its last word. Optionally append a two-word pattern
    'a of b' so LIKE '%a%b%' predicates select a small fraction."""
    extra = inject.split() + ["of"] if inject else []
    vocab = sorted(set(WORDS) | set(extra))
    rank = {w: i + 1 for i, w in enumerate(vocab)}
    word_rank = np.asarray([rank[w] for w in WORDS], np.uint8)
    counts = rng.integers(min_words, max_words + 1, n)
    idx = rng.integers(0, len(WORDS), (n, max_words))
    m = np.zeros((n, max_words + len(extra)), np.uint8)
    m[:, :max_words] = np.where(np.arange(max_words) < counts[:, None],
                                word_rank[idx], 0)
    if inject:
        w1, w2 = inject.split()
        rows = np.flatnonzero(rng.random(n) < inject_prob)
        for j, w in enumerate((w1, "of", w2)):
            m[rows, counts[rows] + j] = rank[w]
    return vocab, m


def _join_words(vocab: List[str], m: np.ndarray,
                chunk: int = 1 << 20) -> List[str]:
    """' '.join of each row's words, with no Python loop over rows: each
    chunk of rows is gathered as bytes from a table of 'word ' segments and
    split on newlines."""
    seg = [b""] + [w.encode("ascii") + b" " for w in vocab]
    seglen = np.asarray([len(x) for x in seg], np.int64)
    segoff = np.cumsum(seglen) - seglen
    table = np.frombuffer(b"".join(seg), np.uint8)
    out: List[str] = []
    for s in range(0, len(m), chunk):
        block = m[s:s + chunk]
        toks = block[block > 0].astype(np.int64)
        tlen = seglen[toks]
        tstart = np.cumsum(tlen) - tlen
        src = (np.repeat(segoff[toks] - tstart, tlen)
               + np.arange(int(tlen.sum())))
        buf = table[src]
        buf[np.cumsum(seglen[block].sum(axis=1)) - 1] = ord("\n")
        out.extend(buf.tobytes().decode("ascii").split("\n")[:-1])
    return out


def _text_column(rng, n: int, min_words: int, max_words: int,
                 inject: str = None, inject_prob: float = 0.0) -> np.ndarray:
    """Random word strings (see _word_matrix) as an object array."""
    return np.asarray(_join_words(*_word_matrix(
        rng, n, min_words, max_words, inject, inject_prob)), dtype=object)


def _text_col(typ, rng, n: int, min_words: int, max_words: int,
              inject: str = None, inject_prob: float = 0.0) -> Column:
    """Random word text as a dictionary column, without sorting strings.
    Strings compare as their rank rows do: every word character sorts above
    the space, and a string that ends sorts before one that goes on. So the
    rows are packed into integer keys, sorted, and only the distinct ones
    are joined into strings."""
    vocab, m = _word_matrix(rng, n, min_words, max_words, inject, inject_prob)
    bits = len(vocab).bit_length()
    per_key = 63 // bits
    keys = []
    for g in range(0, m.shape[1], per_key):
        k = np.zeros(n, np.uint64)
        for j in range(g, min(g + per_key, m.shape[1])):
            k = (k << np.uint64(bits)) | m[:, j].astype(np.uint64)
        keys.append(k)
    order = np.lexsort(keys[::-1])
    new = np.ones(n, bool)
    if n:
        new[1:] = np.any([np.diff(k[order]) != 0 for k in keys], axis=0)
    codes = np.empty(n, np.int32)
    codes[order] = np.cumsum(new) - 1
    values = _join_words(vocab, m[order[new]]) if n else []
    return Column(typ, codes, None, Dictionary(values))


def _phone(rng, nation: np.ndarray) -> np.ndarray:
    a = (nation + 10).astype(str)
    b = rng.integers(100, 1000, len(nation)).astype(str)
    c = rng.integers(100, 1000, len(nation)).astype(str)
    d = rng.integers(1000, 10000, len(nation)).astype(str)
    out = np.char.add(np.char.add(a, "-"), b)
    out = np.char.add(np.char.add(out, "-"), c)
    out = np.char.add(np.char.add(out, "-"), d)
    return out


# Money columns are DECIMAL(9,2): generated directly as exact integer cents
# (the scaled-units device encoding, types/types.py DECIMAL), so no float
# rounding ever enters the stored data.
MONEY = Decimal(9, 2)


def _money_units(rng, lo_cents: int, hi_cents: int, n: int) -> np.ndarray:
    return rng.integers(lo_cents, hi_cents + 1, n)


def _col_str(typ, values: List[str]) -> Column:
    d, codes = Dictionary.build(values)
    return Column(typ, codes, None, d)


def _col_cat(typ, vocab: List[str], idx: np.ndarray) -> Column:
    """String column whose row i is vocab[idx[i]]: the dictionary holds the
    values that occur, and no per-row string is made."""
    vocab = np.asarray(vocab)
    used = np.flatnonzero(np.bincount(idx, minlength=len(vocab)))
    d, used_codes = Dictionary.build(vocab[used])
    lut = np.zeros(len(vocab), np.int32)
    lut[used] = used_codes
    return Column(typ, lut[idx], None, d)


def _col(typ, arr) -> Column:
    return Column(typ, np.asarray(arr, dtype=typ.device_dtype), None, None)


# ---------------------------------------------------------------------

def generate(scale: float = 0.01, seed: int = 0) -> Dict[str, TableData]:
    """Generate all 8 TPC-H tables at the given scale factor."""
    rng = np.random.default_rng(seed)
    S = max(int(10_000 * scale), 10)        # suppliers
    P = max(int(200_000 * scale), 200)      # parts
    C = max(int(150_000 * scale), 150)      # customers
    O = max(int(1_500_000 * scale), 1500)   # orders
    out: Dict[str, TableData] = {}

    # ---- region ----
    out["region"] = TableData({
        "r_regionkey": _col(INT, np.arange(5)),
        "r_name": _col_str(Char(25), REGIONS),
        "r_comment": _col_str(VarChar(152), _text_column(rng, 5, 4, 10)),
    })

    # ---- nation ----
    nk = np.arange(25)
    out["nation"] = TableData({
        "n_nationkey": _col(INT, nk),
        "n_name": _col_str(Char(25), [n for n, _ in NATIONS]),
        "n_regionkey": _col(INT, np.asarray([r for _, r in NATIONS])),
        "n_comment": _col_str(VarChar(152), _text_column(rng, 25, 4, 10)),
    })

    # ---- supplier ----
    sk = np.arange(1, S + 1)
    s_nation = rng.integers(0, 25, S)
    out["supplier"] = TableData({
        "s_suppkey": _col(INT, sk),
        "s_name": _col_str(Char(25), np.char.add("Supplier#",
            np.char.zfill(sk.astype(str), 9))),
        "s_address": _text_col(VarChar(40), rng, S, 2, 4),
        "s_nationkey": _col(INT, s_nation),
        "s_phone": _col_str(Char(15), _phone(rng, s_nation)),
        "s_acctbal": _col(MONEY, _money_units(rng, -99999, 999999, S)),
        # Q16 probes '%Customer%Complaints%'
        "s_comment": _text_col(VarChar(101), rng, S, 5, 12,
                               inject="Customer Complaints",
                               inject_prob=0.0005),
    })

    # ---- part ----
    pk = np.arange(1, P + 1)
    name_words = np.array(COLORS)
    pidx = rng.integers(0, len(COLORS), (P, 5))
    pname = name_words[pidx[:, 0]]
    for j in range(1, 5):
        pname = np.char.add(np.char.add(pname, " "), name_words[pidx[:, j]])
    p_mfgr_i = rng.integers(1, 6, P)
    p_brand_i = p_mfgr_i * 10 + rng.integers(1, 6, P)
    t1 = rng.integers(0, 6, P)
    t2 = rng.integers(0, 5, P)
    t3 = rng.integers(0, 5, P)
    ptypes = [f"{a} {b} {c}" for a in TYPE_S1 for b in TYPE_S2
              for c in TYPE_S3]
    c1 = rng.integers(0, 5, P)
    c2 = rng.integers(0, 8, P)
    containers = [f"{a} {b}" for a in CONTAINER_S1 for b in CONTAINER_S2]
    # spec retail price formula (keeps price/partkey correlation) — the spec
    # formula is already integer cents
    p_retail_cents = 90000 + ((pk // 10) % 20001) + 100 * (pk % 1000)
    out["part"] = TableData({
        "p_partkey": _col(INT, pk),
        "p_name": _col_str(VarChar(55), pname),
        "p_mfgr": _col_cat(Char(25), [f"Manufacturer#{i}" for i in range(6)],
                           p_mfgr_i),
        "p_brand": _col_cat(Char(10), [f"Brand#{i}" for i in range(56)],
                            p_brand_i),
        "p_type": _col_cat(VarChar(25), ptypes, (t1 * 5 + t2) * 5 + t3),
        "p_size": _col(INT, rng.integers(1, 51, P)),
        "p_container": _col_cat(Char(10), containers, c1 * 8 + c2),
        "p_retailprice": _col(MONEY, p_retail_cents),
        "p_comment": _text_col(VarChar(23), rng, P, 2, 5),
    })

    # ---- partsupp (spec supplier-assignment formula: 4 suppliers per part) ----
    ps_part = np.repeat(pk, 4)
    i4 = np.tile(np.arange(4), P)
    ps_supp = ((ps_part + i4 * (S // 4 + (ps_part - 1) // S)) % S) + 1
    PS = len(ps_part)
    out["partsupp"] = TableData({
        "ps_partkey": _col(INT, ps_part),
        "ps_suppkey": _col(INT, ps_supp.astype(np.int64)),
        "ps_availqty": _col(INT, rng.integers(1, 10_000, PS)),
        "ps_supplycost": _col(MONEY, _money_units(rng, 100, 100000, PS)),
        "ps_comment": _text_col(VarChar(199), rng, PS, 4, 10),
    })

    # ---- customer ----
    ck = np.arange(1, C + 1)
    c_nation = rng.integers(0, 25, C)
    out["customer"] = TableData({
        "c_custkey": _col(INT, ck),
        "c_name": _col_str(VarChar(25), np.char.add("Customer#",
            np.char.zfill(ck.astype(str), 9))),
        "c_address": _text_col(VarChar(40), rng, C, 2, 4),
        "c_nationkey": _col(INT, c_nation),
        "c_phone": _col_str(Char(15), _phone(rng, c_nation)),
        "c_acctbal": _col(MONEY, _money_units(rng, -99999, 999999, C)),
        "c_mktsegment": _col_cat(Char(10), SEGMENTS, rng.integers(0, 5, C)),
        "c_comment": _text_col(VarChar(117), rng, C, 5, 12,
                               inject="special requests", inject_prob=0.01),
    })

    # ---- orders (sparse keys x4; only customers with custkey%3 != 0) ----
    ok = np.arange(1, O + 1) * 4
    eligible = ck[ck % 3 != 0]
    o_cust = eligible[rng.integers(0, len(eligible), O)]
    # order dates: 1992-01-01 .. 1998-08-02 (2405 days)
    o_daynum = rng.integers(0, 2406, O)
    o_date = _dates_from_daynum(o_daynum)
    n_clerks = max(int(1000 * scale), 10)
    out["orders"] = TableData({
        "o_orderkey": _col(INT, ok),
        "o_custkey": _col(INT, o_cust),
        "o_orderstatus": None,      # filled after lineitem
        "o_totalprice": None,       # filled after lineitem
        "o_orderdate": _col(DATE, o_date),
        "o_orderpriority": _col_cat(Char(15), PRIORITIES,
                                    rng.integers(0, 5, O)),
        "o_clerk": _col_cat(Char(15), [f"Clerk#{i:09d}" for i in
                                       range(n_clerks + 1)],
                            rng.integers(1, n_clerks + 1, O)),
        "o_shippriority": _col(INT, np.zeros(O, np.int64)),
        "o_comment": _text_col(VarChar(79), rng, O, 5, 12),
    })

    # ---- lineitem ----
    lines_per = rng.integers(1, 8, O)
    L = int(lines_per.sum())
    l_order = np.repeat(ok, lines_per)
    l_orderdate_daynum = np.repeat(o_daynum, lines_per)
    # vectorized 1..k per order: global index minus each row's order start
    ends = np.cumsum(lines_per)
    starts_ = ends - lines_per
    l_linenumber = np.arange(L) - np.repeat(starts_, lines_per) + 1
    l_part = rng.integers(1, P + 1, L)
    li4 = rng.integers(0, 4, L)
    l_supp = ((l_part + li4 * (S // 4 + (l_part - 1) // S)) % S) + 1
    l_qty = rng.integers(1, 51, L)                       # whole units
    l_extp_c = l_qty * p_retail_cents[l_part - 1]        # exact cents
    l_disc_u = rng.integers(0, 11, L)                    # 0.00..0.10 in cents
    l_tax_u = rng.integers(0, 9, L)                      # 0.00..0.08 in cents
    ship_daynum = l_orderdate_daynum + rng.integers(1, 122, L)
    commit_daynum = l_orderdate_daynum + rng.integers(30, 91, L)
    receipt_daynum = ship_daynum + rng.integers(1, 31, L)
    cutoff = (_dt.date(1995, 6, 17) - _EPOCH).days
    returnable = receipt_daynum <= cutoff
    rf = np.where(returnable,
                  np.where(rng.random(L) < 0.5, 0, 1),  # R or A
                  2)                                     # N
    open_line = ship_daynum > cutoff                      # 'O', else 'F'
    out["lineitem"] = TableData({
        "l_orderkey": _col(INT, l_order),
        "l_partkey": _col(INT, l_part),
        "l_suppkey": _col(INT, l_supp.astype(np.int64)),
        "l_linenumber": _col(INT, l_linenumber),
        "l_quantity": _col(MONEY, l_qty * 100),
        "l_extendedprice": _col(MONEY, l_extp_c),
        "l_discount": _col(MONEY, l_disc_u),
        "l_tax": _col(MONEY, l_tax_u),
        "l_returnflag": _col_cat(Char(1), ["A", "R", "N"], rf),
        "l_linestatus": _col_cat(Char(1), ["F", "O"],
                                 open_line.astype(np.intp)),
        "l_shipdate": _col(DATE, _dates_from_daynum(ship_daynum)),
        "l_commitdate": _col(DATE, _dates_from_daynum(commit_daynum)),
        "l_receiptdate": _col(DATE, _dates_from_daynum(receipt_daynum)),
        "l_shipinstruct": _col_cat(Char(25), INSTRUCTS, rng.integers(0, 4, L)),
        "l_shipmode": _col_cat(Char(10), MODES, rng.integers(0, 7, L)),
        "l_comment": _text_col(VarChar(44), rng, L, 2, 5),
    })

    # ---- orders columns derived from lineitems ----
    # o_totalprice = sum(extp*(1+tax)*(1-disc)); o_orderstatus: F if all lines F,
    # O if all lines O, else P
    order_idx = np.repeat(np.arange(O), lines_per)
    # exact integer: per-line cents*(100+tax)*(100-disc) is scale-6 units;
    # the order total rounds the summed scale-6 value half-up to cents
    totals6 = np.zeros(O, np.int64)
    np.add.at(totals6, order_idx,
              l_extp_c.astype(np.int64) * (100 + l_tax_u) * (100 - l_disc_u))
    f_cnt = np.zeros(O, np.int64)
    np.add.at(f_cnt, order_idx, (~open_line).astype(np.int64))
    status = np.where(f_cnt == lines_per, 0, np.where(f_cnt == 0, 1, 2))
    out["orders"].columns["o_orderstatus"] = _col_cat(
        Char(1), ["F", "O", "P"], status)
    out["orders"].columns["o_totalprice"] = _col(MONEY, (totals6 + 5000) // 10000)

    return out


TPCH_SCHEMAS = {
    "region": [("r_regionkey", INT), ("r_name", Char(25)),
               ("r_comment", VarChar(152))],
    "nation": [("n_nationkey", INT), ("n_name", Char(25)),
               ("n_regionkey", INT), ("n_comment", VarChar(152))],
    "supplier": [("s_suppkey", INT), ("s_name", Char(25)),
                 ("s_address", VarChar(40)), ("s_nationkey", INT),
                 ("s_phone", Char(15)), ("s_acctbal", MONEY),
                 ("s_comment", VarChar(101))],
    "part": [("p_partkey", INT), ("p_name", VarChar(55)), ("p_mfgr", Char(25)),
             ("p_brand", Char(10)), ("p_type", VarChar(25)), ("p_size", INT),
             ("p_container", Char(10)), ("p_retailprice", MONEY),
             ("p_comment", VarChar(23))],
    "partsupp": [("ps_partkey", INT), ("ps_suppkey", INT),
                 ("ps_availqty", INT), ("ps_supplycost", MONEY),
                 ("ps_comment", VarChar(199))],
    "customer": [("c_custkey", INT), ("c_name", VarChar(25)),
                 ("c_address", VarChar(40)), ("c_nationkey", INT),
                 ("c_phone", Char(15)), ("c_acctbal", MONEY),
                 ("c_mktsegment", Char(10)), ("c_comment", VarChar(117))],
    "orders": [("o_orderkey", INT), ("o_custkey", INT),
               ("o_orderstatus", Char(1)), ("o_totalprice", MONEY),
               ("o_orderdate", DATE), ("o_orderpriority", Char(15)),
               ("o_clerk", Char(15)), ("o_shippriority", INT),
               ("o_comment", VarChar(79))],
    "lineitem": [("l_orderkey", INT), ("l_partkey", INT), ("l_suppkey", INT),
                 ("l_linenumber", INT), ("l_quantity", MONEY),
                 ("l_extendedprice", MONEY), ("l_discount", MONEY),
                 ("l_tax", MONEY), ("l_returnflag", Char(1)),
                 ("l_linestatus", Char(1)), ("l_shipdate", DATE),
                 ("l_commitdate", DATE), ("l_receiptdate", DATE),
                 ("l_shipinstruct", Char(25)), ("l_shipmode", Char(10)),
                 ("l_comment", VarChar(44))],
}
