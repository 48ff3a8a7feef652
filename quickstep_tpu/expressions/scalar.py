"""Resolved scalar/predicate expression IR with vectorized JAX evaluation.

The device-side replacement for BOTH the reference's optimizer expression IR
(query_optimizer/expressions/, AttributeReference with global ExprId) and its runtime
expression trees (expressions/scalar/Scalar.hpp:51 getAllValues -> ColumnVector;
expressions/predicate/Predicate.hpp:47 getAllMatches -> TupleIdSequence). One IR serves
both roles: the resolver types it, the optimizer rewrites it, and `eval()` traces it into
jnp ops over whole columns — XLA fuses the resulting elementwise graph into the enclosing
query stage (replacing the template-metaprogramming kernels in
types/operations/*/ *Operators.hpp).

Value model: every expression evaluates to (data: jnp array over rows, valid) where
valid is None (all valid) or a bool array — SQL three-valued logic: predicates produce
(bool data, valid); a row passes WHERE iff data & valid.

Strings never appear at runtime: the resolver lowers string comparisons to ordered
dictionary-code comparisons, LIKE/REGEXP/IN to dictionary bitmaps (DictBitmapProbe),
and SUBSTRING/case-changes to host-side dictionary remaps (see storage/dictionary.py).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from quickstep_tpu.types import Type, TypeID, DOUBLE, LONG, INT, DATE

Array = object  # jnp array
ValuePair = Tuple[Array, Optional[Array]]


class EvalContext:
    """Maps attribute ExprIds -> (data, valid) columns for the current operator
    input. `fetch` is the owning Chunk's materializer: slots may hold LazyCol
    gather maps (late materialization, exec/chunk.py) which are resolved — and
    cached back into the chunk — on first lookup."""

    def __init__(self, slots: Dict[int, ValuePair], fetch=None):
        self.slots = slots
        self.fetch = fetch

    def lookup(self, expr_id: int) -> ValuePair:
        v = self.slots[expr_id]
        if getattr(v, "lazy", False):
            v = self.fetch(expr_id)
            self.slots[expr_id] = v
        return v


@dataclasses.dataclass
class Expr:
    """Base resolved expression. `type` is the SQL result type."""
    type: Type = dataclasses.field(default=INT, kw_only=True)

    def eval(self, ctx: EvalContext) -> ValuePair:
        raise NotImplementedError

    def children(self) -> List["Expr"]:
        return []

    def referenced_attrs(self) -> set:
        out = set()
        stack = [self]
        while stack:
            e = stack.pop()
            if isinstance(e, Attr):
                out.add(e.expr_id)
            stack.extend(e.children())
        return out

    def key(self) -> tuple:
        """Structural fingerprint for plan caching / common-subexpression detection."""
        return (type(self).__name__,) + tuple(
            c.key() for c in self.children())


@dataclasses.dataclass
class Attr(Expr):
    """Reference to a resolved attribute by global ExprId (the reference's
    AttributeReference, query_optimizer/expressions/AttributeReference.hpp)."""
    expr_id: int = -1
    name: str = ""

    def eval(self, ctx: EvalContext) -> ValuePair:
        return ctx.lookup(self.expr_id)

    def key(self) -> tuple:
        return ("attr", self.expr_id)


@dataclasses.dataclass
class Lit(Expr):
    value: object = None  # python scalar in device encoding; None = NULL literal

    def eval(self, ctx: EvalContext) -> ValuePair:
        # Scalar broadcast: rely on jnp broadcasting against row arrays.
        if self.value is None:
            return jnp.zeros((), dtype=self.type.device_dtype), jnp.zeros((), bool)
        return jnp.asarray(self.value, dtype=self.type.device_dtype), None

    def key(self) -> tuple:
        d = getattr(self, "_dictionary", None)
        # dictionary-coded string literals: the code alone doesn't identify the
        # value — include the decoded string in the fingerprint
        if d is not None and isinstance(self.value, int) and \
                0 <= self.value < len(d.values):
            return ("lit", d.values[self.value], int(self.type.type_id))
        return ("lit", self.value, int(self.type.type_id), self.type.scale)


def _combine_valid(*valids):
    out = None
    for v in valids:
        if v is None:
            continue
        out = v if out is None else (out & v)
    return out


_ARITH = {
    "+": jnp.add,
    "-": jnp.subtract,
    "*": jnp.multiply,
    "%": jnp.mod,
}


@dataclasses.dataclass
class Arith(Expr):
    """+ - * / % with SQL numeric promotion (BinaryOperation.hpp:298 analog)."""
    op: str = "+"
    lhs: Expr = None
    rhs: Expr = None

    def children(self):
        return [self.lhs, self.rhs]

    def eval(self, ctx: EvalContext) -> ValuePair:
        a, va = self.lhs.eval(ctx)
        b, vb = self.rhs.eval(ctx)
        dt = self.type.device_dtype
        a = a.astype(dt)
        b = b.astype(dt)
        if self.op == "/":
            if self.type.is_integral:
                # SQL integer division truncates toward zero; guard /0 (returns 0 with
                # valid=False semantics left to the caller — reference raises; we null).
                safe_b = jnp.where(b == 0, jnp.ones_like(b), b)
                q = jnp.trunc(a.astype(jnp.float64) / safe_b.astype(jnp.float64))
                data = q.astype(dt)
                vb = _combine_valid(vb, b != 0)
            else:
                safe_b = jnp.where(b == 0, jnp.ones_like(b), b)
                data = a / safe_b
                vb = _combine_valid(vb, b != 0)
        elif self.op == "%":
            # C semantics, matching the reference (ArithmeticBinaryOperators.hpp:
            # 143 integer `%` truncated toward zero, :154 std::fmod for floats;
            # jnp.mod is floored and would flip signs). `+ 0.0` canonicalizes
            # the -0.0 that fmod yields for negative operands with zero
            # remainder — the reference corpus prints it as "0".
            safe_b = jnp.where(b == 0, jnp.ones_like(b), b)
            if self.type.is_integral:
                rem = jax.lax.rem(a, safe_b)
            else:
                rem = jnp.fmod(a, safe_b)
                # canonicalize fmod's -0.0 (negative operand, zero remainder)
                # to +0.0 as the reference corpus prints
                rem = jnp.where(rem == 0, jnp.zeros_like(rem), rem)
            data = jnp.where(b == 0, jnp.zeros_like(a), rem)
            vb = _combine_valid(vb, b != 0)
        else:
            data = _ARITH[self.op](a, b)
        return data, _combine_valid(va, vb)

    def key(self):
        return ("arith", self.op, self.lhs.key(), self.rhs.key())


_CMP = {
    "=": jnp.equal,
    "<>": jnp.not_equal,
    "<": jnp.less,
    "<=": jnp.less_equal,
    ">": jnp.greater,
    ">=": jnp.greater_equal,
}


@dataclasses.dataclass
class Cmp(Expr):
    """Comparison predicate (Comparison.hpp:503 analog). Operands are pre-unified by
    the resolver (string comparisons arrive as dictionary-code comparisons)."""
    op: str = "="
    lhs: Expr = None
    rhs: Expr = None

    def children(self):
        return [self.lhs, self.rhs]

    def eval(self, ctx: EvalContext) -> ValuePair:
        a, va = self.lhs.eval(ctx)
        b, vb = self.rhs.eval(ctx)
        if jnp.asarray(a).dtype != jnp.asarray(b).dtype:
            common = jnp.promote_types(jnp.asarray(a).dtype, jnp.asarray(b).dtype)
            a = a.astype(common)
            b = b.astype(common)
        return _CMP[self.op](a, b), _combine_valid(va, vb)

    def key(self):
        return ("cmp", self.op, self.lhs.key(), self.rhs.key())


@dataclasses.dataclass
class Logical(Expr):
    """AND/OR with Kleene three-valued logic (ConjunctionPredicate analog)."""
    op: str = "AND"
    operands: List[Expr] = dataclasses.field(default_factory=list)

    def children(self):
        return self.operands

    def eval(self, ctx: EvalContext) -> ValuePair:
        datas, valids = [], []
        for o in self.operands:
            d, v = o.eval(ctx)
            datas.append(d)
            valids.append(v)
        if self.op == "AND":
            data = datas[0]
            for d in datas[1:]:
                data = data & d
            # AND is null only if no operand is definitively false and some is null
            if all(v is None for v in valids):
                return data, None
            any_false = jnp.zeros_like(data)
            all_known = None
            for d, v in zip(datas, valids):
                if v is None:
                    any_false = any_false | ~d
                else:
                    any_false = any_false | (v & ~d)
                    all_known = v if all_known is None else (all_known & v)
            valid = any_false | (all_known if all_known is not None
                                 else jnp.ones_like(data))
            return data, valid
        else:  # OR
            data = datas[0]
            for d in datas[1:]:
                data = data | d
            if all(v is None for v in valids):
                return data, None
            any_true = jnp.zeros_like(data)
            all_known = None
            for d, v in zip(datas, valids):
                if v is None:
                    any_true = any_true | d
                else:
                    any_true = any_true | (v & d)
                    all_known = v if all_known is None else (all_known & v)
            valid = any_true | (all_known if all_known is not None
                                else jnp.ones_like(data))
            return data, valid

    def key(self):
        return ("logical", self.op) + tuple(o.key() for o in self.operands)


@dataclasses.dataclass
class Not(Expr):
    operand: Expr = None

    def children(self):
        return [self.operand]

    def eval(self, ctx: EvalContext) -> ValuePair:
        d, v = self.operand.eval(ctx)
        return ~d, v

    def key(self):
        return ("not", self.operand.key())


@dataclasses.dataclass
class IsNull(Expr):
    operand: Expr = None
    negated: bool = False

    def children(self):
        return [self.operand]

    def eval(self, ctx: EvalContext) -> ValuePair:
        d, v = self.operand.eval(ctx)
        if v is None:
            res = jnp.zeros(jnp.shape(d), dtype=bool)
        else:
            res = ~v
        if self.negated:
            res = ~res if v is not None else jnp.ones(jnp.shape(d), dtype=bool)
        return res, None

    def key(self):
        return ("isnull", self.negated, self.operand.key())


@dataclasses.dataclass
class Case(Expr):
    """Searched CASE (ScalarCaseExpression analog). when_clauses: [(pred, result)]."""
    when_clauses: List[Tuple[Expr, Expr]] = dataclasses.field(default_factory=list)
    else_result: Optional[Expr] = None

    def children(self):
        out = []
        for c, r in self.when_clauses:
            out.extend([c, r])
        if self.else_result is not None:
            out.append(self.else_result)
        return out

    def eval(self, ctx: EvalContext) -> ValuePair:
        dt = self.type.device_dtype
        if self.else_result is not None:
            data, valid = self.else_result.eval(ctx)
            data = jnp.asarray(data, dtype=dt)
        else:
            data, valid = jnp.zeros((), dtype=dt), jnp.zeros((), dtype=bool)
        # Build from last WHEN to first so earlier WHENs take precedence.
        for cond, res in reversed(self.when_clauses):
            cd, cv = cond.eval(ctx)
            rd, rv = res.eval(ctx)
            rd = jnp.asarray(rd, dtype=dt)
            take = cd if cv is None else (cd & cv)
            data, valid = _broadcast_where(take, rd, rv, data, valid)
        return data, valid

    def key(self):
        return ("case",) + tuple((c.key(), r.key()) for c, r in self.when_clauses) + \
            (self.else_result.key() if self.else_result else None,)


def _broadcast_where(cond, a, va, b, vb):
    data = jnp.where(cond, a, b)
    if va is None and vb is None:
        return data, None
    va_ = va if va is not None else jnp.ones((), bool)
    vb_ = vb if vb is not None else jnp.ones((), bool)
    return data, jnp.where(cond, va_, vb_)


@dataclasses.dataclass
class Cast(Expr):
    """Numeric/date casts (NumericCastOperation analog). Decimal casts
    rescale the integer units representation (types/types.py DECIMAL)."""
    operand: Expr = None

    def children(self):
        return [self.operand]

    def eval(self, ctx: EvalContext) -> ValuePair:
        d, v = self.operand.eval(ctx)
        src, dst = self.operand.type, self.type
        if src.is_decimal or dst.is_decimal:
            return _decimal_cast(d, src, dst), v
        return d.astype(self.type.device_dtype), v

    def key(self):
        return ("cast", int(self.type.type_id), self.type.scale,
                self.operand.key())


def _decimal_cast(d, src, dst):
    """Convert between decimal units and other numeric encodings."""
    if src.is_decimal and dst.is_decimal:
        if dst.scale == src.scale:
            return d.astype(dst.device_dtype)
        if dst.scale > src.scale:
            return d.astype(jnp.int64) * (10 ** (dst.scale - src.scale))
        return jax.lax.div(d.astype(jnp.int64),
                           jnp.asarray(10 ** (src.scale - dst.scale),
                                       jnp.int64)).astype(dst.device_dtype)
    if src.is_decimal:
        if dst.is_floating:
            return (d.astype(dst.device_dtype) *
                    jnp.asarray(10.0 ** -src.scale, dst.device_dtype))
        # decimal -> integral truncates toward zero (C cast semantics)
        return jax.lax.div(d.astype(jnp.int64),
                           jnp.asarray(10 ** src.scale,
                                       jnp.int64)).astype(dst.device_dtype)
    # numeric -> decimal
    if src.is_integral:
        return (d.astype(jnp.int64) * (10 ** dst.scale)).astype(
            dst.device_dtype)
    return jnp.round(d.astype(jnp.float64) * (10.0 ** dst.scale)).astype(
        dst.device_dtype)


@dataclasses.dataclass
class DecimalToDouble(Expr):
    """Decode a decimal (scaled-integer) expression to its DOUBLE value:
    units * 10^-scale. Inserted by the resolver wherever decimal semantics
    must leave the exact integer domain (division, mixed-type arithmetic,
    inexact literals) — everything else stays native int on device."""
    operand: Expr = None

    def children(self):
        return [self.operand]

    def eval(self, ctx: EvalContext) -> ValuePair:
        d, v = self.operand.eval(ctx)
        s = self.operand.type.scale
        return d.astype(jnp.float64) * jnp.asarray(10.0 ** -s, jnp.float64), v

    def key(self):
        return ("dec2f", self.operand.type.scale, self.operand.key())


@dataclasses.dataclass
class ExtractDate(Expr):
    """EXTRACT(field FROM date/datetime) (DateExtractOperation analog).

    DATE packed encoding (y<<9|m<<5|d) makes year/month/day shifts; DATETIME (us since
    epoch) fields go through day-number arithmetic on device.
    """
    field: str = "year"
    operand: Expr = None

    def children(self):
        return [self.operand]

    def eval(self, ctx: EvalContext) -> ValuePair:
        d, v = self.operand.eval(ctx)
        if self.operand.type.type_id == TypeID.DATE:
            if self.field == "year":
                return (d >> 9).astype(jnp.int32), v
            if self.field == "month":
                return ((d >> 5) & 0xF).astype(jnp.int32), v
            if self.field == "day":
                return (d & 0x1F).astype(jnp.int32), v
            raise ValueError(f"cannot EXTRACT {self.field} from DATE")
        # DATETIME: microseconds since epoch
        us = d
        if self.field == "second":
            return ((us // 1_000_000) % 60).astype(jnp.int32), v
        if self.field == "minute":
            return ((us // 60_000_000) % 60).astype(jnp.int32), v
        if self.field == "hour":
            return ((us // 3_600_000_000) % 24).astype(jnp.int32), v
        # year/month/day require civil-date conversion (Howard Hinnant algorithm,
        # branchless — vectorizes cleanly).
        days = (us // 86_400_000_000).astype(jnp.int64)
        z = days + 719468
        era = jnp.floor_divide(jnp.where(z >= 0, z, z - 146096), 146097)
        doe = z - era * 146097
        yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
        y = yoe + era * 400
        doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
        mp = (5 * doy + 2) // 153
        day = doy - (153 * mp + 2) // 5 + 1
        month = jnp.where(mp < 10, mp + 3, mp - 9)
        year = jnp.where(month <= 2, y + 1, y)
        if self.field == "year":
            return year.astype(jnp.int32), v
        if self.field == "month":
            return month.astype(jnp.int32), v
        if self.field == "day":
            return day.astype(jnp.int32), v
        raise ValueError(f"cannot EXTRACT {self.field}")

    def key(self):
        return ("extract", self.field, self.operand.key())


@dataclasses.dataclass
class InSet(Expr):
    """operand IN (small literal set) — unrolled equality OR (EqualsAnyConstant
    analog, utility/EqualsAnyConstant.hpp)."""
    operand: Expr = None
    values: Tuple = ()
    negated: bool = False

    def children(self):
        return [self.operand]

    def eval(self, ctx: EvalContext) -> ValuePair:
        d, v = self.operand.eval(ctx)
        res = jnp.zeros(jnp.shape(d), dtype=bool)
        for val in self.values:
            res = res | (d == jnp.asarray(val, dtype=d.dtype))
        if self.negated:
            res = ~res
        return res, v

    def key(self):
        return ("inset", self.values, self.negated, self.operand.key())


@dataclasses.dataclass
class DictBitmapProbe(Expr):
    """String predicate evaluated on the ordered dictionary: `bitmap[code]`.

    LIKE / REGEXP / IN-over-strings become a host-computed bool bitmap over dictionary
    codes; on device the probe is a single gather — the device analog of the reference
    evaluating comparisons directly on compressed codes
    (compression/CompressionDictionary.hpp:64) and of LIP bitmap probing.
    """
    operand: Expr = None
    bitmap: object = None  # np.ndarray[bool], len == dictionary size
    negated: bool = False

    def children(self):
        return [self.operand]

    def eval(self, ctx: EvalContext) -> ValuePair:
        d, v = self.operand.eval(ctx)
        bm = jnp.asarray(np.asarray(self.bitmap))
        codes = jnp.clip(d, 0, bm.shape[0] - 1)
        res = bm[codes]
        if self.negated:
            res = ~res
        return res, v

    def key(self):
        bm = np.asarray(self.bitmap)
        return ("dictbitmap", hash(bm.tobytes()), self.negated, self.operand.key())


def _days_from_civil(y, m, d):
    """Howard Hinnant's branchless civil-date -> day-number (all int ops,
    jittable). Day 0 = 1970-01-01."""
    y = y - (m <= 2)
    era = jnp.floor_divide(jnp.where(y >= 0, y, y - 399), 400)
    yoe = y - era * 400
    doy = jnp.floor_divide(153 * (m + jnp.where(m > 2, -3, 9)) + 2, 5) + d - 1
    doe = yoe * 365 + jnp.floor_divide(yoe, 4) - jnp.floor_divide(yoe, 100) \
        + doy
    return era * 146097 + doe - 719468


def _civil_from_days(z):
    """Inverse of _days_from_civil; returns (y, m, d)."""
    z = z + 719468
    era = jnp.floor_divide(jnp.where(z >= 0, z, z - 146096), 146097)
    doe = z - era * 146097
    yoe = jnp.floor_divide(
        doe - jnp.floor_divide(doe, 1460) + jnp.floor_divide(doe, 36524)
        - jnp.floor_divide(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + jnp.floor_divide(yoe, 4)
                 - jnp.floor_divide(yoe, 100))
    mp = jnp.floor_divide(5 * doy + 2, 153)
    d = doy - jnp.floor_divide(153 * mp + 2, 5) + 1
    m = mp + jnp.where(mp < 10, 3, -9)
    return y + (m <= 2), m, d


def _device_days_in_month(y, m):
    lengths = jnp.asarray([31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31],
                          dtype=jnp.int32)
    base = lengths[jnp.clip(m - 1, 0, 11)]
    leap = ((y % 4 == 0) & (y % 100 != 0)) | (y % 400 == 0)
    return jnp.where((m == 2) & leap, 29, base)


@dataclasses.dataclass
class DateArith(Expr):
    """DATE/DATETIME column ± a literal interval, evaluated on device
    (the reference's DateOperatorOverloads.hpp / vectorized
    ArithmeticBinaryOperators applied to Datetime/Date columns)."""
    op: str = "+"            # + | -
    operand: Expr = None     # DATE (packed int32 code) or DATETIME (int64 us)
    months: int = 0          # YEARMONTH_INTERVAL amount
    us: int = 0              # DATETIME_INTERVAL amount

    def children(self):
        return [self.operand]

    def eval(self, ctx: EvalContext) -> ValuePair:
        d, v = self.operand.eval(ctx)
        sign = 1 if self.op == "+" else -1
        if self.operand.type.type_id == TypeID.DATETIME:
            return d + sign * self.us, v
        # DATE packed code (y<<9 | m<<5 | d)
        y = d >> 9
        m = (d >> 5) & 0xF
        dd = d & 0x1F
        if self.months:
            t = y * 12 + (m - 1) + sign * self.months
            ny = jnp.floor_divide(t, 12)
            nm = t - ny * 12 + 1
            nd = jnp.minimum(dd, _device_days_in_month(ny, nm))
        else:
            days = sign * (self.us // 86_400_000_000)
            z = _days_from_civil(y, m, dd) + days
            ny, nm, nd = _civil_from_days(z)
        return ((ny << 9) | (nm << 5) | nd).astype(d.dtype), v

    def key(self):
        return ("datearith", self.op, self.months, self.us, self.operand.key())


@dataclasses.dataclass
class DictMatrixProbe(Expr):
    """Two-column string predicate (e.g. `email LIKE pattern` where both sides
    are dictionary columns): a host-precomputed bool matrix over the two
    dictionaries, probed on device as a flat gather — the device analog of the
    reference's per-row re2 matching (PatternMatchingComparison.cpp)."""
    lhs: Expr = None
    rhs: Expr = None
    matrix: object = None  # np.ndarray[bool] shape (|ldict|, |rdict|)
    negated: bool = False

    def children(self):
        return [self.lhs, self.rhs]

    def eval(self, ctx: EvalContext) -> ValuePair:
        ld, lv = self.lhs.eval(ctx)
        rd, rv = self.rhs.eval(ctx)
        m = jnp.asarray(np.asarray(self.matrix).reshape(-1))
        ncols = np.asarray(self.matrix).shape[1]
        li = jnp.clip(ld, 0, np.asarray(self.matrix).shape[0] - 1)
        ri = jnp.clip(rd, 0, ncols - 1)
        res = m[li * ncols + ri]
        if self.negated:
            res = ~res
        return res, _combine_valid(lv, rv)

    def key(self):
        m = np.asarray(self.matrix)
        return ("dictmatrix", hash(m.tobytes()), self.negated,
                self.lhs.key(), self.rhs.key())


@dataclasses.dataclass
class Substr(Expr):
    """SUBSTRING lowered to a dictionary remap: codes pass through remap array
    (host-computed in the resolver via Dictionary.map_values)."""
    operand: Expr = None
    remap: object = None  # np.ndarray[int32] old code -> new code

    def children(self):
        return [self.operand]

    def eval(self, ctx: EvalContext) -> ValuePair:
        d, v = self.operand.eval(ctx)
        rm = jnp.asarray(np.asarray(self.remap))
        codes = jnp.clip(d, 0, rm.shape[0] - 1)
        return rm[codes], v

    def key(self):
        rm = np.asarray(self.remap)
        return ("substr", hash(rm.tobytes()), self.operand.key())


TRUE_PRED = Lit(value=1, type=Type(TypeID.INT))


def make_and(preds: List[Expr]) -> Optional[Expr]:
    preds = [p for p in preds if p is not None]
    if not preds:
        return None
    if len(preds) == 1:
        return preds[0]
    return Logical(op="AND", operands=preds, type=INT)


def split_conjuncts(pred: Optional[Expr]) -> List[Expr]:
    if pred is None:
        return []
    if isinstance(pred, Logical) and pred.op == "AND":
        out = []
        for o in pred.operands:
            out.extend(split_conjuncts(o))
        return out
    return [pred]
