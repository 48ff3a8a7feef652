"""The SQL type system.

Capability parity with the reference's types/ layer (types/Type.hpp:93, types/TypeID.hpp,
types/TypeFactory.hpp, types/NumericTypeUnifier.hpp), re-designed for columnar device
arrays: every SQL type maps to a fixed-width device dtype; CHAR/VARCHAR columns are
dictionary-encoded (ordered codes), so their device dtype is int32.

Device encodings:
  INT                -> int32
  LONG               -> int64
  FLOAT              -> float32
  DOUBLE             -> float64   (DECIMAL/REAL/NUMERIC parse to DOUBLE, as in the
                                   reference grammar SqlParser.ypp:791-799)
  CHAR(n)/VARCHAR(n) -> int32 ordered dictionary code
  DATE               -> int32 packed (year<<9 | month<<5 | day); order-preserving, so
                        comparisons work directly on codes and EXTRACT is a shift
  DATETIME           -> int64 microseconds since Unix epoch
  DATETIME_INTERVAL  -> int64 microseconds
  YEARMONTH_INTERVAL -> int32 months
  NULLTYPE           -> int32 (always-null placeholder)

Null semantics: every column/value slot has a validity bit carried separately (the
reference threads nullability through Type instances and null bitmaps in sub-blocks).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np


class TypeID(enum.IntEnum):
    INT = 0
    LONG = 1
    FLOAT = 2
    DOUBLE = 3
    CHAR = 4
    VARCHAR = 5
    DATE = 6
    DATETIME = 7
    DATETIME_INTERVAL = 8
    YEARMONTH_INTERVAL = 9
    NULLTYPE = 10
    DECIMAL = 11


_NUMERIC = {TypeID.INT, TypeID.LONG, TypeID.FLOAT, TypeID.DOUBLE,
            TypeID.DECIMAL}
_STRING = {TypeID.CHAR, TypeID.VARCHAR}

_DEVICE_DTYPE = {
    TypeID.INT: np.int32,
    TypeID.LONG: np.int64,
    TypeID.FLOAT: np.float32,
    TypeID.DOUBLE: np.float64,
    TypeID.CHAR: np.int32,
    TypeID.VARCHAR: np.int32,
    TypeID.DATE: np.int32,
    TypeID.DATETIME: np.int64,
    TypeID.DATETIME_INTERVAL: np.int64,
    TypeID.YEARMONTH_INTERVAL: np.int32,
    TypeID.NULLTYPE: np.int32,
    TypeID.DECIMAL: np.int32,  # scaled units; int64 when precision > 9
}

# Type::getPrintWidth values (see Type.print_width)
_PRINT_WIDTH = {
    TypeID.INT: 11,                  # digits10(9) + leading digit + '-'
    TypeID.LONG: 20,                 # digits10(18) + leading digit + '-'
    TypeID.FLOAT: 15,                # max_digits10(9) + '.' + '-' + 'e+' + 2
    TypeID.DOUBLE: 24,               # max_digits10(17) + '.' + '-' + 'e+' + 3
    TypeID.DATE: 12,                 # +/-, 5-digit year, -MM-DD
    TypeID.DATETIME: 41,             # sign + 18-digit year + -MM-DDTHH:MM:SS.ssssss
    TypeID.DATETIME_INTERVAL: 40,    # sign + days + " days " + HH:MM:SS.ssssss
    TypeID.YEARMONTH_INTERVAL: 33,   # sign + years + " years " + MM + " mons"
    TypeID.NULLTYPE: 4,              # "NULL"
    TypeID.DECIMAL: 24,              # printed as a double (value = units*10^-s)
}

_PRINT_NAME = {
    TypeID.INT: "Int",
    TypeID.LONG: "Long",
    TypeID.FLOAT: "Float",
    TypeID.DOUBLE: "Double",
    TypeID.CHAR: "Char",
    TypeID.VARCHAR: "VarChar",
    TypeID.DATE: "Date",
    TypeID.DATETIME: "Datetime",
    TypeID.DATETIME_INTERVAL: "DatetimeInterval",
    TypeID.YEARMONTH_INTERVAL: "YearMonthInterval",
    TypeID.NULLTYPE: "NullType",
    TypeID.DECIMAL: "Decimal",
}


@dataclasses.dataclass(frozen=True)
class Type:
    """An immutable SQL type: id + nullability + optional parameters.

    DECIMAL(precision, scale) is the one departure from the reference's type
    lattice (which folds DECIMAL to DOUBLE, parser/SqlParser.ypp:791-799): here
    it is a first-class *storage encoding* — values are stored and computed as
    integers of `value * 10^scale` units (int32 when precision <= 9, else
    int64), the device-side analog of the reference's per-column compressed
    encodings that evaluate predicates directly on codes
    (compression/CompressionDictionary.hpp:64, storage/CompressedBlockBuilder.cpp).
    Integer units keep sums exact and compares and adds native-width. Values
    decode to doubles only at the result boundary.
    """

    type_id: TypeID
    nullable: bool = False
    length: int = 0     # CHAR/VARCHAR max length
    precision: int = 0  # DECIMAL digits (<=9 -> int32 units, else int64)
    scale: int = 0      # DECIMAL fractional digits; units = value * 10^scale

    # ---- classification ----
    @property
    def is_numeric(self) -> bool:
        return self.type_id in _NUMERIC

    @property
    def is_string(self) -> bool:
        return self.type_id in _STRING

    @property
    def is_integral(self) -> bool:
        return self.type_id in (TypeID.INT, TypeID.LONG)

    @property
    def is_floating(self) -> bool:
        return self.type_id in (TypeID.FLOAT, TypeID.DOUBLE)

    @property
    def is_decimal(self) -> bool:
        return self.type_id == TypeID.DECIMAL

    # ---- device mapping ----
    @property
    def device_dtype(self) -> np.dtype:
        if self.type_id == TypeID.DECIMAL:
            return np.dtype(np.int32 if self.precision <= 9 else np.int64)
        return np.dtype(_DEVICE_DTYPE[self.type_id])

    @property
    def print_width(self) -> int:
        """Maximum printed width of any value of this type, matching the
        reference's Type::getPrintWidth (types/IntType.hpp:92 digits10+2,
        types/FloatType.hpp:114 / DoubleType.hpp:114 mantissa+point+sign+
        exponent, types/CharType.hpp:119 length, DatetimeLit.hpp:46,114 ISO
        widths, IntervalLit.hpp:46,128)."""
        if self.is_string:
            return self.length
        return _PRINT_WIDTH[self.type_id]

    # ---- derivation ----
    def with_nullable(self, nullable: bool = True) -> "Type":
        return dataclasses.replace(self, nullable=nullable)

    def name(self) -> str:
        base = _PRINT_NAME[self.type_id]
        if self.is_string:
            base = f"{base}({self.length})"
        elif self.is_decimal:
            base = f"{base}({self.precision},{self.scale})"
        if self.nullable:
            base += " NULL"
        return base

    def __str__(self) -> str:
        return self.name()

    def is_coercible_from(self, other: "Type") -> bool:
        """Can a value of `other` be implicitly cast to this type?

        Mirrors the reference's Type::isSafelyCoercibleFrom lattice: numeric widening
        INT -> LONG -> FLOAT/DOUBLE, FLOAT -> DOUBLE; strings interchange when this
        length can hold the other; NULLTYPE coerces to any nullable type.
        """
        if other.type_id == TypeID.NULLTYPE:
            return self.nullable
        if self.type_id == other.type_id:
            return True
        # DECIMAL stores scaled integers: any numeric coerces in (encoded at
        # the boundary), and it coerces out to floats.
        if self.is_decimal:
            return other.is_numeric
        if other.is_decimal:
            return self.is_floating
        if self.is_numeric and other.is_numeric:
            order = {TypeID.INT: 0, TypeID.LONG: 1, TypeID.FLOAT: 2, TypeID.DOUBLE: 3}
            # LONG -> FLOAT is allowed (lossy but implicit in SQL), matching the
            # reference's NumericTypeUnifier behavior.
            return order[self.type_id] >= order[other.type_id]
        if self.is_string and other.is_string:
            return True
        return False


# Canonical singletons (non-nullable; derive with .with_nullable()).
INT = Type(TypeID.INT)
LONG = Type(TypeID.LONG)
FLOAT = Type(TypeID.FLOAT)
DOUBLE = Type(TypeID.DOUBLE)
DATE = Type(TypeID.DATE)
DATETIME = Type(TypeID.DATETIME)
DATETIME_INTERVAL = Type(TypeID.DATETIME_INTERVAL)
YEARMONTH_INTERVAL = Type(TypeID.YEARMONTH_INTERVAL)
NULL_TYPE = Type(TypeID.NULLTYPE, nullable=True)


def Char(length: int, nullable: bool = False) -> Type:
    return Type(TypeID.CHAR, nullable=nullable, length=length)


def VarChar(length: int, nullable: bool = False) -> Type:
    return Type(TypeID.VARCHAR, nullable=nullable, length=length)


def Decimal(precision: int = 9, scale: int = 2, nullable: bool = False) -> Type:
    return Type(TypeID.DECIMAL, nullable=nullable,
                precision=precision, scale=scale)


class TypeFactory:
    """Type construction / unification helpers (reference TypeFactory + NumericTypeUnifier)."""

    _NUMERIC_RANK = {TypeID.INT: 0, TypeID.LONG: 1, TypeID.FLOAT: 2, TypeID.DOUBLE: 3}

    @staticmethod
    def get(type_id: TypeID, nullable: bool = False, length: int = 0) -> Type:
        return Type(type_id, nullable=nullable, length=length)

    @classmethod
    def unify(cls, a: Type, b: Type) -> Optional[Type]:
        """Least common type for binary operations / comparisons; None if incompatible."""
        nullable = a.nullable or b.nullable
        if a.type_id == TypeID.NULLTYPE:
            return b.with_nullable(True)
        if b.type_id == TypeID.NULLTYPE:
            return a.with_nullable(True)
        if a.type_id == b.type_id:
            if a.is_string:
                return Type(TypeID.VARCHAR if a.type_id == TypeID.VARCHAR or
                            b.type_id == TypeID.VARCHAR else TypeID.CHAR,
                            nullable=nullable, length=max(a.length, b.length))
            if a.is_decimal:
                if a.scale == b.scale:
                    return Type(TypeID.DECIMAL, nullable=nullable,
                                precision=max(a.precision, b.precision),
                                scale=a.scale)
                return DOUBLE.with_nullable(nullable)  # mixed scales: decode
            return a.with_nullable(nullable)
        if a.is_numeric and b.is_numeric:
            if a.is_decimal or b.is_decimal:
                # decimal mixed with any other numeric unifies to DOUBLE; the
                # resolver keeps exact integer forms where it can (scaled
                # literals / integral rescale) before falling back to this.
                return DOUBLE.with_nullable(nullable)
            tid = max(a.type_id, b.type_id, key=lambda t: cls._NUMERIC_RANK[t])
            return Type(tid, nullable=nullable)
        if a.is_string and b.is_string:
            return Type(TypeID.VARCHAR, nullable=nullable, length=max(a.length, b.length))
        # Date/time cross-type comparisons only between identical ids (handled above).
        return None

    @classmethod
    def from_name(cls, name: str, length: int = 0, nullable: bool = False,
                  scale: Optional[int] = None) -> Type:
        """Parse a SQL type name (as the grammar does, SqlParser.ypp:760-820).

        DECIMAL/NUMERIC *without* parameters keeps the reference's DOUBLE
        semantics; DECIMAL(p, s) selects the exact scaled-integer encoding."""
        n = name.upper()
        if n in ("INT", "INTEGER", "SMALLINT"):
            return Type(TypeID.INT, nullable=nullable)
        if n in ("BIGINT", "LONG"):
            return Type(TypeID.LONG, nullable=nullable)
        if n == "FLOAT":
            return Type(TypeID.FLOAT, nullable=nullable)
        if n in ("DECIMAL", "NUMERIC") and scale is not None:
            return Type(TypeID.DECIMAL, nullable=nullable,
                        precision=max(int(length), 1), scale=int(scale))
        if n in ("DOUBLE", "REAL", "DECIMAL", "NUMERIC"):
            return Type(TypeID.DOUBLE, nullable=nullable)
        if n in ("CHAR", "CHARACTER"):
            return Type(TypeID.CHAR, nullable=nullable, length=length)
        if n == "VARCHAR":
            return Type(TypeID.VARCHAR, nullable=nullable, length=length)
        if n == "DATE":
            return Type(TypeID.DATE, nullable=nullable)
        if n in ("DATETIME", "TIMESTAMP"):
            return Type(TypeID.DATETIME, nullable=nullable)
        raise ValueError(f"unknown type name: {name}")
