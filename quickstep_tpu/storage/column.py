"""Columns: typed host/device arrays with validity and optional dictionary.

The device-side replacement for the reference's ColumnVector
(types/containers/ColumnVector.hpp:71: NativeColumnVector = dense fixed-width + null
bitmap; IndirectColumnVector = var-len values). Here every column — including strings,
via ordered dictionary codes — is a dense fixed-width array, so there is exactly one
representation and XLA sees flat arrays.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from quickstep_tpu.types import Type, TypeID
from quickstep_tpu.types.datetime_util import (
    date_to_str,
    datetime_to_str,
    parse_date_literal,
    parse_datetime_literal,
)
from quickstep_tpu.storage.dictionary import Dictionary


@dataclasses.dataclass
class Column:
    """A typed column. `data` is the device encoding (see types.types docstring).

    valid: None means all-valid; otherwise bool array, False = NULL.
    dictionary: present iff type is CHAR/VARCHAR.
    """

    type: Type
    data: np.ndarray
    valid: Optional[np.ndarray] = None
    dictionary: Optional[Dictionary] = None

    def __len__(self) -> int:
        return int(self.data.shape[0])

    # ---- construction from Python values ----
    @staticmethod
    def from_values(typ: Type, values: List) -> "Column":
        n = len(values)
        valid = np.asarray([v is not None for v in values], dtype=bool)
        all_valid = bool(valid.all())
        if typ.is_string:
            strings = [v if v is not None else "" for v in values]
            dictionary, codes = Dictionary.build(strings)
            return Column(typ, codes, None if all_valid else valid, dictionary)
        dtype = typ.device_dtype
        filled = [_encode_scalar(typ, v) if v is not None else 0 for v in values]
        data = np.asarray(filled, dtype=dtype) if n else np.zeros(0, dtype=dtype)
        return Column(typ, data, None if all_valid else valid, None)

    # ---- decoding to Python values (for printing / oracles; small results only) ----
    def to_pylist(self) -> List:
        data = np.asarray(self.data)
        valid = self.valid
        if self.type.is_string:
            vals = self.dictionary.decode(data)
        else:
            vals = [_decode_scalar(self.type, v) for v in data]
        if valid is not None:
            vals = [v if bool(ok) else None for v, ok in zip(vals, np.asarray(valid))]
        return vals


def _encode_scalar(typ: Type, v):
    tid = typ.type_id
    if tid == TypeID.DATE:
        return parse_date_literal(v) if isinstance(v, str) else int(v)
    if tid == TypeID.DATETIME:
        return parse_datetime_literal(v) if isinstance(v, str) else int(v)
    if tid == TypeID.DECIMAL:
        # value -> scaled integer units (types/types.py DECIMAL encoding)
        return int(round(float(v) * (10 ** typ.scale)))
    if typ.is_floating:
        return float(v)
    return int(v)


def _decode_scalar(typ: Type, v):
    tid = typ.type_id
    if tid == TypeID.DATE:
        return date_to_str(int(v))
    if tid == TypeID.DATETIME:
        return datetime_to_str(int(v))
    if tid == TypeID.DECIMAL:
        return int(v) / (10 ** typ.scale)
    if typ.is_floating:
        return float(v)
    return int(v)
