"""Host-side columnar tables.

The device-side replacement for the reference's StorageBlock / TupleStorageSubBlock stack
(storage/StorageBlock.hpp:62): rather than 2MB self-describing blocks with per-block
row/column layouts, a relation's data is a single struct-of-arrays `TableData` on the host,
padded and transferred to HBM by the executor per compiled stage. Block-level parallelism
(one WorkOrder per block) is replaced by SPMD row-sharding over the mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from quickstep_tpu.storage.column import Column
from quickstep_tpu.types import Type


@dataclasses.dataclass
class TableData:
    """Ordered name -> Column mapping; all columns share num_rows."""

    columns: Dict[str, Column]

    @property
    def num_rows(self) -> int:
        if not self.columns:
            return 0
        return len(next(iter(self.columns.values())))

    @property
    def names(self) -> List[str]:
        return list(self.columns.keys())

    def column(self, name: str) -> Column:
        return self.columns[name]

    @staticmethod
    def from_rows(schema: List[tuple], rows: List[tuple]) -> "TableData":
        """schema: [(name, Type), ...]; rows: python tuples."""
        cols = {}
        for i, (name, typ) in enumerate(schema):
            cols[name] = Column.from_values(typ, [r[i] for r in rows])
        return TableData(cols)

    def to_rows(self) -> List[tuple]:
        lists = [c.to_pylist() for c in self.columns.values()]
        return list(zip(*lists)) if lists else []

    def select_rows(self, idx: np.ndarray) -> "TableData":
        out = {}
        for name, c in self.columns.items():
            out[name] = Column(c.type, np.asarray(c.data)[idx],
                               None if c.valid is None else np.asarray(c.valid)[idx],
                               c.dictionary)
        return TableData(out)

    @staticmethod
    def empty(schema: List[tuple]) -> "TableData":
        return TableData({name: Column.from_values(typ, []) for name, typ in schema})

    def concat(self, other: "TableData") -> "TableData":
        """Append other's rows (schemas must match by position/type). Re-encodes string
        columns through a merged dictionary."""
        from quickstep_tpu.storage.dictionary import Dictionary
        out = {}
        for (name, a), b in zip(self.columns.items(), other.columns.values()):
            if a.type.is_string:
                d, ra, rb = Dictionary.merge(a.dictionary, b.dictionary)
                data = np.concatenate([ra[np.asarray(a.data)] if len(a.data) else
                                       np.zeros(0, np.int32),
                                       rb[np.asarray(b.data)] if len(b.data) else
                                       np.zeros(0, np.int32)])
                dictionary = d
            else:
                data = np.concatenate([np.asarray(a.data), np.asarray(b.data)])
                dictionary = None
            valid = None
            if a.valid is not None or b.valid is not None:
                va = a.valid if a.valid is not None else np.ones(len(a.data), bool)
                vb = b.valid if b.valid is not None else np.ones(len(b.data), bool)
                valid = np.concatenate([va, vb])
            out[name] = Column(a.type, data, valid, dictionary)
        return TableData(out)
