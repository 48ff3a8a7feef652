"""The catalog: databases -> relations -> attributes, with statistics and partitioning.

Capability parity with the reference's catalog/ layer (catalog/Catalog.hpp:125,
CatalogDatabase.hpp:141, CatalogRelation.hpp:65, CatalogAttribute.hpp:41,
CatalogRelationStatistics.hpp:44, PartitionScheme.hpp:53). Persistence uses JSON +
per-column .npy shard files instead of protobuf+slot-files; `\\analyze` populates
statistics the same way the reference CLI does (cli/CommandExecutor.cpp:218-310) but
computes them vectorized on device instead of issuing COUNT(DISTINCT) subqueries.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional

import numpy as np

from quickstep_tpu.errors import ResolutionError
from quickstep_tpu.types import Type, TypeID
from quickstep_tpu.storage.table import TableData
from quickstep_tpu.storage.column import Column
from quickstep_tpu.storage.dictionary import Dictionary


@dataclasses.dataclass
class CatalogAttribute:
    name: str
    type: Type
    display_name: Optional[str] = None
    unique: bool = False   # declared UNIQUE / PRIMARY KEY


@dataclasses.dataclass
class CatalogRelationStatistics:
    """Exactness flag + table/column stats feeding the cost model
    (reference CatalogRelationStatistics.hpp:44, StarSchemaSimpleCostModel)."""

    exact: bool = False
    num_tuples: Optional[int] = None
    min_values: Dict[str, object] = dataclasses.field(default_factory=dict)
    max_values: Dict[str, object] = dataclasses.field(default_factory=dict)
    num_distinct: Dict[str, int] = dataclasses.field(default_factory=dict)
    unique_pairs: List[List[str]] = dataclasses.field(default_factory=list)
    # per-column heaviest duplicate count (max group size): bounds the match
    # run length when the column is a join key -> sizes expansion joins
    max_counts: Dict[str, int] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class PartitionScheme:
    """Table partitioning (reference PartitionScheme.hpp:53): hash/range/random on
    attribute(s). On the device this records the intended row-shard layout over the mesh
    axis."""

    kind: str = "hash"  # hash | range | random
    attributes: List[str] = dataclasses.field(default_factory=list)
    num_partitions: int = 1


class CatalogRelation:
    """A named relation: schema + (host-resident) data + stats + partitioning."""

    def __init__(self, name: str, attributes: List[CatalogAttribute],
                 is_temporary: bool = False):
        self.name = name
        self.attributes = attributes
        self._attr_index = {a.name.lower(): i for i, a in enumerate(attributes)}
        self.statistics = CatalogRelationStatistics()
        self.partition_scheme: Optional[PartitionScheme] = None
        self.is_temporary = is_temporary
        self.version = 0   # bumped on any data mutation (device-cache invalidation)
        self.indices: List[dict] = []   # IndexScheme entries (name, attrs, type)
        # CREATE INDEX product: per-column block min/max summaries
        # (storage/SMAIndexSubBlock.hpp:181 analog at fixed block granularity);
        # col -> (block_rows, mins ndarray, maxs ndarray, version). Rebuilt
        # lazily when self.version moves past the recorded version (the
        # reference rebuilds sub-blocks on block mutation).
        self.sma_blocks: Dict[str, tuple] = {}
        self.data: TableData = TableData.empty(
            [(a.name, a.type) for a in attributes])

    # ---- schema ----
    def attribute_by_name(self, name: str) -> Optional[CatalogAttribute]:
        i = self._attr_index.get(name.lower())
        return self.attributes[i] if i is not None else None

    def attribute_index(self, name: str) -> int:
        i = self._attr_index.get(name.lower())
        if i is None:
            raise ResolutionError(f"no attribute {name} in relation {self.name}")
        return i

    @property
    def num_tuples(self) -> int:
        return self.data.num_rows

    # ---- data mutation (bulk load / insert / delete) ----
    def set_data(self, data: TableData) -> None:
        self.data = data
        self.version += 1
        self.statistics = CatalogRelationStatistics()  # stats are stale now

    def append_data(self, data: TableData) -> None:
        self.data = self.data.concat(data)
        self.version += 1
        self.statistics = CatalogRelationStatistics()

    # ---- statistics (the `\analyze` path) ----
    def analyze(self) -> None:
        st = CatalogRelationStatistics(exact=True, num_tuples=self.data.num_rows)
        for a in self.attributes:
            col = self.data.columns[a.name]
            arr = np.asarray(col.data)
            if col.valid is not None:
                arr = arr[np.asarray(col.valid)]
            if arr.size == 0:
                continue
            st.min_values[a.name] = _stat_value(col, arr.min())
            st.max_values[a.name] = _stat_value(col, arr.max())
            _, counts = np.unique(arr, return_counts=True)
            st.num_distinct[a.name] = int(counts.size)
            st.max_counts[a.name] = int(counts.max())
        # composite-key detection (partsupp-style): when no single column is
        # unique, check whether the leading pair of integer columns is — feeds
        # unique-build join planning (the reference gets this from rebuilt
        # CSBTree/primary-key metadata)
        n = self.data.num_rows
        if n and not any(st.num_distinct.get(a.name) == n
                         for a in self.attributes):
            ints = [a for a in self.attributes
                    if self.data.columns[a.name].valid is None and
                    np.issubdtype(np.asarray(
                        self.data.columns[a.name].data).dtype, np.integer)]
            if len(ints) >= 2:
                a0, a1 = ints[0], ints[1]
                c0 = np.asarray(self.data.columns[a0.name].data).astype(np.int64)
                c1 = np.asarray(self.data.columns[a1.name].data).astype(np.int64)
                span = int(c1.max()) - int(c1.min()) + 1 if n else 1
                packed = c0 * span + (c1 - int(c1.min()))
                if np.unique(packed).size == n:
                    st.unique_pairs.append([a0.name, a1.name])
        self.statistics = st


def _stat_value(col: Column, raw):
    if col.type.is_string:
        return col.dictionary.values[int(raw)] if len(col.dictionary) else ""
    if col.type.is_floating:
        return float(raw)
    return int(raw)


class CatalogDatabase:
    def __init__(self, name: str = "default"):
        self.name = name
        self.relations: Dict[str, CatalogRelation] = {}

    def add_relation(self, rel: CatalogRelation) -> None:
        key = rel.name.lower()
        if key in self.relations:
            raise ResolutionError(f"relation {rel.name} already exists")
        self.relations[key] = rel

    def drop_relation(self, name: str) -> None:
        key = name.lower()
        if key not in self.relations:
            raise ResolutionError(f"relation {name} does not exist")
        del self.relations[key]

    def get_relation(self, name: str) -> Optional[CatalogRelation]:
        return self.relations.get(name.lower())

    def has_relation(self, name: str) -> bool:
        return name.lower() in self.relations


class Catalog:
    """Named databases + persistence (reference Catalog.hpp:125; catalog.pb.bin ->
    catalog.json + npy column files)."""

    def __init__(self):
        self.databases: Dict[str, CatalogDatabase] = {"default": CatalogDatabase()}

    @property
    def default_database(self) -> CatalogDatabase:
        return self.databases["default"]

    # ---- persistence ----
    def save(self, storage_path: str) -> None:
        os.makedirs(storage_path, exist_ok=True)
        meta = {"databases": {}}
        for dbname, db in self.databases.items():
            dbm = {"relations": {}}
            for rel in db.relations.values():
                if rel.is_temporary:
                    continue
                relm = {
                    "attributes": [
                        {"name": a.name, "type_id": int(a.type.type_id),
                         "nullable": a.type.nullable, "length": a.type.length,
                         "precision": a.type.precision, "scale": a.type.scale}
                        for a in rel.attributes
                    ],
                    "num_rows": rel.data.num_rows,
                    # version round-trips so per-version learned state
                    # (learned_overrides.json, SMA summaries) stays valid
                    # across restarts
                    "version": rel.version,
                    "stats": _stats_to_json(rel.statistics),
                    "partition": dataclasses.asdict(rel.partition_scheme)
                    if rel.partition_scheme else None,
                    "indices": rel.indices,
                }
                dbm["relations"][rel.name] = relm
                rdir = os.path.join(storage_path, dbname, rel.name)
                os.makedirs(rdir, exist_ok=True)
                for a in rel.attributes:
                    col = rel.data.columns[a.name]
                    np.save(os.path.join(rdir, f"{a.name}.npy"), np.asarray(col.data))
                    if col.valid is not None:
                        np.save(os.path.join(rdir, f"{a.name}.valid.npy"),
                                np.asarray(col.valid))
                    if col.dictionary is not None:
                        with open(os.path.join(rdir, f"{a.name}.dict.json"), "w") as f:
                            json.dump(col.dictionary.values, f)
                for cname, (brows, mins, maxs, ver) in rel.sma_blocks.items():
                    if ver != rel.version:
                        continue   # stale: rebuilt lazily after reload
                    np.savez(os.path.join(rdir, f"{cname}.sma.npz"),
                             block_rows=brows, mins=mins, maxs=maxs)
            meta["databases"][dbname] = dbm
        with open(os.path.join(storage_path, "catalog.json"), "w") as f:
            json.dump(meta, f)

    @staticmethod
    def load(storage_path: str) -> "Catalog":
        cat = Catalog()
        path = os.path.join(storage_path, "catalog.json")
        if not os.path.exists(path):
            return cat
        with open(path) as f:
            meta = json.load(f)
        for dbname, dbm in meta["databases"].items():
            db = cat.databases.setdefault(dbname, CatalogDatabase(dbname))
            for relname, relm in dbm["relations"].items():
                attrs = [CatalogAttribute(a["name"],
                                          Type(TypeID(a["type_id"]), a["nullable"],
                                               a["length"],
                                               precision=a.get("precision", 0),
                                               scale=a.get("scale", 0)))
                         for a in relm["attributes"]]
                rel = CatalogRelation(relname, attrs)
                rdir = os.path.join(storage_path, dbname, relname)
                cols = {}
                for a in attrs:
                    # memory-map: the OS pages columns in on first touch, so
                    # opening an SF10 store is instant (lazy block faulting,
                    # the StorageManager-restart analog)
                    data = np.load(os.path.join(rdir, f"{a.name}.npy"),
                                   mmap_mode="r")
                    vpath = os.path.join(rdir, f"{a.name}.valid.npy")
                    valid = np.load(vpath, mmap_mode="r") \
                        if os.path.exists(vpath) else None
                    dpath = os.path.join(rdir, f"{a.name}.dict.json")
                    dictionary = None
                    if os.path.exists(dpath):
                        with open(dpath) as f:
                            dictionary = Dictionary(json.load(f))
                    cols[a.name] = Column(a.type, data, valid, dictionary)
                rel.data = TableData(cols)
                rel.indices = relm.get("indices", [])
                rel.version = relm.get("version", 0)
                for a in attrs:
                    spath = os.path.join(rdir, f"{a.name}.sma.npz")
                    if os.path.exists(spath):
                        z = np.load(spath)
                        rel.sma_blocks[a.name] = (int(z["block_rows"]),
                                                  z["mins"], z["maxs"],
                                                  rel.version)
                rel.statistics = _stats_from_json(relm.get("stats"))
                if relm.get("partition"):
                    rel.partition_scheme = PartitionScheme(**relm["partition"])
                db.add_relation(rel)
        return cat


SMA_BLOCK_ROWS = 4096   # index granularity (reference block ~2MB / slab rows)


def build_sma_blocks(rel: CatalogRelation, col: str,
                     block_rows: int = SMA_BLOCK_ROWS):
    """Build (or refresh) the block min/max summary for one column — the
    CREATE INDEX ... USING SMA product (storage/SMAIndexSubBlock.hpp:181).
    String columns are summarized over their ordered-dictionary codes, which
    preserve ordering, so range/equality pruning stays valid. Returns the
    (block_rows, mins, maxs, version) tuple and records it on the relation."""
    hit = rel.sma_blocks.get(col)
    if hit is not None and hit[3] == rel.version and hit[0] == block_rows:
        return hit
    arr = np.asarray(rel.data.columns[col].data)
    n = arr.shape[0]
    nblocks = -(-n // block_rows) if n else 0
    if nblocks:
        pad = nblocks * block_rows - n
        lo = np.pad(arr, (0, pad), mode="edge").reshape(nblocks, block_rows)
        mins = lo.min(axis=1)
        maxs = lo.max(axis=1)
    else:
        mins = np.empty(0, arr.dtype)
        maxs = np.empty(0, arr.dtype)
    entry = (block_rows, mins, maxs, rel.version)
    rel.sma_blocks[col] = entry
    return entry


def sma_range_for(rel: CatalogRelation, col: str, start: int,
                  end: int) -> Optional[tuple]:
    """(min, max) over rows [start, end) from the block index, or None when no
    fresh index exists for col. O(blocks-overlapped), no column scan."""
    hit = rel.sma_blocks.get(col)
    if hit is None:
        return None
    block_rows, mins, maxs, ver = hit
    if ver != rel.version:
        # data moved under the index: refresh (reference rebuild-on-mutation)
        block_rows, mins, maxs, ver = build_sma_blocks(rel, col, block_rows)
    b0 = start // block_rows
    b1 = -(-end // block_rows)
    if b0 >= b1 or b1 > mins.shape[0]:
        return None
    return mins[b0:b1].min(), maxs[b0:b1].max()


def _stats_to_json(st: CatalogRelationStatistics) -> dict:
    return {"exact": st.exact, "num_tuples": st.num_tuples,
            "min_values": st.min_values, "max_values": st.max_values,
            "num_distinct": st.num_distinct, "unique_pairs": st.unique_pairs,
            "max_counts": st.max_counts}


def _stats_from_json(j: Optional[dict]) -> CatalogRelationStatistics:
    if not j:
        return CatalogRelationStatistics()
    return CatalogRelationStatistics(
        exact=j.get("exact", False), num_tuples=j.get("num_tuples"),
        min_values=j.get("min_values", {}), max_values=j.get("max_values", {}),
        num_distinct=j.get("num_distinct", {}),
        unique_pairs=j.get("unique_pairs", []),
        max_counts=j.get("max_counts", {}))
