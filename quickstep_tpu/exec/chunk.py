"""Chunk: the in-flight columnar batch flowing between operators.

Replaces the reference's ValueAccessor + TupleIdSequence pair (storage/
ValueAccessor.hpp:71, TupleIdSequence.hpp:44): a dict of equal-length device columns
keyed by ExprId, plus a live-row bool mask. All arrays share a static capacity; the
live count is a traced scalar — this is what keeps whole plans jit-compilable.

Late materialization (the copy-elision analog of the reference's
VECTOR_COPY_ELISION join work orders, relational_operators/HashJoinOperator.hpp:420
and ValueAccessor::TupleIdSequenceAdapter): a slot may hold a `LazyCol` — a base
column plus a shared `RowIds` gather map — instead of a materialized array. Joins,
sorts and compactions then move ONE int32 row-id array per upstream source instead
of gathering every payload column at every operator; payload bytes are gathered
exactly once, at the point of use (expression eval / output pull), usually after
the row set has been filtered and compacted far below the join's expansion
capacity.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

import jax.numpy as jnp

from quickstep_tpu.optimizer.logical import OutAttr
from quickstep_tpu.expressions.scalar import EvalContext


class RowIds:
    """Shared gather map: `idx[capacity]` row indices plus an optional `ok`
    mask (rows with ok=False materialize as NULL). All LazyCols produced from
    one source chunk by one operator share a single RowIds instance, so
    permuting/composing the map costs one int32 gather for the whole column
    group.

    `parent`: lazy composition chain. A chained map means
    effective_idx[i] = parent.effective_idx[idx[i]] — composition is NOT
    evaluated when an operator composes maps, only at materialization
    (resolve), folding from the OUTERMOST map inward so every gather's output
    size equals the final (usually post-compaction) row count. Eager
    composition costs Q10 three row-id gathers at the probe's full 8.4M
    capacity for a join whose aggregate input compacts to ~256k rows right
    after."""

    __slots__ = ("idx", "ok", "parent", "depth")

    def __init__(self, idx, ok=None, parent: "RowIds" = None):
        self.idx = idx
        self.ok = ok
        self.parent = parent
        self.depth = 1 + (parent.depth if parent is not None else 0)

    def chain_ok_none(self) -> bool:
        """True when no level of the chain carries a NULLing mask."""
        r = self
        while r is not None:
            if r.ok is not None:
                return False
            r = r.parent
        return True

    def resolve(self):
        """Flatten the chain in place: one gather per level, each with output
        size len(self.idx). Idempotent; shared instances resolve once."""
        if self.parent is None:
            return
        from quickstep_tpu.ops import kernels as K
        acc, ok = self.idx, self.ok
        p = self.parent
        while p is not None:
            n_p = int(jnp.shape(p.idx)[0])
            safe = jnp.clip(acc, 0, n_p - 1)
            if p.ok is not None:
                g = K.multi_gather([p.idx, p.ok], safe)
                ok = g[1] if ok is None else (ok & g[1])
                acc = g[0]
            else:
                acc = K.multi_gather([p.idx], safe)[0]
            p = p.parent
        self.idx, self.ok, self.parent = acc, ok, None
        self.depth = 1


class LazyCol:
    """A deferred column: base[rid.idx] with validity
    (base_valid[rid.idx] AND rid.ok)."""

    __slots__ = ("base", "base_valid", "rid")
    lazy = True

    def __init__(self, base, base_valid, rid: RowIds):
        self.base = base
        self.base_valid = base_valid
        self.rid = rid


# Pending-chain depth cap: deeper gather chains resolve eagerly at the next
# composition. Its best value on the GPU is unmeasured.
_CHAIN_DEPTH_CAP = 2


def _is_lazy(v) -> bool:
    return isinstance(v, LazyCol)


def _full(d, capacity):
    d = jnp.asarray(d)
    if d.ndim == 0:
        d = jnp.broadcast_to(d, (capacity,))
    return d


def compose_slots(src: "Chunk", take_idx, take_ok) -> Dict[int, LazyCol]:
    """New slots referencing src rows at `take_idx` (with optional validity
    mask `take_ok`). Existing lazy cols CHAIN their gather maps (composition
    deferred to RowIds.resolve at materialization, after any downstream
    compaction has shrunk the row set); materialized cols become lazy against
    a shared fresh RowIds — no payload bytes and no row-id bytes move here."""
    base_rid = RowIds(take_idx, take_ok)
    comp: Dict[int, RowIds] = {}
    out: Dict[int, LazyCol] = {}
    for eid, v in src.slots.items():
        if _is_lazy(v):
            r = comp.get(id(v.rid))
            if r is None:
                r = RowIds(take_idx, take_ok, parent=v.rid)
                # cap pending depth: resolving here restores the eager cost
                # for deeper levels only
                if r.depth > _CHAIN_DEPTH_CAP:
                    r.resolve()
                comp[id(v.rid)] = r
            out[eid] = LazyCol(v.base, v.base_valid, r)
        else:
            d, val = v
            out[eid] = LazyCol(_full(d, src.capacity),
                               None if val is None else _full(val,
                                                              src.capacity),
                               base_rid)
    return out


def repeat_slots(src: "Chunk", k: int) -> Dict[int, LazyCol]:
    """Slots for the k-fold row-repeated view of src (expansion joins):
    structured repeats of the int32 gather maps only."""
    base_rid_box: List[Optional[RowIds]] = [None]
    comp: Dict[int, RowIds] = {}
    out: Dict[int, LazyCol] = {}
    for eid, v in src.slots.items():
        if _is_lazy(v):
            r = comp.get(id(v.rid))
            if r is None:
                # repeat only the OUTER level; any parent chain still
                # resolves later at the final row count
                r = RowIds(jnp.repeat(v.rid.idx, k),
                           None if v.rid.ok is None
                           else jnp.repeat(v.rid.ok, k),
                           parent=v.rid.parent)
                comp[id(v.rid)] = r
            out[eid] = LazyCol(v.base, v.base_valid, r)
        else:
            if base_rid_box[0] is None:
                base_rid_box[0] = RowIds(
                    jnp.repeat(jnp.arange(src.capacity, dtype=jnp.int32), k))
            d, val = v
            out[eid] = LazyCol(_full(d, src.capacity),
                               None if val is None else _full(val,
                                                              src.capacity),
                               base_rid_box[0])
    return out


@dataclasses.dataclass
class Chunk:
    attrs: List[OutAttr]
    # expr_id -> (data, valid) materialized pair, or a LazyCol
    slots: Dict[int, object]
    alive: object                                      # bool[capacity]
    capacity: int
    # static (host-known) upper bound on live rows, when tighter than
    # capacity — lets nested-loops/cross joins compact tiny inputs instead of
    # multiplying padded capacities. None = no bound beyond capacity.
    bound: Optional[int] = None
    # host-side (static, per-plan) metadata for physical decisions:
    ranges: Dict[int, Optional[Tuple[int, int]]] = dataclasses.field(
        default_factory=dict)
    unique_sets: List[frozenset] = dataclasses.field(default_factory=list)
    # per-attr upper bound on duplicate count (heaviest value): sizes the
    # expansion-join K when the attr is a join key. Filters preserve it
    # (still an upper bound); projections propagate for pass-through attrs.
    max_counts: Dict[int, int] = dataclasses.field(default_factory=dict)
    # row-wise functional dependencies (determinant ids -> dependent ids):
    # within any single row, the determinant values fix the dependents. Feeds
    # the ReduceGroupByAttributes optimization (sort by a minimal key cover).
    fds: List[Tuple[frozenset, frozenset]] = dataclasses.field(
        default_factory=list)

    def ctx(self, extra: Optional[dict] = None) -> EvalContext:
        slots = self.slots if not extra else {**self.slots, **extra}
        return EvalContext(slots, fetch=self.get)

    def col(self, expr_id: int):
        return self.get(expr_id)

    def count(self):
        return jnp.sum(self.alive.astype(jnp.int32))

    # ------------------------------------------------------------------
    # lazy materialization
    # ------------------------------------------------------------------
    def get(self, expr_id: int):
        v = self.slots[expr_id]
        if _is_lazy(v):
            self.ensure([expr_id])
            v = self.slots[expr_id]
        return v

    def ensure(self, eids: Iterable[int]):
        """Materialize the given columns, batching all LazyCols that share a
        RowIds into one row-packed gather (K.multi_gather)."""
        from quickstep_tpu.ops import kernels as K
        groups: Dict[int, List[int]] = {}
        for eid in eids:
            v = self.slots.get(eid)
            if _is_lazy(v):
                groups.setdefault(id(v.rid), []).append(eid)
        for ids in groups.values():
            first: LazyCol = self.slots[ids[0]]
            rid = first.rid
            rid.resolve()   # flatten any composition chain (outside-in)
            n_base = int(jnp.shape(first.base)[0])
            safe = jnp.clip(rid.idx, 0, n_base - 1)
            cols = []
            for eid in ids:
                lc: LazyCol = self.slots[eid]
                cols.append(jnp.asarray(lc.base))
                cols.append(lc.base_valid)
            g = K.multi_gather(cols, safe)
            for j, eid in enumerate(ids):
                d, bv = g[2 * j], g[2 * j + 1]
                v = bv
                if rid.ok is not None:
                    v = rid.ok if v is None else (v & rid.ok)
                self.slots[eid] = (d, v)

    def materialize_all(self):
        self.ensure([a.expr_id for a in self.attrs
                     if a.expr_id in self.slots])
        # stray slots not in attrs (pass-through intermediates)
        self.ensure(list(self.slots.keys()))
        return self

    def restrict_valid(self, eids: Iterable[int], keep):
        """AND `keep` into the valid mask of the given columns. Lazy columns
        update their (freshly composed, operator-private) RowIds once per
        shared map; materialized ones update in place."""
        done = set()
        for eid in eids:
            v = self.slots[eid]
            if _is_lazy(v):
                if id(v.rid) not in done:
                    done.add(id(v.rid))
                    v.rid.ok = keep if v.rid.ok is None else (v.rid.ok & keep)
            else:
                d, val = v
                self.slots[eid] = (d, keep if val is None else (keep & val))

    def take_columns(self, order, eids) -> Tuple[list, list]:
        """Materialize the given columns at permuted positions `order`,
        composing the permutation with pending gather maps (payload bytes are
        gathered once, at the final size)."""
        tmp = Chunk(attrs=[], slots=compose_slots(self, order, None),
                    alive=None, capacity=int(jnp.shape(order)[0]))
        tmp.ensure(eids)
        datas, valids = [], []
        for eid in eids:
            d, v = tmp.slots[eid]
            datas.append(d)
            valids.append(v)
        return datas, valids

    def broadcast(self, data, valid):
        """Ensure (data, valid) are full-capacity arrays (literals evaluate to
        scalars)."""
        data = jnp.broadcast_to(jnp.asarray(data), (self.capacity,))
        if valid is not None:
            valid = jnp.broadcast_to(jnp.asarray(valid), (self.capacity,))
        return data, valid

    def is_unique(self, ids: List[int]) -> bool:
        s = frozenset(ids)
        return any(u <= s for u in self.unique_sets)

    def fd_closure(self, ids: set) -> set:
        out = set(ids)
        changed = True
        while changed:
            changed = False
            for det, dep in self.fds:
                if det <= out and not dep <= out:
                    out |= dep
                    changed = True
        return out
