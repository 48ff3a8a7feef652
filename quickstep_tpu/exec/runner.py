"""PlanRunner: traces a logical plan into one JAX computation.

This is the device-side replacement for the reference's entire query_execution/ layer
(ForemanSingleNode + Worker threads + WorkOrders + QueryManager state machine,
query_execution/README.md): instead of dispatching one WorkOrder per storage block to
worker threads, the whole operator DAG is traced into a single XLA program per query —
XLA's scheduler provides the pipelining/fusion that the WorkOrder scheduler provided,
and SPMD sharding (parallel/) provides the parallelism. Pipeline breakers (hash build,
aggregation finalize, sort) are simply data dependencies inside the program.

Physical operator choices (dense vs sort aggregation, direct vs open-addressing vs
expansion join) are made host-side at trace time from plan-time ranges/uniqueness —
the ExecutionGenerator role (query_optimizer/ExecutionGenerator.cpp). Runtime
fallbacks (duplicate build keys, expansion overflow) surface as boolean flags the
executor checks, mirroring the reference's kOutOfSpace resize loop
(storage/HashTableBase.hpp:65).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from quickstep_tpu.config import Config
from quickstep_tpu.errors import ExecutionError
from quickstep_tpu.types import Type, TypeID
from quickstep_tpu.expressions.scalar import Expr, Attr, Lit, Cmp


def _flip_cmp(op: str) -> str:
    return {"<": ">", "<=": ">=", ">": "<", ">=": "<=",
            "=": "=", "<>": "<>"}[op]


def iter_scalar_subplans(plan) -> list:
    """Deterministic DFS enumeration of the uncorrelated scalar subquery
    plans under `plan` (dedup by identity, exprs before children). The
    executor keys hoisted scalar inputs by POSITION in this order and the
    runner resolves them the same way — identity-based keys break when a
    compile-cache-hit program (closing over an older structurally-identical
    plan) is retraced against fresh inputs."""
    from quickstep_tpu.expressions.subquery import SubqueryScalar
    from quickstep_tpu.exec.executor import _node_exprs
    out = []
    seen = set()

    def visit(node):
        for e in _node_exprs(node):
            stack = [e]
            while stack:
                x = stack.pop()
                if isinstance(x, SubqueryScalar) and id(x.plan) not in seen:
                    seen.add(id(x.plan))
                    out.append(x.plan)
                stack.extend(x.children())
        for c in node.children():
            visit(c)
    visit(plan)
    return out
from quickstep_tpu.expressions.aggregate import AggregateSpec
from quickstep_tpu.optimizer import logical as L
from quickstep_tpu.optimizer.logical import OutAttr
from quickstep_tpu.optimizer.stats import infer_range
from quickstep_tpu.exec.chunk import Chunk, compose_slots, repeat_slots
from quickstep_tpu.ops import kernels as K
from quickstep_tpu.ops import groupby as G
from quickstep_tpu.ops import join as J
from quickstep_tpu.ops import sort as S


@dataclasses.dataclass
class JoinOverride:
    """Executor-supplied retry directives keyed by plan-node id."""
    strategy: Optional[str] = None    # force 'expand'
    max_matches: Optional[int] = None
    shuffle_factor: int = 1           # bucket-capacity escalation on shuffle overflow
    no_compact_probe: bool = False    # estimate-driven pre-join compaction
    no_compact_build: bool = False    # overflowed: run at full capacity


class PlanRunner:
    # trace-time record of the most recent shuffle-join configuration
    # (chunking, LIP filter size, bucket rows) — see _shuffle_join
    trace_shuffle_info: Optional[dict] = None

    def __init__(self, plan: L.LogicalNode, inputs: Dict[str, Dict[str, object]],
                 input_meta: Dict[str, dict], config: Config,
                 overrides: Optional[Dict[int, JoinOverride]] = None,
                 mesh=None):
        """inputs: relation name -> {attr name -> (data, valid), "__num_rows__"}.
        input_meta: relation name -> {capacity, ranges, unique_cols}.
        overrides are keyed by structural (preorder) join indices so they survive
        re-resolution of the same query."""
        self.inputs = inputs
        self.input_meta = input_meta
        self.config = config
        self.mesh = mesh
        self.overrides = overrides or {}
        self.flags: Dict[str, object] = {}   # runtime check flags (dup keys, overflow)
        self._memo: Dict[int, Chunk] = {}    # shared subplans / scalar subqueries
        self._subquery_slots: Dict = {}
        self.node_index: Dict[int, int] = {}
        self.plan = plan
        self._assign_indices(plan, [0])

    def _assign_indices(self, node: L.LogicalNode, counter: List[int]):
        from quickstep_tpu.expressions.subquery import SubqueryScalar
        self.node_index[id(node)] = counter[0]
        counter[0] += 1
        for c in node.children():
            self._assign_indices(c, counter)
        # subquery plans embedded in expressions
        for e in _node_expr_list(node):
            stack = [e]
            while stack:
                x = stack.pop()
                if isinstance(x, SubqueryScalar):
                    self._assign_indices(x.plan, counter)
                stack.extend(x.children())

    # ----------------------------------------------------------------
    def run(self, plan: L.LogicalNode) -> Chunk:
        return self.exec(plan)

    def exec(self, node: L.LogicalNode) -> Chunk:
        m = getattr(self, f"_exec_{type(node).__name__}", None)
        if m is None:
            raise ExecutionError(f"no executor for {type(node).__name__}")
        # named_scope threads the plan-node identity into HLO op metadata, so
        # profiler fusions attribute back to operators (tools/op_profile.py) —
        # the per-WorkOrder timing analog (query_execution/Worker.cpp:136)
        idx = self.node_index.get(id(node), -1)
        with jax.named_scope(f"qop{idx}_{type(node).__name__}"):
            return m(node)

    def _exec_memo(self, plan: L.LogicalNode) -> Chunk:
        key = id(plan)
        if key not in self._memo:
            self._memo[key] = self.exec(plan)
        return self._memo[key]

    # ----------------------------------------------------------------
    # scan / generator
    # ----------------------------------------------------------------
    def _exec_TableScan(self, node: L.TableScan) -> Chunk:
        cols = self.inputs[node.relation_name]
        meta = self.input_meta[node.relation_name]
        capacity = meta["capacity"]
        slots = {}
        ranges = {}
        unique_sets = []
        max_counts = {}
        for a in node.attrs:
            data, valid = cols[a.name]
            slots[a.expr_id] = (data, valid)
            r = meta["ranges"].get(a.name)
            ranges[a.expr_id] = r
            mc = meta.get("max_counts", {}).get(a.name)
            if mc is not None:
                max_counts[a.expr_id] = mc
            if a.name in meta.get("unique_cols", ()):
                unique_sets.append(frozenset([a.expr_id]))
        by_name = {a.name: a.expr_id for a in node.attrs}
        for pair in meta.get("unique_pairs", ()):
            if all(p in by_name for p in pair):
                unique_sets.append(frozenset(by_name[p] for p in pair))
        alive = K.alive_mask(capacity, cols["__num_rows__"])
        all_ids = frozenset(a.expr_id for a in node.attrs)
        fds = [(u, all_ids) for u in unique_sets]
        chunk = Chunk(attrs=list(node.attrs), slots=slots, alive=alive,
                      capacity=capacity, ranges=ranges, unique_sets=unique_sets,
                      fds=fds, max_counts=max_counts,
                      bound=meta.get("rows"))
        if node.sample_kind:
            # TUPLESAMPLE/BLOCKSAMPLE n PERCENT (reference SampleOperator.hpp:60).
            # Deterministic hash-based Bernoulli sample on the row index.
            r = K.hash64(jnp.arange(capacity, dtype=jnp.int64))
            thresh = jnp.uint64(int((node.sample_percent / 100.0) * (2**64 - 1)))
            chunk.alive = chunk.alive & (r < thresh)
        return chunk

    def _exec_Generator(self, node: L.Generator) -> Chunk:
        a = node.attrs[0]
        if a.type.is_floating or isinstance(node.step, float) or \
                isinstance(node.start, float) or isinstance(node.end, float):
            # DOUBLE series (generate_series(1, 3, 0.5)); count uses a tiny
            # epsilon so end lands inside the series despite fp rounding
            import math
            n = max(0, int(math.floor((node.end - node.start) / node.step
                                      + 1e-9)) + 1) if node.step else 0
            capacity = max(K.round_up(n, 8), 8)
            data = (jnp.arange(capacity, dtype=jnp.float64) * node.step
                    + node.start)
        else:
            n = max(0, (node.end - node.start) // node.step + 1) \
                if node.step != 0 else 0
            capacity = max(K.round_up(n, 8), 8)
            data = (jnp.arange(capacity, dtype=jnp.int64) * node.step
                    + node.start)
        return Chunk(attrs=list(node.attrs),
                     slots={a.expr_id: (data, None)},
                     alive=K.alive_mask(capacity, n), capacity=capacity,
                     ranges={a.expr_id: (min(node.start, node.end),
                                         max(node.start, node.end))})

    def _exec_SharedSubplan(self, node: L.SharedSubplan) -> Chunk:
        # materialize once in the memoized chunk so multiple consumers share
        # the gathered columns instead of re-gathering per consumer
        inner = self._exec_memo(node.plan).materialize_all()
        slots = {}
        ranges = {}
        for fresh, orig in zip(node.attrs, inner.attrs):
            slots[fresh.expr_id] = inner.slots[orig.expr_id]
            ranges[fresh.expr_id] = inner.ranges.get(orig.expr_id)
        remap = {o.expr_id: f.expr_id for f, o in zip(node.attrs, inner.attrs)}
        uniq = [frozenset(remap[i] for i in s if i in remap)
                for s in inner.unique_sets
                if all(i in remap for i in s)]
        fds = [(frozenset(remap[i] for i in det),
                frozenset(remap[i] for i in dep if i in remap))
               for det, dep in inner.fds if all(i in remap for i in det)]
        return Chunk(attrs=list(node.attrs), slots=slots, alive=inner.alive,
                     capacity=inner.capacity, ranges=ranges, unique_sets=uniq,
                     fds=fds,
                     max_counts={remap[i]: v
                                 for i, v in inner.max_counts.items()
                                 if i in remap})

    # ----------------------------------------------------------------
    # filter / project
    # ----------------------------------------------------------------
    def _eval(self, chunk: Chunk, e: Expr):
        # batch-materialize every referenced lazy column up front (one
        # row-packed gather per shared RowIds instead of one per column)
        chunk.ensure(e.referenced_attrs() & set(chunk.slots))
        ctx = chunk.ctx(extra=self._subquery_slots)
        return e.eval(ctx)

    def _eval_pred(self, chunk: Chunk, e: Expr):
        self._bind_subqueries(e)
        d, v = self._eval(chunk, e)
        d = jnp.broadcast_to(jnp.asarray(d, dtype=bool), (chunk.capacity,))
        if v is not None:
            d = d & jnp.broadcast_to(v, (chunk.capacity,))
        return d

    def _exec_Filter(self, node: L.Filter) -> Chunk:
        chunk = self.exec(node.input)
        passed = self._eval_pred(chunk, node.predicate)
        return dataclasses.replace(chunk, alive=chunk.alive & passed)

    def _exec_Project(self, node: L.Project) -> Chunk:
        chunk = self.exec(node.input)
        slots = {}
        ranges = {}
        for e, a in zip(node.exprs, node.attrs):
            self._bind_subqueries(e)
            if isinstance(e, Attr) and e.expr_id in chunk.slots:
                cur = chunk.slots[e.expr_id]
                if getattr(cur, "lazy", False) and \
                        jnp.asarray(cur.base).dtype == \
                        jnp.dtype(a.type.device_dtype):
                    # pass-through attr: keep the gather map lazy (no
                    # materialization at projection boundaries)
                    slots[a.expr_id] = cur
                    ranges[a.expr_id] = infer_range(e, chunk.ranges)
                    continue
            d, v = self._eval(chunk, e)
            d, v = chunk.broadcast(jnp.asarray(d, dtype=a.type.device_dtype), v)
            slots[a.expr_id] = (d, v)
            ranges[a.expr_id] = infer_range(e, chunk.ranges)
        # uniqueness/FDs survive for pass-through attrs
        passthru = {e.expr_id: a.expr_id for e, a in zip(node.exprs, node.attrs)
                    if isinstance(e, Attr)}
        uniq = [frozenset(passthru[i] for i in s)
                for s in chunk.unique_sets if all(i in passthru for i in s)]
        fds = [(frozenset(passthru[i] for i in det),
                frozenset(passthru[i] for i in dep if i in passthru))
               for det, dep in chunk.fds if all(i in passthru for i in det)]
        mcs = {a: chunk.max_counts[i] for i, a in passthru.items()
               if i in chunk.max_counts}
        return Chunk(attrs=list(node.attrs), slots=slots, alive=chunk.alive,
                     capacity=chunk.capacity, bound=chunk.bound, ranges=ranges,
                     unique_sets=uniq, fds=fds, max_counts=mcs)

    def _bind_subqueries(self, e: Expr):
        """Pre-execute uncorrelated scalar subqueries referenced by e."""
        from quickstep_tpu.expressions.subquery import SubqueryScalar
        stack = [e]
        while stack:
            x = stack.pop()
            if isinstance(x, SubqueryScalar):
                key = ("subquery", id(x.plan))
                if key not in self._subquery_slots:
                    # hoisted scalars are keyed by DETERMINISTIC traversal
                    # position, never id(): a compile-cache-hit program
                    # closes over an older structurally-identical plan, and
                    # id-keyed inputs would miss on retrace (and re-trace
                    # the subquery in-program)
                    if not hasattr(self, "_subq_index"):
                        self._subq_index = {
                            id(p): i for i, p in
                            enumerate(iter_scalar_subplans(self.plan))}
                    pos = self._subq_index.get(id(x.plan))
                    pre = self.inputs.get("__subqueries__", {}).get(
                        str(pos)) if pos is not None else None
                    if pre is not None:
                        # hoisted: the executor ran this subplan as its own
                        # program and feeds the scalar in as an input
                        val, ok = pre
                        self._subquery_slots[key] = (
                            jnp.asarray(val), jnp.asarray(ok))
                        stack.extend(x.children())
                        continue
                    sub = self._exec_memo(x.plan)
                    out0 = sub.attrs[0]
                    data, valid = sub.get(out0.expr_id)
                    # first live row (scalar aggregates produce exactly one)
                    first = jnp.argmax(sub.alive)
                    any_row = jnp.any(sub.alive)
                    val = jnp.asarray(data)[first]
                    ok = any_row if valid is None else (any_row & valid[first])
                    self._subquery_slots[key] = (val, ok)
            stack.extend(x.children())

    # ----------------------------------------------------------------
    # aggregate
    # ----------------------------------------------------------------
    def _exec_Aggregate(self, node: L.Aggregate) -> Chunk:
        chunk = self.exec(node.input)
        for spec in node.aggregates:
            if spec.arg is not None:
                self._bind_subqueries(spec.arg)
        for ge in node.group_by:
            self._bind_subqueries(ge)

        if not node.group_by:
            return self._scalar_aggregate(node, chunk)

        # Estimate-driven compaction of the aggregate input (same protocol as
        # pre-join compaction, same retry flag): a grouped aggregate's sort
        # runs at its input CAPACITY, so a selective upstream (Q17/Q20's
        # semi-filtered fact scans) only pays off if the live rows are
        # compacted first. Under-estimates raise compact_probe_<idx> and the
        # standard retry re-runs uncompacted.
        idx0 = self.node_index[id(node)]
        ov0 = self.overrides.get(idx0)
        ovg = self.overrides.get(-1)
        chunk = self._est_compact(
            chunk, getattr(node, "est_input_rows", None),
            (ov0 is not None and ov0.no_compact_probe) or
            (ovg is not None and ovg.no_compact_probe),
            f"compact_probe_{idx0}")

        # snapshot slots BEFORE key evaluation: evaluation materializes lazy
        # columns, and the sort path fetches FD-determined group keys lazily
        # (per group, from a representative row)
        pre_slots = dict(chunk.slots)
        distinct_flags = [s.distinct for s in node.aggregates]

        # Decide FD-deferral BEFORE evaluating any key: evaluating a deferred
        # key would issue its full-capacity gather even though the sort path
        # never reads it (on Q18: one 8.4M-row gather PER key column —
        # ensure() batches within one call, not across the per-key _eval
        # calls). Deferral needs: outside the minimal sort cover,
        # a plain Attr over a non-null slot with the output dtype.
        keep = self._reduce_group_keys(node.group_by, chunk)
        defer = set()
        if not any(distinct_flags):
            for i, ge in enumerate(node.group_by):
                if i in keep or not isinstance(ge, Attr):
                    continue
                src = chunk.slots.get(ge.expr_id)
                if src is None:
                    continue
                if getattr(src, "lazy", False):
                    nonnull = src.base_valid is None and \
                        src.rid.chain_ok_none()
                    base = jnp.asarray(src.base)
                else:
                    nonnull = src[1] is None
                    base = jnp.asarray(src[0])
                if nonnull and base.ndim != 0 and base.dtype == jnp.dtype(
                        node.group_attrs[i].type.device_dtype):
                    defer.add(i)

        key_ranges = [infer_range(ge, chunk.ranges) for ge in node.group_by]

        def eval_keys(skip: set):
            # ONE row-packed gather per shared RowIds for everything the
            # evaluated keys + agg inputs touch, then evaluate
            need = set()
            for i, ge in enumerate(node.group_by):
                if i not in skip:
                    need |= ge.referenced_attrs()
            for spec in node.aggregates:
                if spec.arg is not None:
                    need |= spec.arg.referenced_attrs()
            chunk.ensure([e for e in need if e in chunk.slots])
            kd, kv = [], []
            for i, ge in enumerate(node.group_by):
                if i in skip:
                    kd.append(None)
                    kv.append(None)
                    continue
                d, v = self._eval(chunk, ge)
                d, v = chunk.broadcast(d, v)
                kd.append(d)
                kv.append(v)
            return kd, kv

        key_data, key_valid = eval_keys(defer)
        use_dense = self._dense_ok(key_ranges, key_valid)
        if use_dense and defer:
            # dense needs every key materialized (tiny domains only — cheap)
            defer = set()
            key_data, key_valid = eval_keys(defer)

        # Rows with a NULL group key are skipped entirely, matching the
        # reference's hash tables (storage/HashTableKeyManager.hpp — null keys
        # are never inserted, so they vanish from GROUP BY output). Deferred
        # keys are non-null by construction.
        alive = chunk.alive
        for v in key_valid:
            if v is not None:
                alive = alive & v
        if alive is not chunk.alive:
            chunk = dataclasses.replace(chunk, alive=alive)

        agg_inputs = []
        for spec in node.aggregates:
            if spec.arg is None:
                agg_inputs.append((spec.fn, None, None))
            else:
                d, v = self._eval(chunk, spec.arg)
                d, v = chunk.broadcast(d, v)
                if spec.fn in ("sum", "avg") and (spec.arg.type.is_integral or
                                  spec.arg.type.is_decimal):
                    d = d.astype(jnp.int64)
                agg_inputs.append((spec.fn, d, v))

        if any(distinct_flags):
            return self._distinct_aggregate(node, chunk, key_data, key_valid,
                                            agg_inputs, distinct_flags, key_ranges)
        if use_dense:
            return self._dense_aggregate(node, chunk, key_data, key_ranges,
                                         agg_inputs)
        return self._sort_aggregate(node, chunk, key_data, key_valid,
                                    agg_inputs, key_ranges=key_ranges,
                                    pre_slots=pre_slots, keep=keep,
                                    defer=defer)

    def _dense_ok(self, key_ranges, key_valid) -> bool:
        if self.config.aggregate_hashtable_type == "sort":
            return False
        if any(v is not None for v in key_valid):
            return False   # nullable keys: use sort path (null group)
        domain = 1
        for r in key_ranges:
            if r is None:
                return False
            domain *= (r[1] - r[0] + 1)
            if domain > self.config.collision_free_domain_limit:
                return False
        # Above the broadcast variant's reach, dense means SCATTER-adds,
        # which were far slower than the payload sort + prefix path on the
        # earlier accelerator; unmeasured on the GPU. The sort path also
        # rides pre-aggregate compaction. Dense
        # stays for the Q1-class tiny domains where masked broadcast
        # reductions beat everything (zero data movement).
        if domain > G.BROADCAST_DOMAIN_LIMIT:
            return False
        return True

    def _dense_layout(self, key_ranges):
        offsets = [r[0] for r in key_ranges]
        sizes = [r[1] - r[0] + 1 for r in key_ranges]
        strides = []
        acc = 1
        for s in reversed(sizes):
            strides.append(acc)
            acc *= s
        strides = list(reversed(strides))
        return offsets, sizes, strides, acc

    def _dense_aggregate(self, node, chunk, key_data, key_ranges, agg_inputs):
        offsets, sizes, strides, domain = self._dense_layout(key_ranges)
        idx = G.pack_dense_index(key_data, offsets, strides, domain, chunk.alive)
        occupied, results = G.dense_groupby(
            idx, domain, agg_inputs, chunk.alive)
        # reconstruct group keys by unpacking the dense index
        gidx = jnp.arange(domain, dtype=jnp.int64)
        slots = {}
        ranges = {}
        for a, off, size, stride, r in zip(node.group_attrs, offsets, sizes,
                                           strides, key_ranges):
            vals = (gidx // stride) % size + off
            slots[a.expr_id] = (vals.astype(a.type.device_dtype), None)
            ranges[a.expr_id] = r
        self._fill_agg_slots(node, results, slots, domain)
        uniq = [frozenset(a.expr_id for a in node.group_attrs)]
        fds = [(uniq[0], frozenset(a.expr_id for a in node.output))]
        return Chunk(attrs=list(node.output), slots=slots, alive=occupied,
                     capacity=domain, ranges=ranges, unique_sets=uniq, fds=fds)

    def _pack_sort_key(self, key_data, key_valid, key_ranges,
                       descending=None, nulls_first=None):
        """Pack integer composite keys into one int32/int64 sort key when ranges
        fit (sort compile/run cost scales with operand count and width).
        Returns None when not packable (unknown range / float keys)."""
        spans = []
        for d, r in zip(key_data, key_ranges):
            if r is None or jnp.issubdtype(jnp.asarray(d).dtype, jnp.floating):
                return None
            spans.append(r[1] - r[0] + 2)  # +1 slot for NULL
        total = 1
        for s in spans:
            total *= s
        if total >= 2**62:
            return None
        packed = jnp.zeros(key_data[0].shape, jnp.int64)
        for i, (d, v, r, span) in enumerate(
                zip(key_data, key_valid, key_ranges, spans)):
            lo, hi = r
            enc = d.astype(jnp.int64) - lo
            if descending is not None and descending[i]:
                enc = (hi - lo) - enc
            if v is not None:
                nf = nulls_first[i] if nulls_first is not None else None
                if descending is not None:
                    # SQL default: NULLS LAST for ASC, FIRST for DESC
                    first = nf if nf is not None else descending[i]
                else:
                    first = False  # group-by: nulls group last (sentinel analog)
                if first:
                    enc = jnp.where(v, enc + 1, 0)
                else:
                    enc = jnp.where(v, enc, span - 1)
            packed = packed * span + enc
        if total < 2**31:
            packed = packed.astype(jnp.int32)
        return packed

    def _reduce_group_keys(self, group_by, chunk: Chunk) -> List[int]:
        """Minimal sort-key cover: drop group keys functionally determined by
        the remaining ones (reference ReduceGroupByAttributes rule)."""
        ids = [e.expr_id if isinstance(e, Attr) else None for e in group_by]
        keep = list(range(len(group_by)))
        changed = True
        while changed:
            changed = False
            for i in list(keep):
                if ids[i] is None:
                    continue
                others = {ids[j] for j in keep if j != i and ids[j] is not None}
                if ids[i] in chunk.fd_closure(others):
                    keep.remove(i)
                    changed = True
        return keep

    def _sort_aggregate(self, node, chunk, key_data, key_valid, agg_inputs,
                        key_ranges=None, pre_slots=None, keep=None,
                        defer=None):
        if keep is None:
            keep = self._reduce_group_keys(node.group_by, chunk)
        # FD-determined group keys outside the sort cover need not ride the
        # sort OR be materialized at input capacity: each group's value is
        # fetched lazily from a representative row (rep_rows) — the big win
        # for wide GROUP BYs over joins (e.g. 7 customer attrs keyed by
        # c_custkey), where materializing each extra key column costs a full
        # random-gather pass at joined capacity. The deferral set is decided
        # in _exec_Aggregate BEFORE key evaluation (so deferred keys are
        # never gathered at input capacity); the fallback below covers
        # callers that evaluated everything (distinct path).
        if defer is None:
            defer = []
            for i, ge in enumerate(node.group_by):
                if i in keep or pre_slots is None or key_valid[i] is not None \
                        or not isinstance(ge, Attr):
                    continue
                src = pre_slots.get(ge.expr_id)
                if src is None:
                    continue
                base = src.base if getattr(src, "lazy", False) else src[0]
                base = jnp.asarray(base)
                if base.ndim == 0 or \
                        base.dtype != jnp.dtype(
                            node.group_attrs[i].type.device_dtype):
                    continue
                defer.append(i)
        defer = sorted(defer)
        carried = [i for i in range(len(key_data)) if i not in defer]
        sub_positions = [carried.index(i) for i in keep if i in carried]
        packed = None
        span_total = None
        if key_ranges is not None:
            packed = self._pack_sort_key(
                [key_data[i] for i in keep],
                [key_valid[i] for i in keep],
                [key_ranges[i] for i in keep])
            if packed is not None:
                span_total = 1
                for i in keep:
                    span_total *= key_ranges[i][1] - key_ranges[i][0] + 2
        dist = None
        if not defer:
            dist = self._dist_sort_groupby(
                [key_data[i] for i in carried],
                [key_valid[i] for i in carried],
                agg_inputs, chunk.alive, packed, sub_positions, span_total,
                [key_ranges[i] for i in keep] if key_ranges else None)
        if dist is not None:
            out_keys, out_valids, occupied, results, capacity = dist
            rep_rows = None
        else:
            out_keys, out_valids, occupied, _n_groups, results, rep_rows = \
                G.sort_groupby(
                    [key_data[i] for i in carried],
                    [key_valid[i] for i in carried],
                    agg_inputs, chunk.alive, packed_key=packed,
                    sort_subset=sub_positions, want_rows=True)
            capacity = chunk.capacity
        slots = {}
        ranges = {}
        for pos, i in enumerate(carried):
            a, ge = node.group_attrs[i], node.group_by[i]
            slots[a.expr_id] = (out_keys[pos].astype(a.type.device_dtype),
                               out_valids[pos])
            ranges[a.expr_id] = infer_range(ge, chunk.ranges)
        if defer:
            tmp = dataclasses.replace(chunk, slots={
                node.group_by[i].expr_id: pre_slots[node.group_by[i].expr_id]
                for i in defer})
            lazy_src = compose_slots(tmp, rep_rows, None)
            for i in defer:
                a, ge = node.group_attrs[i], node.group_by[i]
                slots[a.expr_id] = lazy_src[ge.expr_id]
                ranges[a.expr_id] = infer_range(ge, chunk.ranges)
        self._fill_agg_slots(node, results, slots, capacity)
        uniq = [frozenset(a.expr_id for a in node.group_attrs)]
        fds = [(uniq[0], frozenset(a.expr_id for a in node.output))]
        return Chunk(attrs=list(node.output), slots=slots,
                     alive=occupied, capacity=capacity,
                     ranges=ranges, unique_sets=uniq, fds=fds)

    def _dist_sort_groupby(self, key_data, key_valid, agg_inputs, alive,
                           packed, sort_subset, span_total, keep_ranges):
        """Sharded two-phase aggregation over the mesh — the reference's
        per-partition AggregationOperator + FinalizeAggregationOperator
        split (query_optimizer/ExecutionGenerator.cpp:1839-2052,
        storage/PartitionedHashTablePool.hpp:49). Without this, GSPMD
        all-gathers the (row-sharded) aggregate input and runs the group
        sort REPLICATED on every device — the 8-device virtual-mesh proxy
        measured each device sorting the full 2M-row join output.

        Phase 1 (shard_map): per-device sort_groupby over the local row
        shard, partial states compacted to a bounded prefix (cap_p >=
        next_pow2(key-domain span), so local groups can never overflow).
        Phase 2: one small sort_groupby over the n*cap_p gathered partials
        with merge aggregates (count->sum, sum->sum(+nn), min/max->min/max,
        avg->sum/sum). Returns (out_keys, out_valids, occupied, results,
        capacity) in sort_groupby's shape, or None when not applicable
        (no mesh / unknown key domain / domain too wide to win)."""
        mesh = self.mesh
        if mesh is None or not self.config.use_partition_rule or \
                packed is None or span_total is None or keep_ranges is None:
            return None
        axis = self.config.default_mesh_axis
        n = int(mesh.shape[axis])
        cap = alive.shape[0]
        if n <= 1 or cap % n or span_total >= 2**31:
            return None
        Lc = cap // n
        cap_p = K.next_pow2(max(8, span_total))
        if cap_p > Lc // 2:
            return None   # partials wouldn't shrink the merge below 1 shard

        from jax.sharding import PartitionSpec as P
        from jax import shard_map

        # phase-1 specs: avg aggregates split into mergeable (sum, nn)
        p_specs = [("sum" if fn == "avg" else fn, v, vd)
                   for fn, v, vd in agg_inputs]

        # flatten args (None valids can't cross shard_map): data arrays +
        # presence maps
        kd = [jnp.asarray(d) for d in key_data]
        kv_present = [v is not None for v in key_valid]
        arrays = [packed] + kd + [v for v in key_valid if v is not None]
        av_present = []
        for fn, v, vd in p_specs:
            if v is not None:
                arrays.append(v)
            av_present.append((v is not None, vd is not None))
            if vd is not None:
                arrays.append(vd)
        arrays.append(alive)

        def pbody(*args):
            pos = 0
            pk_l = args[pos]; pos += 1
            kd_l = list(args[pos:pos + len(kd)]); pos += len(kd)
            kv_l = []
            for present in kv_present:
                kv_l.append(args[pos] if present else None)
                pos += 1 if present else 0
            specs_l = []
            for (has_v, has_vd), (fn, _v, _vd) in zip(av_present, p_specs):
                v_l = args[pos] if has_v else None
                pos += 1 if has_v else 0
                vd_l = args[pos] if has_vd else None
                pos += 1 if has_vd else 0
                specs_l.append((fn, v_l, vd_l))
            alive_l = args[pos]
            out_k, out_v, occ, ng, res = G.sort_groupby(
                kd_l, kv_l, specs_l, alive_l, packed_key=pk_l,
                sort_subset=sort_subset)
            order = K.compact_order(occ)[:cap_p]
            # re-pack the SORTED key columns (out_k/out_v align with occ;
            # the input packed key pk_l does not)
            pk_sorted = self._pack_sort_key(
                [out_k[p] for p in sort_subset],
                [out_v[p] for p in sort_subset], keep_ranges)
            flat = [jnp.where(occ, pk_sorted,
                              jnp.iinfo(pk_sorted.dtype).max)] + \
                list(out_k) + [v for v in out_v if v is not None] + \
                [d for d, _nn in res] + [nn for _d, nn in res]
            g = K.multi_gather(flat, order)
            row_ok = jnp.arange(cap_p, dtype=jnp.int32) < ng
            return tuple(g) + (row_ok,)

        outs = shard_map(
            pbody, mesh=mesh,
            in_specs=tuple(P(axis) for _ in arrays),
            out_specs=P(axis))(*arrays)
        pos = 0
        pk_m = outs[pos]; pos += 1
        kd_m = list(outs[pos:pos + len(kd)]); pos += len(kd)
        kv_m = []
        for present in kv_present:
            kv_m.append(outs[pos] if present else None)
            pos += 1 if present else 0
        datas_m = list(outs[pos:pos + len(p_specs)]); pos += len(p_specs)
        nns_m = list(outs[pos:pos + len(p_specs)]); pos += len(p_specs)
        row_ok = outs[pos]

        # phase 2: merge partial states (small: n * cap_p rows)
        m_specs = []
        layout = []   # per original spec: (kind, data_idx, nn_idx)
        for i, (fn, _v, _vd) in enumerate(agg_inputs):
            if fn == "count":
                layout.append(("count", len(m_specs), None))
                m_specs.append(("sum", nns_m[i].astype(jnp.int64), None))
            else:
                di = len(m_specs)
                m_specs.append((
                    "min" if fn == "min" else
                    "max" if fn == "max" else "sum",
                    datas_m[i],
                    (nns_m[i] > 0) if fn in ("min", "max") else None))
                ni = len(m_specs)
                m_specs.append(("sum", nns_m[i].astype(jnp.int64), None))
                layout.append((fn, di, ni))
        out_keys, out_valids, occupied, _ng, m_res = G.sort_groupby(
            kd_m, kv_m, m_specs, row_ok, packed_key=pk_m,
            sort_subset=sort_subset)
        results = []
        for kind, di, ni in layout:
            if kind == "count":
                cnt = m_res[di][0]
                results.append((cnt, cnt))
            else:
                data = m_res[di][0]
                nn = m_res[ni][0]
                if kind == "avg":
                    data = data.astype(jnp.float64) / jnp.maximum(nn, 1)
                results.append((data, nn))
        return out_keys, out_valids, occupied, results, n * cap_p

    def _fill_agg_slots(self, node, results, slots, capacity):
        for spec, a, (data, nn) in zip(node.aggregates, node.agg_attrs, results):
            data = data.astype(a.type.device_dtype)
            if spec.fn == "count":
                slots[a.expr_id] = (data, None)
            else:
                slots[a.expr_id] = (data, nn > 0)

    def _scalar_aggregate(self, node: L.Aggregate, chunk: Chunk) -> Chunk:
        # One output row, capacity 8 for alignment.
        capacity = 8
        alive = K.alive_mask(capacity, 1)
        slots = {}
        for spec, a in zip(node.aggregates, node.agg_attrs):
            if spec.distinct and spec.fn == "count":
                d, v = self._eval(chunk, spec.arg)
                d, v = chunk.broadcast(d, v)
                val = G.distinct_count(d, v, chunk.alive)
                nn = jnp.asarray(1, jnp.int64)
            else:
                if spec.arg is None:
                    vals, valid = None, None
                else:
                    vals, valid = self._eval(chunk, spec.arg)
                    vals, valid = chunk.broadcast(vals, valid)
                    if spec.fn in ("sum", "avg") and (spec.arg.type.is_integral or
                                  spec.arg.type.is_decimal):
                        vals = vals.astype(jnp.int64)
                    if spec.distinct:
                        # SUM/AVG/MIN/MAX DISTINCT: dedup via sort boundaries
                        vals, valid, chunk_alive = self._dedup_values(
                            vals, valid, chunk.alive)
                        val, nn = G.scalar_agg(spec.fn, vals, valid, chunk_alive)
                        data = jnp.broadcast_to(
                            jnp.asarray(val, a.type.device_dtype), (capacity,))
                        slots[a.expr_id] = (data, alive & (nn > 0))
                        continue
                val, nn = G.scalar_agg(spec.fn, vals, valid, chunk.alive)
            data = jnp.broadcast_to(jnp.asarray(val, a.type.device_dtype),
                                    (capacity,))
            if spec.fn == "count":
                slots[a.expr_id] = (data, None)
            else:
                slots[a.expr_id] = (data, alive & (nn > 0))
        return Chunk(attrs=list(node.output), slots=slots, alive=alive,
                     capacity=capacity, ranges={})

    def _dedup_values(self, vals, valid, alive):
        live = alive if valid is None else (alive & valid)
        k = jnp.where(live, vals, K.max_sentinel(vals.dtype))
        s = jnp.sort(k)
        n_live = jnp.sum(live.astype(jnp.int32))
        idx = jnp.arange(s.shape[0])
        boundary = ((idx == 0) | (s != jnp.roll(s, 1))) & (idx < n_live)
        return s, None, boundary

    def _distinct_aggregate(self, node, chunk, key_data, key_valid, agg_inputs,
                            distinct_flags, key_ranges):
        """DISTINCT aggregates: pre-dedup (group keys + arg) rows, then aggregate.
        Mirrors the reference's distinctify hash tables
        (AggregationOperationState.cpp). Non-distinct aggregates in the same query
        run on the raw input and are merged positionally."""
        # dedup pass: group by (keys + arg) with no aggregates, then aggregate the
        # deduped chunk for the distinct specs; run non-distinct on the raw chunk.
        out_cols = {}
        base_keys_out = None
        n_groups_out = None
        capacity = chunk.capacity
        results = [None] * len(agg_inputs)
        # non-distinct part on raw input
        nd_inputs = [ai for ai, f in zip(agg_inputs, distinct_flags) if not f]
        if nd_inputs:
            k1, v1, ng, res_nd = G.sort_groupby_compact(
                key_data, key_valid, nd_inputs, chunk.alive)
            base_keys_out, base_valids_out, n_groups_out = k1, v1, ng
            it = iter(res_nd)
            for i, f in enumerate(distinct_flags):
                if not f:
                    results[i] = next(it)
        for i, (ai, f) in enumerate(zip(agg_inputs, distinct_flags)):
            if not f:
                continue
            fn, vals, valid = ai
            dk, dv, dd_alive, dn, _ = G.sort_groupby(
                key_data + [vals], key_valid + [valid], [], chunk.alive)
            sub_keys = dk[:-1]
            sub_valids = dv[:-1]
            sub_vals = dk[-1]
            sub_valid = dv[-1]
            k2, v2, ng2, res_d = G.sort_groupby_compact(
                sub_keys, sub_valids, [(fn, sub_vals, sub_valid)], dd_alive)
            results[i] = res_d[0]
            if base_keys_out is None:
                base_keys_out, base_valids_out, n_groups_out = k2, v2, ng2
        slots = {}
        ranges = {}
        for a, kd, kv, ge in zip(node.group_attrs, base_keys_out,
                                 base_valids_out, node.group_by):
            slots[a.expr_id] = (kd.astype(a.type.device_dtype), kv)
            ranges[a.expr_id] = infer_range(ge, chunk.ranges)
        self._fill_agg_slots(node, results, slots, capacity)
        uniq = [frozenset(a.expr_id for a in node.group_attrs)]
        return Chunk(attrs=list(node.output), slots=slots,
                     alive=K.alive_mask(capacity, n_groups_out),
                     capacity=capacity, ranges=ranges, unique_sets=uniq)

    # ----------------------------------------------------------------
    # joins
    # ----------------------------------------------------------------
    def _exec_Join(self, node: L.Join) -> Chunk:
        if node.kind == "cross":
            return self._cross_join(node)
        if not node.left_keys:
            return self._nested_loops_join(node)
        probe = self._squeeze(self.exec(node.left))
        build = self._squeeze(self.exec(node.right))
        # Estimate-driven dynamic compaction (the reference's
        # InsertDestination effect — blocks after a filter hold only matching
        # tuples, so joins probe the reduced set): compact each side to ~4x
        # its cost-model estimate before any join gather; an under-estimate
        # raises a flag and the standard retry loop re-runs uncompacted.
        idx0 = self.node_index[id(node)]
        ov0 = self.overrides.get(idx0)
        ovg = self.overrides.get(-1)   # plan-wide compaction kill switch
        probe = self._est_compact(
            probe, getattr(node, "est_left_rows", None),
            (ov0 is not None and ov0.no_compact_probe) or
            (ovg is not None and ovg.no_compact_probe),
            f"compact_probe_{idx0}")
        build = self._est_compact(
            build, getattr(node, "est_right_rows", None),
            (ov0 is not None and ov0.no_compact_build) or
            (ovg is not None and ovg.no_compact_build),
            f"compact_build_{idx0}")
        for e in node.left_keys + node.right_keys:
            self._bind_subqueries(e)

        pk_data = []
        pk_valid0 = bk_valid0 = None
        pk_valid = bk_valid = None   # AND of all key validity masks
        for i, e in enumerate(node.left_keys):
            d, v = self._eval(probe, e)
            d, v = probe.broadcast(d, v)
            if i == 0:
                pk_valid0 = v
            if v is not None:
                pk_valid = v if pk_valid is None else (pk_valid & v)
            pk_data.append(d)
        bk_data = []
        for i, e in enumerate(node.right_keys):
            d, v = self._eval(build, e)
            d, v = build.broadcast(d, v)
            if i == 0:
                bk_valid0 = v
            if v is not None:
                bk_valid = v if bk_valid is None else (bk_valid & v)
            bk_data.append(d)
        # SQL equality never matches NULL keys: rows whose key is NULL are
        # excluded from match computation (but still surface as unmatched rows
        # in left/full/anti joins). The reference gets this from null-aware
        # comparators in HashTableKeyManager (storage/HashTableKeyManager.hpp).
        pmask = probe.alive if pk_valid is None else (probe.alive & pk_valid)
        bmask = build.alive if bk_valid is None else (build.alive & bk_valid)

        def na_correct(out):
            """[NOT] IN three-valued logic (reference null-aware anti-join
            semantics): a NULL operand never passes against a non-empty inner
            side; NOT IN passes nothing when the inner side contains a NULL."""
            if not getattr(node, "null_aware", False) or \
                    node.kind not in ("semi", "anti"):
                return out
            alive = out.alive
            if pk_valid0 is not None:
                if node.kind == "semi":
                    alive = alive & pk_valid0
                else:
                    alive = alive & (pk_valid0 | ~jnp.any(build.alive))
            if node.kind == "anti" and bk_valid0 is not None:
                alive = alive & ~jnp.any(build.alive & ~bk_valid0)
            return dataclasses.replace(out, alive=alive)

        # FilterJoin strength reduction (InjectJoinFilters analog): semi/anti
        # joins over a single ranged integer key need only an exact bit-vector
        # LIP filter — no hash table, no row indices.
        if node.kind in ("semi", "anti") and node.residual is None and \
                len(bk_data) == 1 and self.config.use_filter_joins:
            r = self._key_ranges(node.right_keys, build)[0]
            if r is not None and (r[1] - r[0] + 1) <= \
                    self.config.direct_join_domain_limit and \
                    (r[1] - r[0] + 1) <= max(
                        int(self.config.direct_join_density * build.capacity),
                        4 * probe.capacity):
                from quickstep_tpu.ops import bloom as B
                lo, domain = r[0], r[1] - r[0] + 1
                bits = B.exact_filter_build(bk_data[0], bmask, lo, domain)
                matched = B.exact_filter_probe(bits, pk_data[0], pmask, lo)
                if node.kind == "anti":
                    matched = probe.alive & ~matched
                return na_correct(dataclasses.replace(
                    probe, alive=probe.alive & matched))

        build_key_ids = [e.expr_id for e in node.right_keys
                         if isinstance(e, Attr)]
        build_unique = (len(build_key_ids) == len(node.right_keys)) and \
            build.is_unique(build_key_ids)
        ov = self.overrides.get(self.node_index[id(node)])
        if node.kind == "full":
            return self._full_join(node, probe, build, pk_data, bk_data, ov,
                                   build_unique, pmask, bmask)
        strategy = None
        if ov and ov.strategy:
            strategy = ov.strategy
        elif build_unique or node.kind in ("semi", "anti"):
            # semi/anti need only existence: duplicates in build are harmless for
            # the pure-key case (residuals force the expansion path below)
            if node.kind in ("semi", "anti") and node.residual is not None:
                strategy = "expand"
            else:
                strategy = "unique"
        else:
            strategy = "expand"

        if node.kind in ("semi", "anti") and strategy == "expand" and \
                (ov is None or ov.strategy is None):
            # a compaction-overflow override (no_compact_*) must NOT knock
            # the join off the merge-cmp path: that silently regressed Q21's
            # correlated <>-EXISTS joins 15x onto expansion when the 2x
            # compaction cushion tripped its retry
            out = self._semi_stats_join(node, probe, build, pk_data, bk_data,
                                        pmask, bmask)
            if out is not None:
                return na_correct(out)
        if pk_valid is None and bk_valid is None:
            out = self._shuffle_join(node, probe, build, pk_data, bk_data, ov,
                                     strategy, build_unique)
            if out is not None:
                return na_correct(out)
        return na_correct(self._join_local(
            node, probe, build, pk_data, bk_data, ov, strategy, build_unique,
            pmask, bmask))

    def _join_local(self, node, probe, build, pk_data, bk_data, ov, strategy,
                    build_unique, pmask, bmask):
        """Communication-free join core on (device-local or whole) chunks.
        pmask/bmask = alive AND key-validity (NULL keys never match)."""
        if strategy == "unique":
            return self._unique_join(node, probe, build, pk_data, bk_data,
                                     check_dups=not build_unique,
                                     pmask=pmask, bmask=bmask)
        return self._expand_join(node, probe, build, pk_data, bk_data, ov,
                                 pmask, bmask)

    def _shuffle_join(self, node, probe, build, pk_data, bk_data, ov,
                      strategy, build_unique) -> Optional[Chunk]:
        """Key-partitioned (radix all_to_all) join over the mesh — the
        Partition-rule + PartitionAwareInsertDestination + PartitionedHashTablePool
        analog (query_optimizer/rules/Partition.hpp:45-87,
        storage/PartitionedHashTablePool.hpp:49). Both sides are hash-routed by
        join key over the interconnect inside one shard_map region; the join core then runs
        device-local. Returns None when not applicable (no mesh / small build
        side better served by broadcast / unsupported join shape)."""
        mesh = self.mesh
        if mesh is None or not self.config.use_partition_rule:
            return None
        axis = self.config.default_mesh_axis
        n = int(mesh.shape[axis])
        if n <= 1:
            return None
        if node.kind not in ("inner", "left", "semi", "anti"):
            return None
        if getattr(node, "null_aware", False):
            return None  # needs global any(build.alive): keep the GSPMD path
        # broadcast-join (replicated build) is cheaper for small build sides
        if build.capacity < self.config.replicate_threshold_rows:
            return None
        if probe.capacity % n or build.capacity % n:
            return None

        from quickstep_tpu.parallel import shuffle as SH
        from jax.sharding import PartitionSpec as P
        from jax import shard_map

        # the exchange marshals whole columns: materialize any pending lazy
        # gather maps before flattening (laziness resumes device-local)
        probe.materialize_all()
        build.materialize_all()
        # routing key only: colliding hash packs just co-locate distinct keys
        # on one device (harmless); _join_local re-packs from real columns
        packed_b, packed_p, _hashed = self._pack_keys(node, build, probe,
                                                      bk_data, pk_data)
        # == marshal payloads: key exprs + every attr column (+ valid masks) ==
        def flatten_side(chunk, key_cols):
            arrays = [c for c in key_cols]
            layout = []   # (expr_id, has_valid)
            for a in chunk.attrs:
                d, v = chunk.slots[a.expr_id]
                d = jnp.asarray(d)
                if d.ndim == 0:
                    d = jnp.broadcast_to(d, (chunk.capacity,))
                arrays.append(d)
                if v is not None:
                    arrays.append(v)
                layout.append((a.expr_id, v is not None))
            return arrays, layout

        p_arrays, p_layout = flatten_side(probe, [packed_p] + list(pk_data))
        b_arrays, b_layout = flatten_side(build, [packed_b] + list(bk_data))
        nkeys = len(pk_data)

        factor = ov.shuffle_factor if ov else 1
        Lp, Lb = probe.capacity // n, build.capacity // n
        # heavy-hitter salting: if the hottest build key exceeds one device's
        # average build share, split its probe stream across `salt` replicas
        salt = 1
        key_ids = [e.expr_id for e in node.right_keys if isinstance(e, Attr)]
        if len(key_ids) == len(node.right_keys) and key_ids:
            mc = min((build.max_counts.get(i) for i in key_ids
                      if i in build.max_counts), default=None)
            if mc is not None and mc > Lb:
                salt = min(n, K.next_pow2(-(-mc * n // build.capacity)))
        # Cost-model-driven bucket capacity (repartition planning sized by
        # the cost model — query_optimizer/rules/Partition.hpp:67-87): size
        # receive buckets from the ESTIMATED live rows (4x cushion, same
        # policy as pre-join compaction), not raw capacity; the
        # shuffle_factor overflow-retry is the backstop for under-estimates.
        est_p = getattr(node, "est_left_rows", None)
        est_b = getattr(node, "est_right_rows", None)
        live_p = min(1.0, 4.0 * est_p / max(probe.capacity, 1)) \
            if est_p else 1.0
        live_b = min(1.0, 4.0 * est_b / max(build.capacity, 1)) \
            if est_b else 1.0
        # skew cushion: hash-partitioned bucket counts concentrate tightly
        # around the mean except for heavy keys, whose mass is bounded
        # exactly by the stats' max_counts — so when the heaviest probe key
        # is known, size buckets as 1.25x mean + one heavy key instead of a
        # blanket 2x (the overflow-retry remains the backstop)
        pk_ids = [e.expr_id for e in node.left_keys if isinstance(e, Attr)]
        mc_p = min((probe.max_counts.get(i) for i in pk_ids
                    if i in probe.max_counts), default=None) \
            if len(pk_ids) == len(node.left_keys) and pk_ids else None

        def psize(rows_per_dev):
            if mc_p is None:
                return -(-int(2 * rows_per_dev) // n)
            return -(-int(1.25 * rows_per_dev) // n) + int(mc_p)
        bp = factor * max(8, psize(Lp * live_p))
        bb = factor * max(8, -(-int(2 * Lb * live_b) * salt // n))
        recv_p, recv_b = n * bp, n * bb

        # Exchange/compute overlap (SURVEY §5 mandate — the InsertDestination
        # pipelining analog, storage/InsertDestination.hpp:229): the probe side
        # is split into `chunks` independent slices, each with its own
        # all_to_all + device-local join. Chunk i+1's exchange has no data
        # dependence on chunk i's join, so XLA's latency-hiding scheduler
        # overlaps the collective with the compute (async all-to-all
        # start/done) — double buffering by dependence structure, not by hand.
        chunks = max(1, int(getattr(self.config, "shuffle_overlap_chunks", 1)))
        if chunks > 1 and Lp % chunks != 0:
            chunks = 1
        Lc = Lp // chunks

        # Pre-shuffle LIP filter (distributed AttachLIPFilters analog,
        # query_optimizer/rules/AttachLIPFilters.hpp:55 +
        # utility/lip_filter/SingleIdentityHashFilter.hpp:55): a one-hash
        # bloom bitmap over the build side's keys is all-reduced across the
        # mesh BEFORE the probe exchange, and probe rows that cannot match
        # are dropped pre-bucketing. For selective builds the probe bucket
        # caps shrink with the estimated pass rate (overflow-retry escalates
        # if the estimate was wrong), cutting actual exchange bytes.
        # Only inner/semi joins may drop probe rows (left/anti must surface
        # non-matching rows).
        use_lip = (self.config.use_lip_filters and
                   node.kind in ("inner", "semi"))
        lip_bits = 0
        sel = 1.0
        if use_lip:
            lip_bits = K.next_pow2(
                int(min(max(4 * build.capacity, 1024), 1 << 22)))
            branges = self._key_ranges(node.right_keys, build)
            pranges = self._key_ranges(node.left_keys, probe)
            if len(branges) == 1 and branges[0] is not None and \
                    pranges[0] is not None:
                blo, bhi = branges[0]
                plo, phi = pranges[0]
                olo, ohi = max(blo, plo), min(bhi, phi)
                if ohi < olo:
                    sel = 0.0
                else:
                    inside = (ohi - olo + 1) / max(phi - plo + 1, 1)
                    hit = min(1.0, build.capacity / max(bhi - blo + 1, 1))
                    sel = inside * hit
            # conservative floor: a wrong estimate costs an overflow-retry
            # recompile, so never shrink below 1/8 of the unfiltered cap
            sel = max(min(sel, 1.0), 0.125)
        bp_c = factor * max(8, psize(Lc * sel * live_p))
        recv_p_c = n * bp_c
        # logical exchange volume: every marshaled array crosses the
        # all_to_all once (bucketed, so actual bytes = bucket capacity)
        probe_row_bytes = sum(jnp.asarray(a).dtype.itemsize
                              for a in p_arrays) + 1
        build_row_bytes = sum(jnp.asarray(a).dtype.itemsize
                              for a in b_arrays) + 1
        exchange_bytes = n * (chunks * recv_p_c * probe_row_bytes +
                              recv_b * build_row_bytes)
        self.last_shuffle_info = {
            "chunks": chunks, "lip_bits": lip_bits,
            "probe_bucket_rows": chunks * recv_p_c,
            "build_bucket_rows": recv_b, "sel_est": round(sel, 4),
            "exchange_bytes": int(exchange_bytes)}
        # trace-time breadcrumb for \explain_analyze and tests (the runner
        # itself lives only inside the jit trace)
        type(self).trace_shuffle_info = dict(self.last_shuffle_info)

        idx = self.node_index[id(node)]
        static_out = {}
        pre_flags = set(self.flags)

        def body(p_in, b_in):
            pk = p_in[0]
            p_pay, p_alive_in = p_in[1:-1], p_in[-1]
            bk = b_in[0]
            b_pay, b_alive_in = b_in[1:-1], b_in[-1]
            b_ex, b_alive, b_over = SH.radix_exchange(
                bk, [bk] + list(b_pay), b_alive_in, n, axis, bb, salt=salt,
                probe_side=False)

            def rebuild(chunk, layout, ex, alive, cap):
                pos = 1 + nkeys  # packed key + key exprs lead the payload
                keys = list(ex[1:pos])
                slots = {}
                for expr_id, has_valid in layout:
                    d = ex[pos]
                    pos += 1
                    v = None
                    if has_valid:
                        v = ex[pos] & alive
                        pos += 1
                    slots[expr_id] = (d, v)
                return keys, Chunk(
                    attrs=list(chunk.attrs), slots=slots, alive=alive,
                    capacity=cap, ranges=dict(chunk.ranges),
                    unique_sets=list(chunk.unique_sets),
                    max_counts=dict(chunk.max_counts), fds=list(chunk.fds))

            bk_loc, build_loc = rebuild(build, b_layout, b_ex, b_alive, recv_b)

            lip = None
            if use_lip:
                from quickstep_tpu.ops.kernels import hash64 as _h64
                local_bits = jnp.zeros((lip_bits,), jnp.int32).at[
                    (_h64(bk.astype(jnp.int64)) &
                     jnp.uint64(lip_bits - 1)).astype(jnp.int32)].add(
                    b_alive_in.astype(jnp.int32), mode="drop")
                lip = jax.lax.psum(local_bits, axis) > 0

            over = b_over
            chunk_flags = {}
            out_chunks = []
            Ll = pk.shape[0]
            Lcl = Ll // chunks
            for ci in range(chunks):
                sl = slice(ci * Lcl, (ci + 1) * Lcl)
                pk_c = pk[sl]
                pay_c = [x[sl] for x in p_pay]
                alive_c = p_alive_in[sl]
                if lip is not None:
                    from quickstep_tpu.ops.kernels import hash64 as _h64
                    alive_c = alive_c & lip[
                        (_h64(pk_c.astype(jnp.int64)) &
                         jnp.uint64(lip_bits - 1)).astype(jnp.int32)]
                p_ex, p_alive, p_over = SH.radix_exchange(
                    pk_c, [pk_c] + pay_c, alive_c, n, axis, bp_c,
                    salt=salt, probe_side=True)
                pk_loc, probe_loc = rebuild(probe, p_layout, p_ex, p_alive,
                                            recv_p_c)
                out_c = self._join_local(
                    node, probe_loc, build_loc, pk_loc, bk_loc,
                    ov, strategy, build_unique,
                    probe_loc.alive, build_loc.alive)
                out_c.materialize_all()   # body output crosses shard_map
                # per-chunk runtime flags OR together (overwrites would lose
                # an earlier chunk's overflow signal)
                for k in list(self.flags):
                    if k not in pre_flags:
                        v = self.flags.pop(k)
                        chunk_flags[k] = (chunk_flags[k] | v) \
                            if k in chunk_flags else v
                over = over | p_over
                out_chunks.append(out_c)
            self.flags.update(chunk_flags)
            out = out_chunks[0] if chunks == 1 \
                else _concat_join_chunks(out_chunks)
            static_out["attrs"] = out.attrs
            static_out["ranges"] = out.ranges
            static_out["capacity"] = out.capacity
            static_out["order"] = [a.expr_id for a in out.attrs]
            outs = []
            for a in out.attrs:
                d, v = out.slots[a.expr_id]
                d = jnp.asarray(d)
                if d.ndim == 0:
                    d = jnp.broadcast_to(d, (out.capacity,))
                outs.append(d)
                outs.append(v if v is not None
                            else jnp.ones((out.capacity,), bool))
            flags = {}
            for k in list(self.flags):
                if k not in pre_flags:
                    v = self.flags.pop(k)
                    flags[k] = jax.lax.pmax(
                        jnp.asarray(v).astype(jnp.int32), axis) > 0
            flags[f"shuffle_overflow_{idx}"] = jax.lax.pmax(
                over.astype(jnp.int32), axis) > 0
            return tuple(outs), out.alive, flags

        fn = shard_map(body, mesh=mesh,
                       in_specs=(P(axis), P(axis)),
                       out_specs=(P(axis), P(axis), P()))
        outs, alive, flags = fn(tuple(p_arrays) + (probe.alive,),
                                tuple(b_arrays) + (build.alive,))
        for k, v in flags.items():
            self.flags[k] = (self.flags[k] | v) if k in self.flags else v
        slots = {}
        for i, eid in enumerate(static_out["order"]):
            slots[eid] = (outs[2 * i], outs[2 * i + 1])
        return Chunk(attrs=list(static_out["attrs"]), slots=slots, alive=alive,
                     capacity=n * static_out["capacity"],
                     ranges=dict(static_out["ranges"]))

    def _semi_stats_join(self, node, probe, build, pk_data, bk_data,
                         pmask, bmask):
        """Semi/anti join with a single-comparison residual, without expansion:
        EXISTS (x in group(k) with x OP v) is decidable from per-group min/max
        of x — group the build side by the join keys (one sort), then a unique
        join against the groups (Q21's correlated <> EXISTS pattern).
        Returns None when the residual shape doesn't match."""
        res = node.residual
        if not (isinstance(res, Cmp) and res.op in ("<>", "<", ">", "<=", ">=")):
            return None
        build_ids = {a.expr_id for a in build.attrs}
        probe_ids = {a.expr_id for a in probe.attrs}
        lref = res.lhs.referenced_attrs()
        rref = res.rhs.referenced_attrs()
        if lref and lref <= build_ids and rref and rref <= probe_ids:
            build_expr, probe_expr, op = res.lhs, res.rhs, _flip_cmp(res.op)
        elif rref and rref <= build_ids and lref and lref <= probe_ids:
            build_expr, probe_expr, op = res.rhs, res.lhs, res.op
        else:
            return None
        bx, bxv = build.broadcast(*self._eval(build, build_expr))
        if bxv is not None:
            return None  # null semantics in min/max stats: fall back
        key_ranges = self._key_ranges(node.right_keys, build)
        # Merge probe needs an injective packing valid for BOTH sides, so
        # the pack ranges are the union of build/probe key ranges.
        pranges = self._key_ranges(node.left_keys, probe)
        merged_ranges = None
        if all(r is not None for r in key_ranges) and \
                all(r is not None for r in pranges):
            merged_ranges = [(min(a[0], b[0]), max(a[1], b[1]))
                             for a, b in zip(key_ranges, pranges)]
        packed_b = packed_pk = None
        if merged_ranges is not None:
            packed_b = self._pack_sort_key(
                bk_data, [None] * len(bk_data), merged_ranges)
            packed_pk = self._pack_sort_key(
                pk_data, [None] * len(pk_data), merged_ranges)
        px, pxv = probe.broadcast(*self._eval(probe, probe_expr))
        if packed_b is not None and packed_pk is not None and \
                jnp.issubdtype(bx.dtype, jnp.integer) and \
                jnp.iinfo(bx.dtype).bits <= 32 and \
                jnp.issubdtype(px.dtype, jnp.integer) and \
                jnp.iinfo(px.dtype).bits <= 32:
            # fused merge-cmp semi join: one concat sort + segmented scans +
            # a single-operand sort-back (no group materialization, no stat
            # gathers, no full-width probe comparisons in probe order)
            matched = J.merge_cmp_probe(packed_b, bmask, bx,
                                        packed_pk, pmask, px, op)
            if pxv is not None:
                matched = matched & pxv
            if node.kind == "anti":
                matched = ~matched
            return dataclasses.replace(probe, alive=probe.alive & matched)
        # fallback (wide values / unpackable keys): grouped stats + probe
        out_keys, _, galive, _n_groups, results = G.sort_groupby(
            bk_data, [None] * len(bk_data),
            [("min", bx, None), ("max", bx, None)],
            bmask, packed_key=packed_b)
        if packed_b is not None and packed_pk is not None:
            packed_g = self._pack_sort_key(
                out_keys, [None] * len(out_keys), merged_ranges)
            gidx, matched, _dup = J.merge_unique_probe(
                packed_g.astype(jnp.int64), galive,
                packed_pk.astype(jnp.int64), pmask)
        else:
            tsize = K.next_pow2(2 * build.capacity)
            table, _ = J.oa_build(out_keys, galive, tsize)
            gidx, matched = J.oa_probe(table, out_keys, pk_data, pmask)
        safe = jnp.clip(gidx, 0, build.capacity - 1)
        gmin, gmax = K.multi_gather([results[0][0], results[1][0]], safe)
        # exists x in group with (probe_val OP' x)? where op is probe OP build:
        # evaluate via extremes
        cmp_t = jnp.promote_types(px.dtype, gmin.dtype)
        px64 = px.astype(cmp_t)
        gmin = gmin.astype(cmp_t)
        gmax = gmax.astype(cmp_t)
        if op == "<>":
            hit = (gmin != px64) | (gmax != px64)
        elif op == "<":      # probe < x for some x  <=>  probe < max
            hit = px64 < gmax
        elif op == "<=":
            hit = px64 <= gmax
        elif op == ">":
            hit = px64 > gmin
        else:
            hit = px64 >= gmin
        if pxv is not None:
            hit = hit & pxv
        matched = matched & hit
        if node.kind == "anti":
            matched = ~matched
        return dataclasses.replace(probe, alive=probe.alive & matched)

    def _full_join(self, node, probe, build, pk_data, bk_data, ov,
                   build_unique, pmask, bmask):
        """FULL OUTER JOIN = left-outer join ++ null-extended unmatched build
        rows, concatenated into a capacity P(+ expansion)+B chunk (reference
        kLeftOuterJoin + BuildAggregationExistenceMapOperator existence-bitmap
        pattern, relational_operators/BuildAggregationExistenceMapOperator.hpp:61
        — here the existence mask comes from a reverse hash probe instead of a
        shared bitmap)."""
        left_node = dataclasses.replace(node, kind="left")
        idx = self.node_index[id(node)]
        self.node_index[id(left_node)] = idx
        if build_unique and not (ov and ov.strategy == "expand"):
            out = self._unique_join(left_node, probe, build, pk_data, bk_data,
                                    check_dups=False, pmask=pmask, bmask=bmask)
        else:
            out = self._expand_join(left_node, probe, build, pk_data, bk_data,
                                    ov, pmask, bmask)

        # Which build rows found a partner? Reverse existence merge-probe.
        if node.residual is None:
            packed_b, packed_p, hashed = self._pack_keys(node, build, probe,
                                                         bk_data, pk_data)
            if not hashed:
                _pidx, bmatched, _dup = J.merge_unique_probe(
                    packed_p, pmask, packed_b, bmask)
            else:
                # non-injective packing: existence needs the whole equal-pack
                # run verified (a colliding probe key could hide the true
                # partner); walk it with the expansion primitive, K escalated
                # by the standard overflow retry
                sorted_p, order_p = J.sorted_build(packed_p, pmask)
                kmax = (ov.max_matches if ov and ov.max_matches else 8)
                rows, counts = J.expand_probe(sorted_p, order_p, packed_b,
                                              bmask, kmax)
                bmatched = jnp.zeros((build.capacity,), bool)
                for k in range(kmax):
                    pid_k = rows[k::kmax]
                    okk = pid_k >= 0
                    okk = self._verify_keys(pid_k, okk, bk_data, pk_data)
                    bmatched = bmatched | okk
                okey = f"join_overflow_{idx}"
                over = jnp.any(counts > kmax)
                self.flags[okey] = (self.flags[okey] | over) \
                    if okey in self.flags else over
        else:
            # residual participates in matching: expand from the build side and
            # test the residual per candidate pair
            packed_b, packed_p, hashed = self._pack_keys(node, build, probe,
                                                         bk_data, pk_data)
            sorted_key, order = J.sorted_build(packed_p, pmask)
            kmax = (ov.max_matches if ov and ov.max_matches
                    else self._default_k(node, probe, node.left_keys))
            rows, counts = J.expand_probe(sorted_key, order, packed_b,
                                          bmask, kmax)
            okey = f"join_overflow_{idx}"
            rev_over = jnp.any(counts > kmax)
            self.flags[okey] = (self.flags[okey] | rev_over) \
                if okey in self.flags else rev_over
            bmatched = jnp.zeros((build.capacity,), bool)
            for k in range(kmax):
                pidx = rows[k::kmax]   # rows is flat row-major [n*K]
                okk = pidx >= 0
                if hashed:
                    okk = self._verify_keys(pidx, okk, bk_data, pk_data)
                pair = self._pair_chunk(node, build, probe, pidx, okk)
                passed = self._eval_pred(pair, node.residual)
                bmatched = bmatched | (okk & passed)
        tail_alive = build.alive & ~bmatched

        # Concatenate: left-join output on top, unmatched build rows (probe side
        # null-extended) below. (Concat ends laziness: materialize both parts.)
        out.materialize_all()
        build.materialize_all()
        build_ids = {a.expr_id for a in build.attrs}
        slots = {}
        for a in node.output:
            d, v = out.slots[a.expr_id]
            d = jnp.asarray(d)
            if d.ndim == 0:
                d = jnp.broadcast_to(d, (out.capacity,))
            if a.expr_id in build_ids:
                td, tv = build.slots[a.expr_id]
                td = jnp.asarray(td)
                if td.ndim == 0:
                    td = jnp.broadcast_to(td, (build.capacity,))
                tail_v = tv
            else:
                td = jnp.zeros((build.capacity,), d.dtype)
                tail_v = jnp.zeros((build.capacity,), bool)
            data = jnp.concatenate([d, td.astype(d.dtype)])
            if v is None and tail_v is None:
                valid = None
            else:
                valid = jnp.concatenate([
                    v if v is not None else jnp.ones((out.capacity,), bool),
                    tail_v if tail_v is not None
                    else jnp.ones((build.capacity,), bool)])
            slots[a.expr_id] = (data, valid)
        alive = jnp.concatenate([out.alive, tail_alive])
        ranges = {a.expr_id: (out.ranges.get(a.expr_id)
                              if a.expr_id not in build_ids
                              else build.ranges.get(a.expr_id))
                  for a in node.output}
        return Chunk(attrs=list(node.output), slots=slots, alive=alive,
                     capacity=out.capacity + build.capacity, ranges=ranges)

    def _key_ranges(self, keys, chunk):
        return [infer_range(e, chunk.ranges) for e in keys]

    def _unique_join(self, node, probe, build, pk_data, bk_data, check_dups,
                     pmask=None, bmask=None):
        """Build once, probe with ≤1 match per probe row. Covers inner/left/semi/
        anti joins against unique (PK-style) build sides."""
        pmask = probe.alive if pmask is None else pmask
        bmask = build.alive if bmask is None else bmask
        ranges = self._key_ranges(node.right_keys, build)
        use_direct = False
        if len(bk_data) == 1 and ranges[0] is not None:
            domain = ranges[0][1] - ranges[0][0] + 1
            # density alone is the wrong proxy: a direct table's cost is
            # ONE domain-sized memset+scatter, so even a build-sparse table
            # beats the merge path (multi-pass sorts over the probe) whenever
            # the domain is small next to the probe. Without the
            # probe-relative clause, pre-join build compaction (which shrinks
            # build.capacity) used to flip Q10's orderkey join from direct to
            # merge.
            use_direct = (domain <= self.config.direct_join_domain_limit and
                          (domain <= self.config.direct_join_density *
                           build.capacity or
                           domain <= 4 * probe.capacity))
        if use_direct:
            lo, hi = ranges[0]
            domain = hi - lo + 1
            table, dup = J.direct_build(bk_data[0], bmask, lo, domain)
            bidx, matched = J.direct_probe(table, pk_data[0], pmask, lo,
                                           domain)
        else:
            # merge join (sort + counting merge): no probe loops, no random
            # gathers — see J.merge_starts. Hash-packed composite keys can
            # collide; verify the actual key columns on candidates.
            packed_b, packed_p, hashed = self._pack_keys(node, build, probe,
                                                         bk_data, pk_data)
            bidx, matched, dup = J.merge_unique_probe(packed_b, bmask,
                                                      packed_p, pmask)
            if hashed:
                matched = self._verify_keys(bidx, matched, pk_data, bk_data)
                bidx = jnp.where(matched, bidx, -1)
                # non-injective packing: two REAL keys may collide into one
                # packed run, shadowing a true match behind the run's first
                # row — the dup flag must fire even for declared-unique
                # builds so the executor retries on the (verifying)
                # expansion path
                check_dups = True
        if check_dups:
            self.flags[f"join_dup_{self.node_index[id(node)]}"] = dup

        if node.kind == "semi":
            return dataclasses.replace(probe, alive=probe.alive & matched)
        if node.kind == "anti":
            return dataclasses.replace(probe, alive=probe.alive & ~matched)

        # inner/left: late materialization — build columns become LazyCols
        # sharing one row-id gather map; payload bytes are gathered only when
        # (and if) a downstream operator reads them, usually post-compaction
        # (the copy-elision analog, HashJoinOperator.hpp:420-422)
        safe = jnp.clip(bidx, 0, build.capacity - 1)
        slots = dict(probe.slots)
        ranges_out = dict(probe.ranges)
        build_lazy = compose_slots(
            build, safe, matched if node.kind == "left" else None)
        for a in build.attrs:
            slots[a.expr_id] = build_lazy[a.expr_id]
            ranges_out[a.expr_id] = build.ranges.get(a.expr_id)
        alive = probe.alive if node.kind == "left" else (probe.alive & matched)
        # FDs: both sides' row-wise FDs survive; the probe-side join keys
        # determine the matched build row (unique build), hence all build attrs;
        # joined key pairs determine each other (equal values).
        fds = list(probe.fds) + list(build.fds)
        probe_key_ids = frozenset(
            e.expr_id for e in node.left_keys if isinstance(e, Attr))
        build_key_ids = frozenset(
            e.expr_id for e in node.right_keys if isinstance(e, Attr))
        if len(probe_key_ids) == len(node.left_keys):
            fds.append((probe_key_ids,
                        frozenset(a.expr_id for a in build.attrs)))
            if len(build_key_ids) == len(node.right_keys):
                fds.append((build_key_ids, probe_key_ids))
        out = Chunk(attrs=list(node.output), slots=slots, alive=alive,
                    capacity=probe.capacity, bound=probe.bound,
                    ranges=ranges_out,
                    unique_sets=list(probe.unique_sets), fds=fds)
        if node.residual is not None:
            if node.kind == "left":
                # residual participates in the match, not as a post-filter
                passed = self._eval_pred(out, node.residual)
                # un-matched or failed-residual: null build side
                keep = matched & passed
                out.restrict_valid([a.expr_id for a in build.attrs], keep)
            else:
                passed = self._eval_pred(out, node.residual)
                out.alive = out.alive & passed
        return out

    def _expand_join(self, node, probe, build, pk_data, bk_data, ov,
                     pmask=None, bmask=None):
        """Sort-based expansion join: handles duplicate build keys, residuals on
        semi/anti, and many-many inner joins."""
        pmask = probe.alive if pmask is None else pmask
        bmask = build.alive if bmask is None else bmask
        # pack build keys into one int64 (range-packed; falls back to hash packing)
        packed_b, packed_p, hashed = self._pack_keys(node, build, probe,
                                                     bk_data, pk_data)
        sorted_key, order = J.sorted_build(packed_b, bmask)
        max_matches = (ov.max_matches if ov and ov.max_matches
                       else self._default_k(node, build, node.right_keys))
        rows, counts = J.expand_probe(sorted_key, order, packed_p, pmask,
                                      max_matches)
        self.flags[f"join_overflow_{self.node_index[id(node)]}"] = \
            jnp.any(counts > max_matches)

        if node.kind in ("semi", "anti"):
            if node.residual is None and not hashed:
                matched = counts > 0
            else:
                any_match = jnp.zeros((probe.capacity,), bool)
                for k in range(max_matches):
                    bidx = rows[k::max_matches]   # flat row-major [n*K]
                    ok = bidx >= 0
                    if hashed:  # hash-packed: candidates need key verification
                        ok = self._verify_keys(bidx, ok, pk_data, bk_data)
                    if node.residual is not None:
                        pair = self._pair_chunk(node, probe, build, bidx, ok)
                        ok = ok & self._eval_pred(pair, node.residual)
                    any_match = any_match | ok
                matched = any_match
            if node.kind == "anti":
                matched = ~matched
            return dataclasses.replace(probe, alive=probe.alive & matched)

        # inner/left expansion: output capacity = probe capacity * K, flattened
        cap = probe.capacity * max_matches
        bidx = rows   # already flat row-major [n*K]
        ok = bidx >= 0
        if hashed:  # hash-packed candidates can collide: verify actual keys
            ok = self._verify_keys(bidx, ok, pk_data, bk_data,
                                   repeat=max_matches)
        safe_b = jnp.clip(bidx, 0, build.capacity - 1)
        # Late materialization: probe rows repeat K times as a structured
        # repeat of the int32 gather maps only; build columns share one
        # candidate-row-id map. No payload column is touched at expansion
        # width. take_ok stays None: `alive` already excludes non-candidates,
        # and introducing a validity mask would divert downstream group-bys
        # off the dense (null-free) path.
        slots = repeat_slots(probe, max_matches)
        build_lazy = compose_slots(build, safe_b, None)
        for a in build.attrs:
            slots[a.expr_id] = build_lazy[a.expr_id]
        alive = jnp.repeat(probe.alive, max_matches) & ok
        pb = probe.bound if probe.bound is not None else probe.capacity
        out = Chunk(attrs=list(node.output), slots=slots, alive=alive,
                    capacity=cap, bound=min(pb * max_matches, cap),
                    ranges={**{a.expr_id: probe.ranges.get(a.expr_id)
                               for a in probe.attrs},
                            **{a.expr_id: build.ranges.get(a.expr_id)
                               for a in build.attrs}},
                    fds=list(probe.fds) + list(build.fds))
        if node.residual is not None:
            passed = self._eval_pred(out, node.residual)
            out.alive = out.alive & passed
        if node.kind == "left":
            # ON-clause semantics: a probe row is matched only when some
            # key-matched candidate ALSO passes the residual; otherwise it is
            # kept once (k == 0 slot) with a null build side.
            # Strided ORs instead of a [n, K] reshape (a 2-D array with a
            # small last dim was lane-padded on the earlier accelerator).
            has_match = out.alive[0::max_matches]
            for k in range(1, max_matches):
                has_match = has_match | out.alive[k::max_matches]
            first_slot = (jnp.arange(cap) % max_matches) == 0
            unmatched = jnp.repeat(probe.alive & ~has_match, max_matches) & \
                first_slot
            out.alive = out.alive | unmatched
            # null-extend the build side on resurrected slot-0 rows (the
            # slot-0 candidate may be key-matched but residual-failed, so
            # `ok` alone does not cover it)
            out.restrict_valid([a.expr_id for a in build.attrs], ~unmatched)
        return out

    def _pair_chunk(self, node, probe, build, bidx, ok):
        """Probe-aligned chunk with one candidate build row gathered per probe row
        (for residual evaluation in semi/anti expansion)."""
        safe = jnp.clip(bidx, 0, build.capacity - 1)
        slots = dict(probe.slots)
        # lazy compose: only the columns the residual actually references get
        # gathered (at residual-eval time), not every build column. ok is not
        # folded into validity — every caller ANDs `ok` into its own result
        # and `alive` excludes non-candidates.
        build_lazy = compose_slots(build, safe, None)
        for a in build.attrs:
            slots[a.expr_id] = build_lazy[a.expr_id]
        return Chunk(attrs=list(probe.attrs) + list(build.attrs), slots=slots,
                     alive=probe.alive & ok, capacity=probe.capacity)

    def _pack_keys(self, node, build, probe, bk_data, pk_data):
        """Returns (packed_build, packed_probe, hashed). When `hashed` is True
        the packing is NOT injective and consumers must verify the actual key
        columns on every candidate pair (_verify_keys) — the analog of the
        reference's key-equality check in every hash-table probe
        (storage/HashTable.hpp bulk probe loops)."""
        weak = getattr(self.config, "test_weak_hash_join", False)
        if not weak:
            if len(bk_data) == 1:
                return (bk_data[0].astype(jnp.int64),
                        pk_data[0].astype(jnp.int64), False)
            ranges = self._key_ranges(node.right_keys, build)
            pranges = self._key_ranges(node.left_keys, probe)
            merged = []
            for rb, rp in zip(ranges, pranges):
                if rb is None or rp is None:
                    merged = None
                    break
                merged.append((min(rb[0], rp[0]), max(rb[1], rp[1])))
            if merged is not None:
                total = 1
                for lo, hi in merged:
                    total *= (hi - lo + 1)
                if total < 2**62:
                    def pack(cols):
                        acc = jnp.zeros(cols[0].shape, jnp.int64)
                        for c, (lo, hi) in zip(cols, merged):
                            acc = acc * (hi - lo + 1) + \
                                (c.astype(jnp.int64) - lo)
                        return acc
                    return pack(bk_data), pack(pk_data), False
        else:
            # test hook: a deliberately colliding "hash" (mod 3) so the
            # verify-gather path is exercised by adversarial tests
            hb = jnp.zeros(bk_data[0].shape, jnp.int64)
            hp = jnp.zeros(pk_data[0].shape, jnp.int64)
            for b, p in zip(bk_data, pk_data):
                hb = hb + b.astype(jnp.int64)
                hp = hp + p.astype(jnp.int64)
            return hb % 3, hp % 3, True
        from quickstep_tpu.ops.kernels import hash64, hash_combine
        hb = hash_combine([hash64(c.astype(jnp.int64)) for c in bk_data])
        hp = hash_combine([hash64(c.astype(jnp.int64)) for c in pk_data])
        return hb.astype(jnp.int64), hp.astype(jnp.int64), True

    def _verify_keys(self, idx, ok, src_keys, dst_keys, repeat=1):
        """Collision guard for hash-packed keys: gather the actual key columns
        of the dst side at `idx` and require equality with the src side's key
        columns (src repeated `repeat`-fold for expansion layouts)."""
        dst = [jnp.asarray(c) for c in dst_keys]
        safe = jnp.clip(idx, 0, dst[0].shape[0] - 1)
        gathered = K.multi_gather(dst, safe)
        good = ok
        for g, s in zip(gathered, src_keys):
            s = jnp.asarray(s)
            if repeat > 1:
                s = jnp.repeat(s, repeat)
            good = good & (g == s.astype(g.dtype))
        return good

    def _default_k(self, node, build=None, keys=None) -> int:
        """Expansion width K: the max run of equal build keys. Exact stats
        (analyze's per-column heaviest-duplicate count) give an upper bound —
        composite runs can't exceed the tightest single-key bound; without
        stats fall back to 8 and rely on the overflow-retry loop."""
        if build is not None and keys:
            bounds = [build.max_counts[e.expr_id] for e in keys
                      if isinstance(e, Attr) and e.expr_id in build.max_counts]
            if bounds:
                k = min(bounds)
                # cap: residual evaluation unrolls K iterations in the traced
                # program; past the cap start smaller and let overflow-retry
                # escalate (learned thereafter)
                return max(1, min(k, 256))
        return 8

    def _est_compact(self, chunk: Chunk, est, disabled: bool,
                     flag_key: str) -> Chunk:
        """Compact a join input to ~join_compact_factor x its cost-model
        estimate. Sound via the retry protocol: if the live count exceeds the
        target, rows would be dropped — the flag forces a re-run with
        compaction disabled for this node (and the learned-override cache
        remembers). Skipped under a mesh (rows are sharded) and when the
        estimate buys no real reduction."""
        if disabled or est is None or self.mesh is not None or \
                not self.config.join_compaction:
            return chunk
        if chunk.capacity <= 4096:
            return chunk
        target = max(K.next_pow2(
            int(self.config.join_compact_factor * est) + 1), 1024)
        if chunk.bound is not None:
            target = min(target, K.next_pow2(chunk.bound))
        if target >= chunk.capacity:
            return chunk
        if target * 2 >= chunk.capacity and chunk.capacity <= (1 << 20):
            # a bare 2x shrink only pays for itself (one i8 compaction sort
            # vs halved downstream sorts/gathers) at multi-million-row
            # capacities; below that the sort dominates
            return chunk
        live = jnp.sum(chunk.alive.astype(jnp.int32))
        self.flags[flag_key] = live > target
        return self._compact_chunk(chunk, target)

    def _compact_chunk(self, chunk: Chunk, target: int) -> Chunk:
        """Gather live rows into a smaller static capacity (sound only when
        `target` >= the chunk's static live-row bound), by one payload-carrying
        sort (see K.compact_order)."""
        quantum = 8
        if self.mesh is not None:
            quantum = max(quantum, int(self.mesh.devices.size))
        target = max(K.round_up(target, quantum), quantum)
        if target >= chunk.capacity:
            return chunk
        order = K.compact_order(chunk.alive)[:target]
        # late materialization: only the int32 gather maps move; payload
        # columns stay as LazyCols against their original bases
        slots = compose_slots(chunk, order, None)
        return dataclasses.replace(chunk, slots=slots,
                                   alive=chunk.alive[order],
                                   capacity=target, bound=target)

    def _squeeze(self, chunk: Chunk) -> Chunk:
        """Compact when the static bound is much smaller than capacity."""
        if chunk.bound is not None and chunk.bound * 2 <= chunk.capacity:
            return self._compact_chunk(chunk, chunk.bound)
        return chunk

    def _nested_loops_join(self, node: L.Join) -> Chunk:
        """Block nested-loops theta join (NestedLoopsJoinOperator.hpp:65
        analog): cross product then the ON predicate. Used when the ON clause
        has no equi-key conjunct (pure theta / OR-of-equalities); supports
        inner, left, semi, and anti kinds."""
        left = self._squeeze(self.exec(node.left))
        right = self._squeeze(self.exec(node.right))
        if node.residual is not None:
            self._bind_subqueries(node.residual)
        cross = self._cross_pair(node, left, right)
        passed = cross.alive
        if node.residual is not None:
            passed = passed & self._eval_pred(cross, node.residual)
        if node.kind == "inner":
            return dataclasses.replace(cross, alive=passed)
        matched = passed.reshape(left.capacity, right.capacity).any(axis=1)
        if node.kind == "semi":
            return dataclasses.replace(left, alive=left.alive & matched)
        if node.kind == "anti":
            return dataclasses.replace(left, alive=left.alive & ~matched)
        # left outer: matched pairs + one null-extended row per unmatched
        first_slot = (jnp.arange(cross.capacity) % right.capacity) == 0
        unmatched = jnp.repeat(left.alive & ~matched, right.capacity) & \
            first_slot
        alive = passed | unmatched
        slots = dict(cross.slots)
        for a in right.attrs:
            d, v = slots[a.expr_id]
            nv = (~unmatched) if v is None else (v & ~unmatched)
            slots[a.expr_id] = (d, nv)
        return dataclasses.replace(cross, alive=alive, slots=slots)

    def _cross_join(self, node: L.Join) -> Chunk:
        left = self._squeeze(self.exec(node.left))
        right = self._squeeze(self.exec(node.right))
        return self._cross_pair(node, left, right)

    def _cross_pair(self, node: L.Join, left: Chunk, right: Chunk) -> Chunk:
        left.materialize_all()
        right.materialize_all()
        cap = left.capacity * right.capacity
        if cap > (1 << 26):
            raise ExecutionError(
                f"cross join too large ({left.capacity} x {right.capacity})")
        lidx = jnp.repeat(jnp.arange(left.capacity), right.capacity)
        ridx = jnp.tile(jnp.arange(right.capacity), left.capacity)
        slots = {}
        for a in left.attrs:
            d, v = left.slots[a.expr_id]
            d = jnp.asarray(d)
            if d.ndim == 0:
                d = jnp.broadcast_to(d, (left.capacity,))
            slots[a.expr_id] = (d[lidx], None if v is None else v[lidx])
        for a in right.attrs:
            d, v = right.slots[a.expr_id]
            d = jnp.asarray(d)
            if d.ndim == 0:
                d = jnp.broadcast_to(d, (right.capacity,))
            slots[a.expr_id] = (d[ridx], None if v is None else v[ridx])
        alive = left.alive[lidx] & right.alive[ridx]
        lb = left.bound if left.bound is not None else left.capacity
        rb = right.bound if right.bound is not None else right.capacity
        return Chunk(attrs=list(node.output), slots=slots, alive=alive,
                     capacity=cap, bound=min(lb * rb, cap),
                     ranges={**left.ranges, **right.ranges})

    # ----------------------------------------------------------------
    # sort / limit / distinct / set ops
    # ----------------------------------------------------------------
    def _exec_Sort(self, node: L.Sort) -> Chunk:
        chunk = self.exec(node.input)
        keys, valids = [], []
        for e in node.keys:
            d, v = self._eval(chunk, e)
            d, v = chunk.broadcast(d, v)
            keys.append(d)
            valids.append(v)
        key_ranges = [infer_range(e, chunk.ranges) for e in node.keys]
        descending = [not a for a in node.ascending]
        packed = self._pack_sort_key(keys, valids, key_ranges,
                                     descending=descending,
                                     nulls_first=node.nulls_first)
        if packed is not None:
            # dead rows to the end: aliveness as most-significant bit
            big = jnp.asarray(
                1 << 62 if packed.dtype == jnp.int64 else 1 << 30,
                packed.dtype)
            order = jnp.argsort(jnp.where(chunk.alive, packed, big))
        else:
            order = S.order_permutation(keys, valids, node.ascending,
                                        node.nulls_first, chunk.alive)
        slots = compose_slots(chunk, order, None)
        alive = chunk.alive[order]
        out = Chunk(attrs=list(chunk.attrs), slots=slots, alive=alive,
                    capacity=chunk.capacity, ranges=dict(chunk.ranges),
                    unique_sets=list(chunk.unique_sets))
        if node.limit is not None:
            idx = jnp.arange(out.capacity)
            out.alive = out.alive & (idx < node.limit)
        return out

    def _exec_Limit(self, node: L.Limit) -> Chunk:
        chunk = self.exec(node.input)
        pos = jnp.cumsum(chunk.alive.astype(jnp.int32))
        return dataclasses.replace(chunk,
                                   alive=chunk.alive & (pos <= node.limit))

    def _exec_Distinct(self, node: L.Distinct) -> Chunk:
        chunk = self.exec(node.input)
        chunk.ensure([a.expr_id for a in chunk.attrs])
        key_data, key_valid = [], []
        for a in chunk.attrs:
            d, v = chunk.slots[a.expr_id]
            d, v = chunk.broadcast(d, v)
            key_data.append(d)
            key_valid.append(v)
        key_ranges = [chunk.ranges.get(a.expr_id) for a in chunk.attrs]
        packed = self._pack_sort_key(key_data, key_valid, key_ranges)
        out_keys, out_valids, occupied, _n_groups, _ = G.sort_groupby(
            key_data, key_valid, [], chunk.alive, packed_key=packed)
        slots = {}
        for a, kd, kv in zip(chunk.attrs, out_keys, out_valids):
            slots[a.expr_id] = (kd.astype(a.type.device_dtype), kv)
        return Chunk(attrs=list(chunk.attrs), slots=slots,
                     alive=occupied,
                     capacity=chunk.capacity, ranges=dict(chunk.ranges),
                     unique_sets=[frozenset(a.expr_id for a in chunk.attrs)])

    def _exec_SetOperation(self, node: L.SetOperation) -> Chunk:
        chunks = [self.exec(c).materialize_all() for c in node.inputs]
        if node.kind in ("union", "union_all"):
            cap = sum(c.capacity for c in chunks)
            slots = {}
            for i, a in enumerate(node.attrs):
                parts_d, parts_v = [], []
                any_valid = False
                for c in chunks:
                    ca = c.attrs[i]
                    d, v = c.slots[ca.expr_id]
                    d = jnp.asarray(d)
                    if d.ndim == 0:
                        d = jnp.broadcast_to(d, (c.capacity,))
                    d, v = self._remap_for_union(a, ca, d, v)
                    parts_d.append(d.astype(a.type.device_dtype))
                    parts_v.append(v)
                    any_valid = any_valid or v is not None
                data = jnp.concatenate(parts_d)
                if any_valid:
                    valid = jnp.concatenate([
                        v if v is not None else jnp.ones((c.capacity,), bool)
                        for v, c in zip(parts_v, chunks)])
                else:
                    valid = None
                slots[a.expr_id] = (data, valid)
            alive = jnp.concatenate([c.alive for c in chunks])
            return Chunk(attrs=list(node.attrs), slots=slots, alive=alive,
                         capacity=cap, ranges={})
        if node.kind in ("intersect", "except"):
            # left semi/anti-join right on all columns, then dedup. Set-op
            # semantics treat NULLs as equal, so validity joins the key.
            left, right = chunks

            nullable_cols = [
                left.slots[la.expr_id][1] is not None or
                right.slots[ra.expr_id][1] is not None
                for la, ra in zip(left.attrs, right.attrs)]

            def keys_of(c):
                ks = []
                for a, oa, nullable in zip(c.attrs, node.attrs, nullable_cols):
                    d, v = c.broadcast(*c.slots[a.expr_id])
                    # dictionary codes from different inputs must be compared
                    # in the merged output dictionary
                    d, v = self._remap_for_union(oa, a, d, v)
                    if nullable:
                        if v is None:
                            v = jnp.ones((c.capacity,), bool)
                        d = jnp.where(v, d, jnp.zeros((), d.dtype))
                        ks.append(v.astype(jnp.int32))
                    ks.append(d)
                return ks

            lk, rk = keys_of(left), keys_of(right)
            tsize = K.next_pow2(2 * right.capacity)
            table, _ = J.oa_build(rk, right.alive, tsize)
            _, matched = J.oa_probe(table, rk, lk, left.alive)
            if node.kind == "except":
                matched = ~matched
            semi = dataclasses.replace(left, alive=left.alive & matched)
            # rename to output ids then dedup
            slots = {}
            for a, la in zip(node.attrs, left.attrs):
                slots[a.expr_id] = semi.slots[la.expr_id]
            renamed = Chunk(attrs=list(node.attrs), slots=slots,
                            alive=semi.alive, capacity=semi.capacity)
            return self._exec_Distinct(L.Distinct(input=_Const(renamed)))
        raise ExecutionError(f"unknown set op {node.kind}")

    def _remap_for_union(self, out_attr: OutAttr, in_attr: OutAttr, d, v):
        if out_attr.dictionary is not None and in_attr.dictionary is not None \
                and out_attr.dictionary is not in_attr.dictionary:
            from quickstep_tpu.storage.dictionary import Dictionary
            merged, ra, rb = Dictionary.merge(out_attr.dictionary,
                                              in_attr.dictionary)
            # note: executor-level merge requires out_attr.dictionary to already
            # be the union dictionary; the planner ensures this (set_op planning)
            rm = jnp.asarray(rb)
            d = rm[jnp.clip(d, 0, rm.shape[0] - 1)]
        return d, v

    def _exec_RowNumber(self, node: L.RowNumber) -> Chunk:
        """Synthetic unique row id per (padded) row position: the outer-row
        identity of general decorrelation. Dead rows get ids too (harmless —
        they stay dead)."""
        chunk = self.exec(node.input)
        a = node.out_attr
        slots = dict(chunk.slots)
        slots[a.expr_id] = (jnp.arange(chunk.capacity, dtype=jnp.int64), None)
        rid_set = frozenset([a.expr_id])
        return Chunk(
            attrs=list(node.output), slots=slots, alive=chunk.alive,
            capacity=chunk.capacity, bound=chunk.bound,
            ranges={**chunk.ranges, a.expr_id: (0, chunk.capacity - 1)},
            unique_sets=list(chunk.unique_sets) + [rid_set],
            fds=list(chunk.fds) + [
                (rid_set, frozenset(x.expr_id for x in chunk.attrs))],
            max_counts={**chunk.max_counts, a.expr_id: 1})

    def _exec_WindowAggregate(self, node: L.WindowAggregate) -> Chunk:
        from quickstep_tpu.ops.window import window_aggregate
        chunk = self.exec(node.input)
        part = []
        for e in node.partition_by:
            d, _ = chunk.broadcast(*self._eval(chunk, e))
            part.append(d)
        okeys = []
        for e in node.order_by:
            d, _ = chunk.broadcast(*self._eval(chunk, e))
            okeys.append(d)
        desc = [not a for a in node.order_ascending]
        spec = node.spec
        vals, valid = (None, None)
        if spec.arg is not None:
            self._bind_subqueries(spec.arg)
            vals, valid = chunk.broadcast(*self._eval(chunk, spec.arg))
            if spec.fn in ("sum", "avg") and (spec.arg.type.is_integral or
                                  spec.arg.type.is_decimal):
                vals = vals.astype(jnp.int64)
        res, rvalid = window_aggregate(part, okeys, desc, spec.fn, vals, valid,
                                       chunk.alive, node.frame)
        slots = dict(chunk.slots)
        slots[node.out_attr.expr_id] = (
            res.astype(node.out_attr.type.device_dtype), rvalid)
        return Chunk(attrs=list(node.output), slots=slots, alive=chunk.alive,
                     capacity=chunk.capacity, ranges=dict(chunk.ranges),
                     unique_sets=list(chunk.unique_sets), fds=list(chunk.fds))


def _concat_join_chunks(chs: List[Chunk]) -> Chunk:
    """Row-concatenate per-chunk join outputs of the overlapped shuffle (all
    chunks share attrs and static shapes)."""
    base = chs[0]
    slots = {}
    for a in base.attrs:
        any_v = any(c.slots[a.expr_id][1] is not None for c in chs)
        ds, vs = [], []
        for c in chs:
            d, v = c.slots[a.expr_id]
            d = jnp.asarray(d)
            if d.ndim == 0:
                d = jnp.broadcast_to(d, (c.capacity,))
            ds.append(d)
            if any_v:
                vs.append(v if v is not None
                          else jnp.ones((c.capacity,), bool))
        slots[a.expr_id] = (jnp.concatenate(ds),
                            jnp.concatenate(vs) if any_v else None)
    return Chunk(attrs=list(base.attrs), slots=slots,
                 alive=jnp.concatenate([c.alive for c in chs]),
                 capacity=sum(c.capacity for c in chs),
                 ranges=dict(base.ranges))


def _node_expr_list(node: L.LogicalNode):
    from quickstep_tpu.exec.executor import _node_exprs
    return _node_exprs(node)


class _Const(L.LogicalNode):
    """Wraps an already-computed chunk as a plan node (executor-internal)."""

    def __init__(self, chunk: Chunk):
        self.chunk = chunk

    @property
    def output(self):
        return self.chunk.attrs


def _exec_const(runner: PlanRunner, node: _Const) -> Chunk:
    return node.chunk


setattr(PlanRunner, "_exec__Const", _exec_const)
