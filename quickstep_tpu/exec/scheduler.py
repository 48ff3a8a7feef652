"""Multi-query admission + scheduling policy + execution statistics.

Device-side successor of the reference's query_execution/ policy layer:

- `PolicyEnforcer` — admission control and fair dispatch across sessions
  (PolicyEnforcerBase/SingleNode, query_execution/PolicyEnforcerBase.hpp:51,
  PolicyEnforcerSingleNode.cpp:42-56: concurrent admission, fair per-query
  round-robin). On the device the unit of dispatch is a whole compiled query program
  rather than a WorkOrder, and the single device serializes execution — so
  fairness means: admit up to `max_concurrent_queries`, order admitted work by
  (priority DESC, least-recently-served session, arrival).
- `ExecutionStats` — sliding-window per-operator timing
  (query_execution/ExecutionStats.hpp:46-54: max_entries window, per-operator
  averages feeding future scheduling decisions).
- `ProbabilityStore` — a probability distribution over object ids
  (query_execution/ProbabilityStore.hpp:40), groundwork for probabilistic
  scheduling policies; standalone in the reference as well.

The REPL and embedded API execute directly; the network server
(cli/network.py) routes through a PolicyEnforcer so concurrent clients get
reference-equivalent admission semantics.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional


# =====================================================================
# ExecutionStats — sliding window of per-operator timings
# =====================================================================

class ExecutionStats:
    """Sliding window (max_entries per operator) of execution times in ms.

    Mirrors query_execution/ExecutionStats.hpp: addEntry evicts the oldest
    record past the window; getCurrentStats yields (total_ms, count) per
    operator for average-cost estimates."""

    def __init__(self, max_entries: int = 1000):
        self.max_entries = max_entries
        self._windows: Dict[str, Deque[float]] = {}
        self._lock = threading.Lock()

    def add_entry(self, op: str, ms: float) -> None:
        with self._lock:
            w = self._windows.get(op)
            if w is None:
                w = self._windows[op] = collections.deque(
                    maxlen=self.max_entries)
            w.append(ms)

    def stats(self, op: str):
        with self._lock:
            w = self._windows.get(op)
            if not w:
                return (0.0, 0)
            return (sum(w), len(w))

    def average(self, op: str) -> Optional[float]:
        total, n = self.stats(op)
        return (total / n) if n else None

    def operators(self) -> List[str]:
        with self._lock:
            return list(self._windows)


# =====================================================================
# ProbabilityStore
# =====================================================================

class ProbabilityStore:
    """Normalized probability distribution over object ids
    (query_execution/ProbabilityStore.hpp:40): numerators over a common
    denominator; add/update/remove re-normalize; pickRandom samples by
    cumulative probability."""

    def __init__(self):
        self._numerators: Dict[int, float] = {}
        self.denominator = 0.0

    def add_or_update(self, obj: int, numerator: float) -> None:
        assert numerator >= 0
        old = self._numerators.get(obj, 0.0)
        self._numerators[obj] = numerator
        self.denominator += numerator - old
        if not self._numerators or self.denominator <= 0:
            self.denominator = sum(self._numerators.values())

    def remove(self, obj: int) -> None:
        num = self._numerators.pop(obj, 0.0)
        self.denominator -= num

    def probability(self, obj: int) -> float:
        if self.denominator <= 0 or obj not in self._numerators:
            return 0.0
        return self._numerators[obj] / self.denominator

    def pick_random(self, rand01: float) -> int:
        """Sample an object id given a uniform [0,1) draw."""
        if not self._numerators:
            raise KeyError("empty ProbabilityStore")
        acc = 0.0
        items = list(self._numerators.items())
        for obj, num in items:
            acc += num / self.denominator
            if rand01 < acc:
                return obj
        return items[-1][0]

    def __len__(self):
        return len(self._numerators)


# =====================================================================
# PolicyEnforcer — admission + fair dispatch
# =====================================================================

@dataclass(eq=False)   # identity equality: list.remove must remove THIS entry
class _Pending:
    seq: int
    sql: str
    session: str
    priority: int
    done: threading.Event
    result: object = None
    error: Optional[BaseException] = None
    submitted_at: float = 0.0
    started_at: float = 0.0
    finished_at: float = 0.0


class PolicyEnforcer:
    """Admits queries up to `max_concurrent_queries` and dispatches them to
    the (single) device executor thread in (priority DESC,
    least-recently-served session, arrival order) — the single-device analog
    of PolicyEnforcerSingleNode's fair per-query round-robin.

    `submit` blocks callers beyond the admission limit until a slot frees
    (reference behavior: AdmitRequestMessage queues until admitQuery
    succeeds)."""

    def __init__(self, execute_fn: Callable[[str], object],
                 max_concurrent_queries: int = 8,
                 stats: Optional[ExecutionStats] = None,
                 executor=None):
        self._execute = execute_fn
        self.max_concurrent = max_concurrent_queries
        self.stats = stats or ExecutionStats()
        self._seq = itertools.count()
        self._cv = threading.Condition()
        self._admitted: List[_Pending] = []
        self._last_served: Dict[str, int] = {}   # session -> serve tick
        self._tick = 0
        self._shutdown = False
        self._in_yield = False
        if executor is not None:
            # segment-granular multi-query interleave: the streamed executor
            # calls back between segments, and pending queries from other
            # sessions run at those yield points — the WorkOrder-granular
            # fair round-robin analog (PolicyEnforcerSingleNode.cpp:42-56);
            # a long streamed query no longer monopolizes the device.
            executor.segment_yield = self._yield_between_segments
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="qstpu-policy-enforcer")
        self._worker.start()

    # -- client side ---------------------------------------------------
    def submit(self, sql: str, session: str = "default",
               priority: int = 0, timeout: Optional[float] = None):
        """Enqueue a query; blocks until the admission slot frees, then until
        execution completes. Returns the QueryResult or raises the query's
        error."""
        p = _Pending(seq=next(self._seq), sql=sql,
                     session=session, priority=priority,
                     done=threading.Event(), submitted_at=time.perf_counter())
        with self._cv:
            while (len(self._admitted) >= self.max_concurrent
                   and not self._shutdown):
                self._cv.wait(0.05)
            if self._shutdown:
                raise RuntimeError("PolicyEnforcer is shut down")
            self._admitted.append(p)
            self._cv.notify_all()
        if not p.done.wait(timeout):
            raise TimeoutError(f"query did not finish in {timeout}s")
        if p.error is not None:
            raise p.error
        return p.result

    # -- dispatch loop ---------------------------------------------------
    def _pick(self) -> Optional[_Pending]:
        """Fair choice among admitted queries: highest priority first, then
        the session served longest ago, then arrival order."""
        if not self._admitted:
            return None
        best = min(self._admitted, key=lambda p: (
            -p.priority, self._last_served.get(p.session, -1), p.seq))
        return best

    def _run(self):
        while True:
            with self._cv:
                while not self._admitted and not self._shutdown:
                    self._cv.wait(0.05)
                if self._shutdown and not self._admitted:
                    return
                p = self._pick()
                self._admitted.remove(p)
                self._tick += 1
                self._last_served[p.session] = self._tick
                self._cv.notify_all()
            p.started_at = time.perf_counter()
            try:
                p.result = self._execute(p.sql)
            except BaseException as e:  # surfaced to the submitter
                p.error = e
            p.finished_at = time.perf_counter()
            self.stats.add_entry("query", (p.finished_at - p.started_at) * 1e3)
            p.done.set()

    def _yield_between_segments(self):
        """Run ONE pending admitted query at a streamed-plan segment
        boundary (same worker thread — the executor is single-threaded by
        design). Re-entrancy is guarded: a streamed query started from a
        yield point does not itself yield."""
        if self._in_yield:
            return
        with self._cv:
            p = self._pick()
            if p is None:
                return
            self._admitted.remove(p)
            self._tick += 1
            self._last_served[p.session] = self._tick
            self._cv.notify_all()
        self._in_yield = True
        try:
            p.started_at = time.perf_counter()
            try:
                p.result = self._execute(p.sql)
            except BaseException as e:
                p.error = e
            p.finished_at = time.perf_counter()
            self.stats.add_entry("query",
                                 (p.finished_at - p.started_at) * 1e3)
            p.done.set()
        finally:
            self._in_yield = False

    def shutdown(self):
        with self._cv:
            self._shutdown = True
            self._cv.notify_all()
        self._worker.join(timeout=5)
