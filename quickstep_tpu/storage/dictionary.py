"""Ordered string dictionaries.

The device-side successor of the reference's ordered CompressionDictionary
(compression/CompressionDictionary.hpp:64): every CHAR/VARCHAR column is stored on device
as int32 codes into a sorted dictionary, so code order == string order and all device-side
comparisons (=, <, BETWEEN, ORDER BY, GROUP BY) operate directly on codes. Predicates
against string literals are translated host-side into code-range / code-set tests; LIKE and
REGEXP are evaluated once over the (small, host-resident) dictionary and become a
membership bitmap on device — the analog of the reference evaluating comparisons "directly
on compressed codes".
"""

from __future__ import annotations

import bisect
import re
from typing import List, Optional, Sequence, Tuple

import numpy as np


class Dictionary:
    """An immutable sorted string dictionary. code i <-> self.values[i]."""

    __slots__ = ("values", "_index_cache", "_pred_cache")

    def __init__(self, sorted_values: List[str]):
        self.values = sorted_values
        self._index_cache = None
        # (kind, pattern, escape) -> bool[len(dict)]. The dictionary is
        # immutable, so a LIKE/REGEXP bitmap never changes; without this a
        # repeated query re-scans a multi-million-entry comment dictionary
        # with the regex engine at RESOLVE time on every execution (TPC-H
        # Q13's o_comment has 1.5M entries at SF1).
        self._pred_cache = None

    @property
    def _index(self):
        # built lazily: multi-million-entry dictionaries (TPC-H comments) are
        # only indexed when a query actually probes them by value
        if self._index_cache is None:
            self._index_cache = {v: i for i, v in enumerate(self.values)}
        return self._index_cache

    # ---- construction ----
    @staticmethod
    def build(strings: Sequence[str]) -> Tuple["Dictionary", np.ndarray]:
        """Build a dictionary from raw strings; returns (dict, int32 codes).
        A numpy unicode array is sorted as it is, which is several times
        faster than sorting Python str objects and gives the same order."""
        if not (isinstance(strings, np.ndarray) and strings.dtype.kind == "U"):
            strings = np.asarray(strings, dtype=object)
        uniq, codes = np.unique(strings, return_inverse=True)
        return Dictionary([str(u) for u in uniq]), codes.astype(np.int32)

    def __len__(self) -> int:
        return len(self.values)

    # ---- host-side code translation ----
    def code_of(self, s: str) -> int:
        """Exact code of s, or -1 if absent."""
        return self._index.get(s, -1)

    def lower_bound(self, s: str) -> int:
        """Number of dictionary entries < s. For translating range predicates:
        col < s  <=>  code < lower_bound(s);  col >= s  <=>  code >= lower_bound(s)."""
        return bisect.bisect_left(self.values, s)

    def upper_bound(self, s: str) -> int:
        """Number of entries <= s. col <= s <=> code < upper_bound(s)."""
        return bisect.bisect_right(self.values, s)

    def decode(self, codes: np.ndarray) -> List[str]:
        vals = self.values
        return [vals[int(c)] if 0 <= int(c) < len(vals) else None for c in codes]

    def decode_array(self) -> np.ndarray:
        return np.asarray(self.values, dtype=object)

    # ---- predicate bitmaps (evaluated on the dictionary, applied on device) ----
    def _pred_memo(self, key, compute) -> np.ndarray:
        if self._pred_cache is None:
            self._pred_cache = {}
        hit = self._pred_cache.get(key)
        if hit is None:
            hit = self._pred_cache[key] = compute()
        return hit

    def match_like(self, pattern: str, escape: Optional[str] = None) -> np.ndarray:
        """bool[len(dict)]: which codes match a SQL LIKE pattern (evaluated
        once per dictionary entry, not per row — the bandwidth win over the
        reference's per-row re2 matching). Memoized per pattern; the common
        %-only shape ('%word1%word2%') runs a str.find chain instead of the
        regex engine (~4x on multi-million-entry comment dictionaries)."""
        def compute():
            if escape is None and "_" not in pattern:
                if "%" not in pattern:   # literal equality (bisect: avoids
                    # building the lazy value->code dict for huge dicts)
                    out = np.zeros(len(self.values), dtype=bool)
                    i = bisect.bisect_left(self.values, pattern)
                    if i < len(self.values) and self.values[i] == pattern:
                        out[i] = True
                    return out
                # %-only pattern: prefix/suffix strip + str.find chain
                segs = [s for s in pattern.split("%") if s]
                pre = segs.pop(0) if segs and not pattern.startswith("%") \
                    else None
                suf = segs.pop() if segs and not pattern.endswith("%") \
                    else None

                def hits(v: str) -> bool:
                    if pre is not None:
                        if not v.startswith(pre):
                            return False
                        v = v[len(pre):]
                    if suf is not None:
                        if not v.endswith(suf):
                            return False
                        v = v[:len(v) - len(suf)]
                    pos = 0
                    for seg in segs:
                        j = v.find(seg, pos)
                        if j < 0:
                            return False
                        pos = j + len(seg)
                    return True
                return np.fromiter((hits(v) for v in self.values),
                                   dtype=bool, count=len(self.values))
            rx = _like_to_regex(pattern, escape)
            return np.fromiter(
                (rx.fullmatch(v) is not None for v in self.values),
                dtype=bool, count=len(self.values))
        return self._pred_memo(("like", pattern, escape), compute)

    def match_regex(self, pattern: str) -> np.ndarray:
        def compute():
            rx = re.compile(pattern)
            return np.asarray([rx.fullmatch(v) is not None
                               for v in self.values], dtype=bool)
        return self._pred_memo(("regex", pattern), compute)

    def match_in(self, literals: Sequence[str]) -> np.ndarray:
        out = np.zeros(len(self.values), dtype=bool)
        for s in literals:
            c = self.code_of(s)
            if c >= 0:
                out[c] = True
        return out

    # ---- merging (for cross-column string comparisons / joins / unions) ----
    @staticmethod
    def merge(a: "Dictionary", b: "Dictionary") -> Tuple["Dictionary", np.ndarray, np.ndarray]:
        """Merged sorted dictionary plus code-remap arrays for each input.

        remap_a[old_code_in_a] -> new code, likewise remap_b.
        """
        merged = sorted(set(a.values) | set(b.values))
        d = Dictionary(merged)
        remap_a = np.asarray([d._index[v] for v in a.values], dtype=np.int32)
        remap_b = np.asarray([d._index[v] for v in b.values], dtype=np.int32)
        return d, remap_a, remap_b

    def map_values(self, fn) -> Tuple["Dictionary", np.ndarray]:
        """Apply a host string function (substring, upper, ...) to every dictionary entry,
        producing a new sorted dictionary + remap array (old code -> new code)."""
        transformed = [fn(v) for v in self.values]
        uniq = sorted(set(transformed))
        d = Dictionary(uniq)
        remap = np.asarray([d._index[t] for t in transformed], dtype=np.int32)
        return d, remap


def _like_to_regex(pattern: str, escape: Optional[str] = None) -> "re.Pattern":
    """Translate SQL LIKE (% _ wildcards, optional ESCAPE char) into a compiled regex."""
    out = []
    i = 0
    while i < len(pattern):
        ch = pattern[i]
        if escape and ch == escape and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
        i += 1
    return re.compile("".join(out), re.DOTALL)
