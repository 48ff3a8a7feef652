"""Sort kernels (ORDER BY / DISTINCT / set ops).

Device-side successor of the reference's two-phase external sort
(relational_operators/SortRunGenerationOperator.hpp:76 per-block runs +
SortMergeRunOperator.hpp:72 k-way merge): on the device a single vectorized lexsort over
whole columns replaces run generation + merge — XLA lowers jnp.lexsort/argsort to its
parallel sorter. Descending order and NULLS FIRST/LAST are handled by key transforms
so one ascending sorter serves everything. LIMIT uses the same sort then a static
slice (top-k style trimming happens host-side on materialization).
"""

from __future__ import annotations

from typing import List, Optional

import jax.numpy as jnp

from quickstep_tpu.ops.kernels import max_sentinel, min_sentinel


def order_permutation(keys: List[jnp.ndarray],
                      valids: List[Optional[jnp.ndarray]],
                      ascending: List[bool],
                      nulls_first: List[Optional[bool]],
                      alive: jnp.ndarray) -> jnp.ndarray:
    """Stable permutation sorting live rows by the given keys; dead rows sink to
    the end. keys[0] is the primary key (SQL ORDER BY order)."""
    sort_cols = []
    for k, valid, asc, nf in zip(keys, valids, ascending, nulls_first):
        col = k
        if not asc:
            if jnp.issubdtype(col.dtype, jnp.floating):
                col = -col
            elif col.dtype == jnp.bool_:
                col = ~col
            else:
                # bitwise-not is a monotone decreasing map on signed ints with no
                # overflow at INT_MIN (unlike negation)
                col = jnp.invert(col)
        if valid is not None:
            # SQL default: NULLS LAST for ASC, NULLS FIRST for DESC
            first = nf if nf is not None else (not asc)
            sentinel = min_sentinel(col.dtype) if first else max_sentinel(col.dtype)
            col = jnp.where(valid, col, sentinel)
        sort_cols.append(col)
    # lexsort: LAST key is primary; dead rows last via aliveness as primary-most key
    lex = tuple(reversed(sort_cols)) + ((~alive).astype(jnp.int8),)
    return jnp.lexsort(lex)
