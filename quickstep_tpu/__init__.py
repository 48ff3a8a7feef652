"""quickstep-tpu: a vectorized SQL query-execution engine on JAX/XLA.

A from-scratch JAX/XLA design with the capabilities of UWQuickstep/quickstep
(reference layer map in SURVEY.md §1): SQL text -> parser -> resolver -> optimizer ->
columnar operator DAG -> whole-query XLA compilation over a device mesh.
"""

import os

import jax

# The SQL type system needs 64-bit integers (LONG, fixed-point DECIMAL accumulation) and
# float64 (DOUBLE); hot paths use 32-bit dtypes where types allow.
jax.config.update("jax_enable_x64", True)

# Persistent XLA compilation cache. JAX reads JAX_COMPILATION_CACHE_DIR itself; only
# when it is unset does the engine pick one fixed directory inside the checkout, so
# every process of this checkout finds the programs the others compiled.
CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE_DIR)

__version__ = "0.1.0"

from quickstep_tpu.database import Database  # noqa: E402,F401
