"""Engine configuration flags.

One typed config object mirroring the reference's ~40 gflags spread across modules
(cli/Flags.cpp, query_optimizer/PhysicalGenerator.cpp:139-179, storage/Flags.cpp,
query_execution scheduler knobs) plus this engine's device-specific knobs.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Config:
    # --- CLI (reference cli/Flags.cpp) ---
    storage_path: str = "qstpu_storage"
    initialize_db: bool = False
    printing_enabled: bool = True
    display_timing: bool = True
    # --- optimizer rule toggles (reference PhysicalGenerator.cpp:139-179) ---
    use_filter_joins: bool = True          # InjectJoinFilters: HashJoin -> FilterJoin (LIP)
    use_lip_filters: bool = True           # AttachLIPFilters
    reorder_columns: bool = True
    reorder_hash_joins: bool = True        # StarSchemaHashJoinOrderOptimization
    use_partition_rule: bool = True
    visualize_plan: bool = False
    visualize_execution_dag: bool = False
    # --- execution (reference ExecutionGenerator + scheduler flags) ---
    aggregate_hashtable_type: str = "auto"   # auto | collision_free | sort  (device paths)
    join_hashtable_type: str = "auto"        # auto | direct | linear_open_addressing | sort_merge
    max_sample_dop: int = 16
    profile_and_report_workorder_perf: bool = False   # per-operator timing report
    max_concurrent_queries: int = 8     # PolicyEnforcer admission limit
    profile_device_reps: int = 0        # >1: measure pipelined device-only ms
    # --- distributed execution (GSPMD over the device mesh) ---
    distributed: bool = False           # shard base tables over jax.devices()
    replicate_threshold_rows: int = 65536   # tables smaller than this replicate
    # Shuffle-join exchange/compute overlap: the probe side splits into this
    # many independent slices, each with its own all_to_all + local join, so
    # XLA's latency-hiding scheduler overlaps chunk i+1's collective with
    # chunk i's join compute (the InsertDestination pipelining analog). 1 =
    # single synchronous exchange.
    shuffle_overlap_chunks: int = 2
    # --- device knobs ---
    row_capacity_bucket: int = 1024     # pad row counts to multiples of this (min bucket)
    geometric_buckets: bool = True      # bucket capacities at powers of two above the min
    collision_free_domain_limit: int = 1 << 22  # max dense group-by domain (CollisionFreeVectorTable analog)
    # direct-address join table: dense int32 array indexed by (key - lo). One
    # scatter to build, one gather to probe — the data-parallel answer to the
    # reference's SimpleScalarSeparateChainingHashTable. Allowed when the key
    # domain is bounded AND not too sparse relative to the build side (stats).
    direct_join_domain_limit: int = 1 << 27   # <=536MB int32 table (SF10 orderkey=60M)
    direct_join_density: float = 16.0         # domain <= density * build rows
    join_output_factor: float = 1.5     # capacity estimate multiplier for many-many joins
    # Pre-join dynamic compaction: each join side compacts to
    # join_compact_factor x its cost-model estimate so join gathers run at
    # the filtered size, not the padded capacity. Under-estimates trip an
    # overflow flag and re-run uncompacted (kOutOfSpace retry analog).
    join_compaction: bool = True
    # 4x cushion: a 2x cushion was tried round-5 and tripped overflow
    # retries on Q21/Q18-class self-join estimates, costing more than the
    # halved capacities saved; 4x with the relaxed 2x-shrink rule below
    # still compacts the borderline cases (Q5's 8.4M->4M).
    join_compact_factor: float = 4.0
    # Presentation ORDER BY: results with at least this many rows sort on
    # device (payload-carrying lax.sort + top-limit slice; only presented rows
    # cross the host link). Smaller results use the host lexsort, which avoids
    # an XLA sort compile per ad-hoc query shape.
    device_sort_threshold_rows: int = 1 << 20
    default_mesh_axis: str = "x"
    preload_buffer_pool: bool = False   # device-warm base tables at startup
    hbm_budget_bytes: int = 0           # 0 = unlimited; else evict device tables
    # With a budget set and a plan whose over-budget table has no streamable
    # shape: True = raise a documented error; False = attempt resident
    # execution anyway (may OOM the device)
    strict_hbm_budget: bool = False
    eviction_policy: str = "lru-k"      # lru-k | lru | uniform-random | evict-any
    eviction_lru_k: int = 2             # K for lru-k (LRUKEvictionPolicyFactory analog)
    bloom_filter_bits_per_key: int = 8  # LIP filter sizing
    # --- correctness / testing ---
    float_print_decimals: int = 2
    # Force the non-injective (colliding) key packing in expansion joins so
    # tests can prove the probe-side verify-gather rejects hash collisions
    # (the reference verifies key equality on every probe, storage/HashTable.hpp)
    test_weak_hash_join: bool = False


# Process-wide default config (tests construct their own and pass it down).
DEFAULT = Config()
