"""Regression tests for the oracle comparator (quickstep_tpu/bench/oracle.py):
an old comparator rounded floats to 2dp before a repr-based multiset compare,
so a .xx5 scale-4-decimal vs f64 representation boundary (e.g. 2.675 vs
2.6750000000000003) rounded to different 2dp strings and produced a false
MISMATCH."""

from quickstep_tpu.bench import oracle as sfv


def test_xx5_boundary_not_a_mismatch():
    # round(2.675, 2) == 2.67 but round(2.6750000000000003, 2) == 2.68:
    # the old comparator called this a multiset mismatch
    ours = [(1, "a", 2.675), (2, "b", 9.995)]
    oracle = [(2, "b", 9.995000000000001), (1, "a", 2.6750000000000003)]
    assert sfv.compare(ours, oracle, ordered=False) is None


def test_real_difference_still_detected():
    ours = [(1, 2.675)]
    oracle = [(1, 2.676)]   # |diff| = 1e-3 > abs_tol
    assert sfv.compare(ours, oracle, ordered=False) is not None


def test_multiset_permutation_ok():
    ours = [(2, "y"), (1, "x")]
    oracle = [(1, "x"), (2, "y")]
    assert sfv.compare(ours, oracle, ordered=False) is None


def test_ordered_compare_unchanged():
    ours = [(1, 1.0), (2, 2.0)]
    oracle = [(2, 2.0), (1, 1.0)]
    assert sfv.compare(ours, oracle, ordered=True) is not None
    assert sfv.compare(ours, ours, ordered=True) is None
