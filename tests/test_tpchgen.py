"""The TPC-H generator's string columns: the dictionary built from word ranks
and from categorical codes equals the one sorting the strings would give."""

import numpy as np
import pytest

from quickstep_tpu.bench import tpchgen as G
from quickstep_tpu.storage.dictionary import Dictionary
from quickstep_tpu.types import Char, VarChar


@pytest.mark.parametrize("min_w,max_w,inject,p", [
    (2, 5, None, 0.0),
    (5, 12, "special requests", 0.3),
    (4, 10, "Customer Complaints", 0.5),
])
def test_text_col_matches_sorted_strings(min_w, max_w, inject, p):
    n = 5000
    strings = G._text_column(np.random.default_rng(7), n, min_w, max_w,
                             inject, p)
    col = G._text_col(VarChar(200), np.random.default_rng(7), n, min_w,
                      max_w, inject, p)
    want, codes = Dictionary.build(list(strings))
    assert col.dictionary.values == want.values
    assert np.array_equal(col.data, codes)
    if inject:
        assert any(f"of {inject.split()[1]}" in s for s in strings)


def test_join_words_chunks_and_spacing():
    vocab = ["a", "bb", "the", "theodolites"]
    m = np.array([[3, 0, 0], [4, 1, 2], [2, 2, 0]], np.uint8)
    want = ["the", "theodolites a bb", "bb bb"]
    assert G._join_words(vocab, m) == want
    assert G._join_words(vocab, m, chunk=1) == want


def test_col_cat_keeps_only_values_that_occur():
    col = G._col_cat(Char(5), ["z", "a", "m", "q"], np.array([0, 2, 0, 1]))
    assert col.dictionary.values == ["a", "m", "z"]
    assert [col.dictionary.values[c] for c in col.data] == ["z", "m", "z", "a"]
    assert col.data.dtype == np.int32


def test_dictionary_build_unicode_array_matches_list():
    words = np.array(["pear", "apple", "fig", "apple", "Zed"])
    a, ca = Dictionary.build(words)
    b, cb = Dictionary.build(list(words))
    assert a.values == b.values == ["Zed", "apple", "fig", "pear"]
    assert np.array_equal(ca, cb)
    assert all(type(v) is str for v in a.values)
