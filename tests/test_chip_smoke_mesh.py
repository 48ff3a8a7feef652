"""chip_smoke.py's four-card phases off the card: the forced shuffle join, and
the 22 TPC-H queries over the suite's virtual CPU mesh against the oracle."""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def test_shuffle_join_phase_on_cpu_mesh(capsys):
    chip_smoke.shuffle_join_phase()
    assert "shuffle_join: 600 rows exact" in capsys.readouterr().out


def test_four_cards_phase_on_cpu_mesh(tmp_path, capsys):
    chip_smoke.four_cards_phase(workdir=str(tmp_path), sf=0.01)
    out = capsys.readouterr().out
    assert "four_cards: 22/22 mesh results equal to the oracle" in out
    # each query is compared as soon as the oracle is there
    assert out.count(": ok\n") == 22
