"""chip_smoke.py off the card: its device check refuses a CPU, and its
phases, run as functions at a small scale on the CPU, check the engine
against the indexed sqlite oracle and the plain references."""

import os
import shutil
import subprocess
import sys
import types

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def test_device_check_refuses_cpu():
    with pytest.raises(chip_smoke.SmokeFailure, match="no GPU"):
        chip_smoke.require_gpu(jax.devices())
    gpu = types.SimpleNamespace(platform="gpu")
    chip_smoke.require_gpu([gpu])
    with pytest.raises(chip_smoke.SmokeFailure, match="4 GPUs"):
        chip_smoke.require_gpu([gpu], count=4)


def test_main_on_cpu_exits_nonzero_without_result(capsys):
    assert chip_smoke.main([]) != 0
    assert '"ok"' not in capsys.readouterr().out


def test_script_alone_fails(tmp_path):
    """Without the rest of the repository the script cannot pass."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.fixture(scope="module")
def smoke_tpch(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("smoke"))
    db, tables, records = chip_smoke.tpch_phase(
        0.01, list(range(1, 23)), workdir=work, warm_runs=1)
    return db, tables, records, work


def test_tpch_phase_against_indexed_oracle(smoke_tpch):
    _db, _tables, records, _work = smoke_tpch
    assert sorted(records) == list(range(1, 23))
    for q, r in records.items():
        assert r["status"] == "ok", (q, r["status"])
        assert r["cold_ms"] > 0 and r["warm_ms"] > 0
        assert r["attempts"] >= 1
        assert r["sort"] in ("host", "device", "none")


def test_load_and_serve_phase(smoke_tpch):
    db, tables, _records, work = smoke_tpch
    chip_smoke.load_and_serve_phase(db, tables, workdir=work)


def test_dup_join_phase_small():
    chip_smoke.dup_join_phase(width=1 << 14)


@pytest.mark.gpu
def test_dup_join_phase_on_gpu(gpu_device):
    chip_smoke.dup_join_phase()


def test_oracle_expected_rows_in_process(tmp_path):
    from quickstep_tpu.bench import oracle
    from quickstep_tpu.bench.tpchgen import generate
    path = str(tmp_path / "o.sqlite")
    rows, times = oracle.expected_rows(generate(0.01, 0), [1, 6], path)
    assert sorted(rows) == [1, 6]
    assert len(rows[1]) == 4 and len(rows[6]) == 1
    assert times["load_s"] > 0 and times["query_s"] > 0
    assert not os.path.exists(path)


def test_oracle_loads_only_the_columns_queries_read(tmp_path):
    from quickstep_tpu.bench import oracle
    from quickstep_tpu.bench.tpchgen import generate
    used = oracle.columns_used([oracle.oracle_sql(6)])
    assert used["lineitem"] == ["l_quantity", "l_extendedprice",
                                "l_discount", "l_shipdate"]
    assert used["orders"] == []
    conn = oracle.build_sqlite(generate(0.01, 0), str(tmp_path / "o.sqlite"),
                               used)
    names = {r[0] for r in conn.execute(
        "SELECT name FROM sqlite_master WHERE type = 'table'")}
    assert "lineitem" in names and "orders" not in names
    cols = [r[1] for r in conn.execute("PRAGMA table_info(lineitem)")]
    assert cols == used["lineitem"]
    # the lineitem indexes are on key columns Q6 does not read
    assert not list(conn.execute(
        "SELECT name FROM sqlite_master WHERE type = 'index'"))
    conn.close()


def test_oracle_indexes_only_loaded_columns(tmp_path):
    from quickstep_tpu.bench import oracle
    from quickstep_tpu.bench.tpchgen import generate
    used = oracle.columns_used([oracle.oracle_sql(3)])
    conn = oracle.build_sqlite(generate(0.01, 0), str(tmp_path / "o.sqlite"),
                               used)
    assert len(conn.execute(oracle.oracle_sql(3)).fetchall()) == 10
    indexes = {r[0] for r in conn.execute(
        "SELECT name FROM sqlite_master WHERE type = 'index'")}
    assert indexes == {"il_ok", "io_ok", "io_ck", "ic_ck"}
    conn.close()
