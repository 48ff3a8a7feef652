"""The native text scanner is compiled from native/csv_scanner.cpp into the
gitignored native/build/ directory, under a name keyed on the source's
content, and COPY FROM uses it."""

import os
import shutil

import pytest

from quickstep_tpu import Database
from quickstep_tpu.storage import native_io

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "native", "csv_scanner.cpp")


def test_built_from_source_keyed_on_content(tmp_path):
    src = tmp_path / "csv_scanner.cpp"
    shutil.copy(SRC, src)
    build = tmp_path / "build"
    so = native_io.build_library(str(src), str(build))
    assert os.path.dirname(so) == str(build) and os.path.exists(so)
    assert so == native_io.library_path(str(src), str(build))
    mtime = os.path.getmtime(so)
    assert native_io.build_library(str(src), str(build)) == so
    assert os.path.getmtime(so) == mtime          # no rebuild
    with open(src, "a") as f:
        f.write("\n// changed\n")
    assert native_io.library_path(str(src), str(build)) != so
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert "native/build/" in f.read().split()
    assert not os.path.exists(os.path.join(REPO, "native", "libqstpu_io.so"))


def test_copy_from_uses_native_scanner(tmp_path, monkeypatch):
    if not native_io.native_available():
        pytest.fail("native scanner did not build")
    calls = []
    real = native_io.parse_csv_native

    def spy(*a, **k):
        res = real(*a, **k)
        calls.append(res is not None)
        return res
    monkeypatch.setattr(native_io, "parse_csv_native", spy)
    path = tmp_path / "t.tbl"
    path.write_text("1|a b|2.50|1995-03-15|\n2|c|-0.25|1998-12-01|\n")
    db = Database()
    db.execute("CREATE TABLE t (k INT NOT NULL, s VARCHAR(10) NOT NULL, "
               "d DECIMAL(9,2) NOT NULL, dt DATE NOT NULL)")
    db.execute(f"COPY t FROM '{path}' WITH (DELIMITER '|')")
    assert calls == [True]
    assert db.execute("SELECT k, s, d, dt FROM t ORDER BY k").rows == [
        (1, "a b", 2.5, "1995-03-15"), (2, "c", -0.25, "1998-12-01")]
