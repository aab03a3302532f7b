"""The native CSV loader (sqlrs_tpu_torch/storage/native_loader.py) against
the port's Python reader (storage/csv.read_csv_file) and the reference's
(sqlrs_tpu/storage/csv.read_csv_file), on CSVs written here: quoting,
empty cells, dates, booleans and a file without a header.

The library is built from native/csv_loader.cpp into build/native/ at
first use; these tests need g++ and skip only where there is none.
"""

import os
import shutil
import uuid

import numpy as np
import pytest

from sqlrs_tpu.storage import csv as ref_csv
from sqlrs_tpu_torch.data.strings import GLOBAL_STRINGS
from sqlrs_tpu_torch.storage import csv as port_csv
from sqlrs_tpu_torch.storage import native_loader

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++ on PATH")


def _csv_text(tag: str) -> str:
    return (
        "id,name,score,ok,dt,note\n"
        f'1,ann{tag},1.25,true,2021-03-04,"hello, {tag}"\n'
        f'2,"bo ""b""{tag}",,false,2021-03-05,\n'
        "\n"
        f',cy{tag},3.5,,,"multi\nline{tag}"\n'
        f"4,dee{tag},-2,TRUE,2020-02-29,x{tag}\n"
        f"5,ann{tag},1e3,false,1970-01-01,\n"
    )


def _write(tmp_path, text, name="t.csv"):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


def _columns(table):
    """(names, types, [data], [valid]) of a DataTable (either package)."""
    n = table.num_rows
    return (
        list(table.names),
        [t.name for t in table.types],
        [d[:n] for d in table._data],
        [v[:n] for v in table._valid],
    )


def _decoded(table, strings):
    names, types, datas, valids = _columns(table)
    out = []
    for t, d, v in zip(types, datas, valids):
        if t == "VARCHAR":
            out.append([strings.lookup(int(c)) if ok else None for c, ok in zip(d, v)])
        else:
            out.append([x if ok else None for x, ok in zip(d.tolist(), v.tolist())])
    return names, types, out


@needs_gxx
def test_native_builds_into_build_dir():
    assert native_loader.native_available()
    path = native_loader.library_path()
    assert os.path.exists(path)
    assert os.path.dirname(path).endswith(os.path.join("build", "native"))
    assert not path.startswith(os.path.dirname(native_loader.SOURCE) + os.sep)


@needs_gxx
@pytest.mark.parametrize("header", [True, False], ids=["header", "no_header"])
@pytest.mark.parametrize("delim", [",", "|"])
def test_native_matches_python_path(tmp_path, header, delim):
    tag = uuid.uuid4().hex[:8]
    text = _csv_text(tag)
    if not header:
        text = text.split("\n", 1)[1]
    if delim != ",":
        text = text.replace(",", delim).replace(f'"hello{delim} ', '"hello, ')
    path = _write(tmp_path, text)
    cfg = port_csv.CsvConfig(has_header=header, delimiter=delim)
    # fresh strings: the native path interns first, in its own order
    before = len(GLOBAL_STRINGS)
    a = native_loader.read_csv_native(path, cfg)
    after_native = len(GLOBAL_STRINGS)
    b = port_csv.read_csv_file(path, cfg)
    assert len(GLOBAL_STRINGS) == after_native  # nothing new: same strings
    na, ta, da, va = _columns(a)
    nb, tb, db_, vb = _columns(b)
    assert (na, ta) == (nb, tb)
    for x, y, vx, vy, t in zip(da, db_, va, vb, ta):
        assert x.dtype == y.dtype, t
        assert np.array_equal(vx, vy), t
        assert np.array_equal(x[vx], y[vy]), t
    # the new strings were interned in column order, then row order
    codes = [c for t, d in zip(ta, da) if t == "VARCHAR" for c in d.tolist()]
    new = [c for c in codes if c >= before]
    assert sorted(set(new)) == list(range(before, after_native))
    first_seen = list(dict.fromkeys(new))
    assert first_seen == sorted(first_seen)


@needs_gxx
def test_native_matches_reference_reader(tmp_path):
    from sqlrs_tpu.data.strings import GLOBAL_STRINGS as REF_STRINGS

    path = _write(tmp_path, _csv_text(uuid.uuid4().hex[:8]))
    got = _decoded(native_loader.read_csv_native(path), GLOBAL_STRINGS)
    exp = _decoded(ref_csv.read_csv_file(path), REF_STRINGS)
    assert got == exp
    names, types, cols = got
    assert types == ["BIGINT", "VARCHAR", "DOUBLE", "BOOLEAN", "DATE", "VARCHAR"]
    assert cols[3] == [True, False, None, True, False]
    assert cols[2] == [1.25, None, 3.5, -2.0, 1000.0]
    assert cols[5][1] == ""  # an empty VARCHAR cell is the empty string


@needs_gxx
def test_load_csv_prefers_native_and_env_turns_it_off(tmp_path, monkeypatch):
    path = _write(tmp_path, _csv_text(uuid.uuid4().hex[:8]))
    calls = []
    real = native_loader.read_csv_native

    def spy(p, config=None):
        calls.append(p)
        return real(p, config)

    monkeypatch.setattr(native_loader, "read_csv_native", spy)
    table = port_csv.load_csv(path)
    assert calls == [path] and table.num_rows == 5

    # SQLRS_TPU_NATIVE_CSV=0 turns the native path off (read at first load)
    monkeypatch.setenv("SQLRS_TPU_NATIVE_CSV", "0")
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "_lib_failed", False)
    assert not native_loader.native_available()
    calls.clear()
    table2 = port_csv.load_csv(path)
    assert calls == [] and table2.num_rows == 5
    with pytest.raises(Exception, match="unavailable"):
        real(path)


@needs_gxx
def test_native_errors_and_sql(tmp_path):
    import sqlrs_tpu_torch

    with pytest.raises(sqlrs_tpu_torch.errors.StorageError):
        native_loader.read_csv_native(str(tmp_path / "missing.csv"))
    path = _write(tmp_path, _csv_text(uuid.uuid4().hex[:8]), "people.csv")
    db = sqlrs_tpu_torch.Database(device="cpu")
    db.create_csv_table("people", path)
    assert db.run_lines("select id, score from people where ok order by id") == [
        "1 1.25", "4 -2"
    ]
    assert db.run_lines(
        f"select count(*) from read_csv('{path}', header=>true) where dt > cast('2021-01-01' as date)"
    ) == ["2"]
