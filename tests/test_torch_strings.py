"""The port's string dictionary (sqlrs_tpu_torch/data/strings.py) against
the reference's (sqlrs_tpu/data/strings.py), native interner included.

Both packages' GLOBAL_STRINGS bind a native interner built from
native/interner.cpp: the reference its committed native/libsqlrs_intern.so,
the port its own build under build/native/. Each library keeps its own map,
so the two dictionaries share nothing; loaded with the same data in the same
order they must give every string the same code. Both dictionaries are
process-global, so the check runs in a fresh child process: the same numpy
tables (low and high cardinality, more than 256 rows, with NULLs) and the
same CSV go into both engines, then the code tables and the rows of a GROUP
BY, a DISTINCT and an ORDER BY on the VARCHAR columns are compared, with
the interner on and with SQLRS_TPU_NATIVE_INTERN=0. Building the port's
library must leave native/ untouched.
"""

import hashlib
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import sqlrs_tpu_torch
from sqlrs_tpu.data import strings as ref_strings
from sqlrs_tpu_torch.data import strings as port_strings
from sqlrs_tpu_torch.utils import native_build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
needs_gxx = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++ on PATH")

CHILD = r"""
import json, os, sys
import numpy as np
import sqlrs_tpu, sqlrs_tpu_torch
import sqlrs_tpu.catalog.catalog, sqlrs_tpu.storage.memory, sqlrs_tpu.types
import sqlrs_tpu_torch.catalog.catalog, sqlrs_tpu_torch.storage.memory, sqlrs_tpu_torch.types
from sqlrs_tpu.data import strings as rs
from sqlrs_tpu_torch.data import strings as ps

rng = np.random.default_rng(7)
words = np.array(["kiwi", "mango", "zebra", "apple", "pear", "fig"])
low = words[rng.integers(0, len(words), 2000)]
high = np.array([f"w{i * 7919 % 2503}" for i in range(3000)])
pool = ["q" + w for w in words] + ["only_here"]
nulls = [None if i % 5 == 0 else pool[(i * 3) % len(pool)] for i in range(600)]
csv_path = sys.argv[1]


def load(pkg, db, name, cols):
    lt, strings = pkg.types.LogicalType, pkg.data.strings
    types = [lt[t] for _c, t, _v in cols]
    table = pkg.storage.memory.DataTable([c for c, _t, _v in cols], types)
    datas, valids = [], []
    for (_c, _t, v), t in zip(cols, types):
        if t == lt.VARCHAR:
            v = strings.GLOBAL_STRINGS.intern_many(v)
            valids.append(v != strings.NULL_CODE)
        else:
            v = np.asarray(v)
            valids.append(np.ones(len(v), np.bool_))
        datas.append(v)
    table.append_numpy(datas, valids)
    db.catalog.create_table(
        name,
        [pkg.catalog.catalog.ColumnDefinition(c, t) for (c, *_r), t in zip(cols, types)],
        table,
    )


out = {"rows": {}}
engines = {"ref": (sqlrs_tpu, sqlrs_tpu.Database()),
           "port": (sqlrs_tpu_torch, sqlrs_tpu_torch.Database(device="cpu"))}
for key, (pkg, db) in engines.items():
    load(pkg, db, "a", [("id", "BIGINT", np.arange(2000)), ("s", "VARCHAR", low)])
    load(pkg, db, "b", [("id", "BIGINT", np.arange(3000)), ("s", "VARCHAR", high)])
    load(pkg, db, "c", [("id", "BIGINT", np.arange(600)), ("s", "VARCHAR", nulls)])
    db.create_csv_table("v", csv_path)
queries = []
for t in ("a", "b", "c", "v"):
    queries += [
        f"select s, count(*) from {t} group by s",
        f"select distinct s from {t}",
        f"select s, id from {t} order by s desc, id limit 40",
        f"select s from {t} where s > 'm' order by s",
    ]
for key, (pkg, db) in engines.items():
    out["rows"][key] = [db.run_lines(q) for q in queries]
R, P = rs.GLOBAL_STRINGS, ps.GLOBAL_STRINGS
out["ref_bound"] = bool(R._native)
out["port_bound"] = P.native_bound
out["port_lib"] = P._native._name if P.native_bound else None
out["ref_codes"] = [R.lookup(i) for i in range(len(R))]
out["port_codes"] = [P.lookup(i) for i in range(len(P))]
# the two maps are separate: a string only the reference sees leaves the
# port's dictionary as it was, and the port's next string takes its next code
n_port = len(P)
R.intern("seen_by_the_reference_only")
out["port_len_unchanged"] = len(P) == n_port
out["port_next_code"] = [P.intern("seen_by_the_port_only"), n_port]
out["codes_sample"] = [int(c) for c in P.intern_many(high[:300])[:5]]
print("RESULT " + json.dumps(out))
"""


def _native_digest() -> dict:
    native = os.path.join(REPO, "native")
    out = {}
    for name in sorted(os.listdir(native)):
        with open(os.path.join(native, name), "rb") as f:
            out[name] = hashlib.sha1(f.read()).hexdigest()
    return out


def _run_child(tmp_path, native: bool) -> dict:
    csv = tmp_path / "v.csv"
    csv.write_text(
        "id,s\n" + "".join(
            f"{i},{['zulu', 'alpha', 'mike', 'alpha', ''][i % 5] or ''}\n" for i in range(300)
        )
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu", SQLRS_TPU_NATIVE_INTERN="1" if native else "0")
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, str(csv)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = next(x for x in proc.stdout.splitlines() if x.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


@needs_gxx
@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_both_dictionaries_agree_in_a_fresh_process(tmp_path, native):
    before = _native_digest()
    out = _run_child(tmp_path, native)
    assert out["ref_bound"] is native
    assert out["port_bound"] is native
    if native:
        lib = out["port_lib"]
        assert os.path.dirname(lib) == native_build.BUILD_DIR
        assert os.path.basename(lib).startswith("libsqlrs_intern_")
    assert out["port_codes"] == out["ref_codes"]
    assert len(out["port_codes"]) > 2500
    assert out["rows"]["port"] == out["rows"]["ref"]
    assert out["port_len_unchanged"]
    assert out["port_next_code"][0] == out["port_next_code"][1]
    # building the port's library never touches the reference's native/
    assert _native_digest() == before
    inside = subprocess.run(
        ["git", "rev-parse", "--is-inside-work-tree"], cwd=REPO, capture_output=True, text=True
    )
    if inside.returncode == 0:
        status = subprocess.run(
            ["git", "status", "--porcelain", "native/"], cwd=REPO, capture_output=True, text=True
        )
        assert status.stdout == ""


@needs_gxx
def test_native_build_is_keyed_by_source_and_flags():
    src = os.path.join(native_build.NATIVE_DIR, "interner.cpp")
    path = native_build.build(src, "libsqlrs_intern")
    assert path == native_build.library_path(src, "libsqlrs_intern")
    assert os.path.exists(path)
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(native_build.CXX_FLAGS).encode()).hexdigest()
    assert os.path.basename(path) == f"libsqlrs_intern_{digest[:12]}.so"
    assert native_build.build(src, "libsqlrs_intern") == path  # built once


@pytest.mark.parametrize("n_distinct", [3, 40, 2000], ids=["low", "mid", "high"])
def test_python_path_codes_equal_the_reference(n_distinct):
    """Unbound dictionaries (the path SQLRS_TPU_NATIVE_INTERN=0 or a missing
    compiler leaves): the same calls give the same codes in both packages,
    the sorted pre-dedup of low-cardinality bulk arrays included."""
    rng = np.random.default_rng(n_distinct)
    vals = np.array([f"v{i}" for i in rng.integers(0, n_distinct, 3000)])
    small = [None, "b", "a", None, "b"]
    ref, port = ref_strings.StringDictionary(), port_strings.StringDictionary()
    for d in (ref, port):
        d.intern("zz")
    r = [ref.intern_many(vals), ref.intern_many(small), ref.intern_many(list(vals[:100]))]
    p = [port.intern_many(vals), port.intern_many(small), port.intern_many(list(vals[:100]))]
    for a, b in zip(r, p):
        np.testing.assert_array_equal(a, b)
    assert [ref.lookup(i) for i in range(len(ref))] == [port.lookup(i) for i in range(len(port))]
    assert not port.native_bound
    np.testing.assert_array_equal(ref.ranks(), port.ranks())


def test_only_the_global_dictionary_binds():
    d = port_strings.StringDictionary()
    d.intern("x")
    assert not d.native_bound
    assert port_strings.GLOBAL_STRINGS._native_ok
    assert sqlrs_tpu_torch.data.GLOBAL_STRINGS is port_strings.GLOBAL_STRINGS
