"""The program layer (sqlrs_tpu_torch/utils/programs.py) on the CPU.

On the card each program is a captured CUDA graph; here a program is its
function, called directly, and `programs.checking()` holds it to what a
capture needs. Inside it every program body runs under a dispatch mode that
raises on a host read (`.item()`, `int(t)`, `.numpy()`, `.tolist()`,
nonzero, masked_select, unique, a boolean-mask index, `torch.tensor` of
host data, repeat_interleave without output_size) or an in-place write to an
input, and the mode counts what the statements would submit on the card:
one per program call, one per input copy and output copy, each operation
outside programs, each host read.

- The 22 TPC-H queries at SF 0.002 (seed 3, the port's copies of the
  generator and texts), the small fuzz cases of
  sqlrs_tpu_torch/benchmarks/sql_fuzz.py and the 102 cases of
  sql_cases.py run under it: no program body reads the host.
- For tests/test_tpch.py's FAST queries the count is held against the
  reference's own dispatch count, `benchmarks/dispatch_count.py`'s counter
  run live on the JAX package in a child process (it patches JAX for the
  whole process): each query makes at most as many program calls as the
  reference makes dispatches, and all its submissions together (program
  calls, copies, operations outside programs and host reads) are at most
  3x the reference's total.
- The key (shapes, dtypes, static arguments, the dictionary's length, a
  resident tensor's address), the 512-entry LRU, SQLRS_TPU_FUSE=0, the
  flat input/output layout the card's copies use, and equal results with
  programs on and off.

Tests that need the card are marked `cuda` and skip here.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import sqlrs_tpu_torch
from benchmarks import tpch
from sqlrs_tpu_torch.benchmarks import sql_cases, sql_fuzz
from sqlrs_tpu_torch.benchmarks import tpch_dbgen as port_dbgen
from sqlrs_tpu_torch.data.strings import GLOBAL_STRINGS
from sqlrs_tpu_torch.storage.memory import import_tables
from sqlrs_tpu_torch.utils import programs
from sqlrs_tpu_torch.utils.programs import HostReadInProgram, program
from sqlrs_tpu_torch.utils.render import batch_to_rows

SF = 0.002
SEED = 3
FAST = [4, 6, 13, 15, 16, 17, 18, 22]  # tests/test_tpch.py's fast tier
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PORT_CPU = sql_cases.Engine(
    "port cpu", sqlrs_tpu_torch,
    lambda profile: sqlrs_tpu_torch.Database(profile=profile, device="cpu"),
    import_tables, device="cpu")


@pytest.fixture(autouse=True)
def dictionaries_in_step():
    """This file interns strings into the port's dictionary only; other
    test files in the same worker compare dictionary codes between the two
    packages, so the reference's dictionary takes the same strings in the
    same order afterwards."""
    yield
    from sqlrs_tpu.data.strings import GLOBAL_STRINGS as REF_STRINGS

    for code in range(len(REF_STRINGS), len(GLOBAL_STRINGS)):
        REF_STRINGS.intern(GLOBAL_STRINGS.lookup(code))


@pytest.fixture(scope="module")
def tpch_db():
    db = sqlrs_tpu_torch.Database(device="cpu")
    port_dbgen.load_into(db, port_dbgen.gen_tables(SF, seed=SEED))
    return db


def _checked(run, emulate=False):
    """run() under programs.checking() (and programs.emulating()); raises if
    any program body was refused, even where the statement's own error
    handling caught it."""
    with programs.checking() as c:
        if emulate:
            with programs.emulating():
                out = run()
        else:
            out = run()
    assert not c.refused, c.refused[:3]
    return c, out


def _off(run, monkeypatch):
    """run() with SQLRS_TPU_FUSE=0: the eager answer."""
    with monkeypatch.context() as m:
        m.setenv("SQLRS_TPU_FUSE", "0")
        return run()


# ---- (a) no program reads the host; the layouts give the eager answers ------------
# A run under checking() and emulating() goes through every program as the
# card lays it out (inputs copied into a flat region, the body on its views,
# the outputs packed into one buffer and cloned out), without the graph:
# its results must equal the SQLRS_TPU_FUSE=0 run's exactly.


@pytest.mark.parametrize("qn", range(1, 23))
def test_tpch_programs_read_no_host(tpch_db, qn, monkeypatch):
    run = lambda: tpch.run_query(tpch_db, qn)  # noqa: E731
    want = _off(run, monkeypatch)  # first use: rank tables, code maps
    c, got = _checked(run, emulate=True)
    assert c.programs > 0
    assert repr(got) == repr(want)
    _checked(run)  # and an in-place write to any input raises


@pytest.mark.parametrize("seed", sql_fuzz.SMALL_SEEDS)
def test_fuzz_programs_read_no_host(seed, monkeypatch):
    monkeypatch.setenv("SQLRS_TPU_MXU", "interpret")  # the kernels' routes
    case = sql_fuzz.gen_case(seed, "small")
    db = sqlrs_tpu_torch.Database(device="cpu")
    import_tables(db, case.tables)

    def run():
        return [sql_fuzz.outcome(db, sql, batch_to_rows) for sql in case.statements]

    want = _off(run, monkeypatch)
    c, got = _checked(run, emulate=True)
    assert c.programs > 0
    assert sum(o[0] == "ok" for o in got) >= len(got) // 2
    assert repr(got) == repr(want)


@pytest.mark.parametrize("seed", sql_fuzz.SMALL_SEEDS[::4])
def test_fuzz_emulated_over_shards(seed, monkeypatch):
    """The sharded engine's one-device operators take programs too."""
    monkeypatch.setenv("SQLRS_TPU_MXU", "interpret")
    case = sql_fuzz.gen_case(seed, "small")
    db = sqlrs_tpu_torch.Database(n_devices=4, device="cpu")
    import_tables(db, case.tables)

    def run():
        return [sql_fuzz.outcome(db, sql, batch_to_rows) for sql in case.statements]

    want = _off(run, monkeypatch)
    with programs.emulating():
        assert repr(run()) == repr(want)


@pytest.mark.parametrize("case", sql_cases.all_cases(), ids=lambda c: c.id)
def test_sql_case_programs_read_no_host(case, tmp_path, monkeypatch):
    run = lambda: sql_cases.run_case(case, PORT_CPU, str(tmp_path))  # noqa: E731
    want = _off(run, monkeypatch)
    _, got = _checked(run, emulate=True)
    assert repr(got) == repr(want)


# ---- (b) submissions against the reference's dispatches ---------------------------

_REF_COUNT = """
import json, sys
from benchmarks.dispatch_count import DispatchCounter, install
counter = DispatchCounter()
install(counter)
import sqlrs_tpu
from benchmarks import tpch_dbgen
from benchmarks.tpch import run_query
db = sqlrs_tpu.Database()
tpch_dbgen.load_into(db, tpch_dbgen.gen_tables(float(sys.argv[1]), seed=int(sys.argv[2])))
out = {}
for qn in json.loads(sys.argv[3]):
    run_query(db, qn)  # warm: traces, interning
    counter.reset()
    counter.active = True
    run_query(db, qn)
    counter.active = False
    out[qn] = counter.total()
print(json.dumps(out))
"""


def test_fast_submissions_against_reference_dispatches(tpch_db):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _REF_COUNT, str(SF), str(SEED), json.dumps(FAST)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    ref = {int(k): v for k, v in json.loads(proc.stdout.strip().splitlines()[-1]).items()}
    port = {}
    for qn in FAST:
        tpch.run_query(tpch_db, qn)
        c, _ = _checked(lambda: tpch.run_query(tpch_db, qn))
        port[qn] = c
        print(f"Q{qn}: reference {ref[qn]} dispatches; port {c.programs} program calls, "
              f"{c.submissions()} submissions ({c.input_copies} input copies, "
              f"{c.output_copies} output copies, {c.eager_ops} ops outside programs, "
              f"{c.host_reads} host reads)")
    total_ref = sum(ref.values())
    total_port = sum(c.submissions() for c in port.values())
    print(f"FAST total: reference {total_ref}, port {total_port} submissions")
    for qn in FAST:
        assert port[qn].programs <= ref[qn], (qn, port[qn].programs, ref[qn])
    assert total_port <= 3 * total_ref, (total_port, total_ref)


# ---- (c) the key, the LRU, SQLRS_TPU_FUSE=0 ----------------------------------------


@program
def _axpy(x, y, a: float):
    return x * a + y


def _key(*args, **kwargs):
    leaves = []
    tree = programs._flatten((args, kwargs), leaves)
    return programs.signature(_axpy.name, (), tree, leaves)


def test_key_is_the_references_signature():
    x, y = torch.ones(8), torch.zeros(8)
    k = _key(x, y, 2.0)
    assert _key(torch.full((8,), 3.0), torch.ones(8), 2.0) == k  # values: no
    assert _key(torch.ones(9), torch.zeros(9), 2.0) != k  # shapes
    assert _key(x.double(), y.double(), 2.0) != k  # dtypes
    assert _key(x, y, 3.0) != k  # static arguments
    assert _key(x, y, a=2.0) != k  # the call's structure
    GLOBAL_STRINGS.intern("a string no other test interns: programs key")
    assert _key(x, y, 2.0) != k  # the dictionary's length


def test_resident_tensors_key_on_their_address():
    t = torch.arange(16)
    programs.mark_resident(t)
    assert programs.is_resident(t) and programs.is_resident(t[4:])
    assert not programs.is_resident(t.clone())
    assert _key(t, t, 1.0) != _key(t.clone(), t.clone(), 1.0)
    assert _key(t[:8], t[:8], 1.0) != _key(t[8:], t[8:], 1.0)


def test_lru_keeps_512_signatures():
    lru = programs.LRU()
    assert lru.max_entries == 512
    for i in range(600):
        lru.put(i, i)
        if i == 300:
            assert lru.get(0) == 0  # used: moves to the back
    assert len(lru) == 512
    assert lru.get(0) == 0 and lru.get(1) is None and lru.get(599) == 599


def test_lru_starts_a_new_pool_when_its_last_graph_leaves():
    """PyTorch refuses a capture into a pool all of whose graphs are gone."""

    class Pools(programs.LRU):
        def __init__(self):
            super().__init__(max_entries=4)
            self.pools = 0

        def new_pool(self):
            self.pools += 1

    lru = Pools()
    lru.put("a", programs._SEEN)
    lru.put("a", "graph a")  # a signature's second call captures
    lru.put("b", "graph b")
    assert lru.n_graphs == 2
    for k in "cdef":
        lru.put(k, programs._SEEN)
    assert lru.n_graphs == 0 and lru.pools == 1
    lru.put("c", "graph c")
    for k in "ghi":
        lru.put(k, programs._SEEN)
    assert lru.n_graphs == 1 and lru.pools == 1


def test_fuse_off_makes_no_program_calls(tpch_db, monkeypatch):
    tpch.run_query(tpch_db, 3)
    on, _ = _checked(lambda: tpch.run_query(tpch_db, 3))
    monkeypatch.setenv("SQLRS_TPU_FUSE", "0")
    off, _ = _checked(lambda: tpch.run_query(tpch_db, 3))
    assert on.programs > 0 and off.programs == 0 and not off.keys
    assert off.submissions() > 3 * on.submissions()


# ---- (d) programs on and off give the same rows ------------------------------------


@pytest.mark.parametrize("qn", FAST)
def test_fast_rows_equal_with_programs_off(tpch_db, qn, monkeypatch):
    on = tpch.run_query(tpch_db, qn)
    monkeypatch.setenv("SQLRS_TPU_FUSE", "0")
    off = tpch.run_query(tpch_db, qn)
    assert repr(on) == repr(off)


# ---- the checking mode itself ---------------------------------------------------------


@program
def _reads(x, how: str):
    if how == "item":
        return x + x.sum().item()
    if how == "int":
        return x * int(x[0])
    if how == "numpy":
        return torch.from_numpy(x.numpy() + 1)
    if how == "tolist":
        return x + len(x.tolist())
    if how == "mask":
        return x[x > 2]
    if how == "nonzero":
        return torch.nonzero(x)
    if how == "upload":
        return x + torch.tensor([1, 2, 3, 4])
    if how == "repeat":
        return torch.repeat_interleave(x, x)
    if how == "write":
        return x.add_(1)
    return x * 2 + 1


@pytest.mark.parametrize(
    "how", ["item", "int", "numpy", "tolist", "mask", "nonzero", "upload", "repeat", "write"])
def test_checking_refuses_host_reads_in_programs(how):
    x = torch.arange(4)
    with programs.checking() as c:
        with pytest.raises(HostReadInProgram):
            _reads(x, how)
        assert c.refused
    assert torch.equal(x, torch.arange(4))


def test_checking_counts_outside_programs():
    x = torch.arange(4)
    with programs.checking() as c:
        y = _reads(x, "ok")  # a capturable body
        n = int(y.sum())
        z = (x + 1) * 2
        z.numpy()
    assert n == 16 and z.shape == (4,)
    assert (c.programs, c.input_copies, c.output_copies) == (1, 1, 1)
    assert c.host_reads == 2 and c.eager_ops >= 3


def test_flat_layout_round_trip():
    """The layout the card's input fill and output clone use: every
    tensor at a 256-byte aligned offset of one flat byte buffer."""
    g = torch.Generator().manual_seed(0)
    ts = [
        torch.randint(0, 2, (7,), generator=g).bool(),
        torch.randint(-9, 9, (3, 5), generator=g, dtype=torch.int32),
        torch.randint(-9, 9, (33,), generator=g),
        torch.rand(4, 2, generator=g, dtype=torch.float64),
        torch.zeros(0, dtype=torch.int64),
        torch.tensor(5.5, dtype=torch.float64),
        torch.arange(12).reshape(3, 4).t(),  # not contiguous
    ]
    offs, total = programs._slots(ts)
    assert all(o % 256 == 0 for o in offs) and total >= sum(programs._nbytes(t) for t in ts)
    flat = torch.empty(total, dtype=torch.uint8)
    programs._pack(ts, offs, total, flat)
    for t, o in zip(ts, offs):
        v = programs._byte_view(flat, o, t)
        assert v.dtype == t.dtype and v.shape == t.shape and torch.equal(v, t)


def test_flatten_round_trip():
    a, b = torch.ones(2), torch.zeros(3)
    tree_in = ((a, None, [b, 3]), {"k": (a,), "s": "x"})
    leaves = []
    tree = programs._flatten(tree_in, leaves)
    assert len(leaves) == 3 and hash(tree) == hash(programs._flatten(tree_in, []))
    out = programs._unflatten(tree, iter(leaves))
    assert out[0][1] is None and out[0][2][1] == 3 and out[1]["s"] == "x"
    assert out[0][0] is a and out[0][2][0] is b and isinstance(out[0][2], list)


# ---- on the card ---------------------------------------------------------------


@pytest.mark.cuda
def test_replays_take_inputs_at_new_addresses():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a program is a CUDA graph only there")
    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(1)
    before = programs.stats.replays
    outs = []
    for _ in range(4):
        x = torch.rand(1000, generator=g, dtype=torch.float64).to(dev)
        y = torch.rand(1000, generator=g, dtype=torch.float64).to(dev)
        outs.append((_axpy(x, y, 2.5), x * 2.5 + y))
    for got, want in outs:  # every result still live and right
        assert torch.equal(got, want)
    assert programs.stats.replays - before == 3  # the first call warms up
