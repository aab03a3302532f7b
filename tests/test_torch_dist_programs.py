"""The sharded engine's stages as programs (utils/programs.mesh_program) on
the CPU, over 4 CPU shards.

Each of the reference's 13 `shard_map` programs (dist_ops.py, dist_join.py
and the distributed GROUP BY's partials in dist_executor.py) is one
program of the port: on the card, over shards that share it in one
process, every shard's body and the collectives between them are one CUDA
graph. Here a program is its function, and:

- under `programs.checking()` no stage program reads the host or makes a
  shape from data (the TPC-H FAST queries at SF 0.002 under the auto,
  shuffle, ring-exchange and ring policies; a quarter of the small fuzz
  seeds; the dist_ops strategies, sorts and exchanges on a small star);
- under `programs.emulating()` (the card's input region and packed
  outputs, without the graph) the same runs give the rows of the
  SQLRS_TPU_FUSE=0 run, compared exactly (repr of every row); a sample
  also equals the JAX package's one-device engine by benchmarks/tpch.py's
  rule (exact for non-floats, floats rel 1e-9 or abs 1e-6), and the star
  equals numpy exactly;
- a process-group mesh and a mesh over two devices run a stage eagerly,
  with the reason counted, decided before the call;
- two meshes never share a signature;
- the broadcast hash join's probe, a stage of the port's own (the
  reference runs that join per op), is one program a join for every join
  type, and TPC-H Q5's joins make 0 eager ops inside `_hash_join_dist`
  (3,253 before it).
"""

import numpy as np
import pytest
import torch

import sqlrs_tpu
import sqlrs_tpu_torch
from benchmarks import tpch
from benchmarks import tpch_dbgen as ref_dbgen
from sqlrs_tpu_torch.benchmarks import sql_fuzz
from sqlrs_tpu_torch.benchmarks import tpch_dbgen as port_dbgen
from sqlrs_tpu_torch.data.strings import GLOBAL_STRINGS
from sqlrs_tpu_torch.parallel import dist_join, dist_ops
from sqlrs_tpu_torch.parallel.mesh import Mesh, live_blocks, make_mesh, shard_positions
from sqlrs_tpu_torch.storage.memory import import_tables
from sqlrs_tpu_torch.utils import programs
from sqlrs_tpu_torch.utils.render import batch_to_rows

N_DEV = 4
SF = 0.002
SEED = 3
FAST = [4, 6, 13, 15, 16, 17, 18, 22]  # tests/test_tpch.py's fast tier
POLICIES = {
    "auto": {},
    "shuffle": {"dist_join_policy": "shuffle"},
    "ring_exchange": {"dist_join_policy": "shuffle", "dist_exchange_ring": True,
                      "dist_hot_min": 1},
}
# every FAST query as the planner picks; under the forced shuffle (plain
# and ring-staged exchange, hot buckets salted) the ones whose joins it
# moves, Q18 left out for its time (its shuffle is phase 8's on the card)
TPCH_RUNS = ([(qn, "auto") for qn in FAST] + [(qn, "shuffle") for qn in (4, 15, 16, 17)]
             + [(qn, "ring_exchange") for qn in (16, 17)])
# the reference's shard_map programs, by the port's program names
STAGES = {
    "dist_ops.partition_shuffle": "sqlrs_tpu/parallel/dist_ops.py:165",
    "dist_ops.dist_join_groupby_broadcast": "sqlrs_tpu/parallel/dist_ops.py:193",
    "dist_ops.dist_join_groupby_shuffle": "sqlrs_tpu/parallel/dist_ops.py:235",
    "dist_ops.dist_join_groupby_salted": "sqlrs_tpu/parallel/dist_ops.py:366",
    "dist_ops.dist_join_groupby_ring": "sqlrs_tpu/parallel/dist_ops.py:482",
    "dist_ops._sort_rows_stage": "sqlrs_tpu/parallel/dist_ops.py:611",
    "dist_ops.dist_sort": "sqlrs_tpu/parallel/dist_ops.py:668",
    "dist_join._phase_a_stage": "sqlrs_tpu/parallel/dist_join.py:328",
    "dist_join._phase_b_stage": "sqlrs_tpu/parallel/dist_join.py:394",
    "dist_join.ring_agg_join": "sqlrs_tpu/parallel/dist_join.py:610",
    "dist_join.broadcast_agg_join": "sqlrs_tpu/parallel/dist_join.py:752",
    "dist_join.pair_local_dedup": "sqlrs_tpu/parallel/dist_join.py:786",
    "dist_executor._grouped_partials": "sqlrs_tpu/parallel/dist_executor.py:960",
}


# the port's stages with no reference shard_map, and why, as their docstrings say
PORT_STAGES = {
    "dist_join.broadcast_probe": "the reference runs this join per op",
}


@pytest.fixture(autouse=True)
def dictionaries_in_step():
    """Strings interned here go into the reference's dictionary too, in the
    same order, for the test files that compare codes afterwards."""
    yield
    from sqlrs_tpu.data.strings import GLOBAL_STRINGS as REF_STRINGS

    for code in range(len(REF_STRINGS), len(GLOBAL_STRINGS)):
        REF_STRINGS.intern(GLOBAL_STRINGS.lookup(code))


def _stages(c) -> set:
    return {n.removeprefix("sqlrs_tpu_torch.parallel.") for n in c.by_program} & set(STAGES)


def _checked(run, emulate: bool):
    """run() under programs.checking() (and emulating()): no body refused,
    even where a statement's own error handling caught the refusal."""
    with programs.checking() as c:
        if emulate:
            with programs.emulating():
                out = run()
        else:
            out = run()
    assert not c.refused, c.refused[:3]
    return c, out


def _off(run, monkeypatch):
    with monkeypatch.context() as m:
        m.setenv("SQLRS_TPU_FUSE", "0")
        return run()


def _held(run, monkeypatch):
    """The run's result with programs off; then the same result under
    checking() + emulating(), and no in-place write to an input under
    checking() alone. Returns (result, checker)."""
    want = _off(run, monkeypatch)
    c, got = _checked(run, emulate=True)
    assert repr(got) == repr(want)
    _checked(run, emulate=False)
    return want, c


# ---- the TPC-H FAST queries over 4 shards, every join policy -------------------------


@pytest.fixture(scope="module")
def tpch_tables():
    return port_dbgen.gen_tables(SF, seed=SEED)


@pytest.fixture(scope="module")
def dist_dbs(tpch_tables):
    dbs = {}
    for name, knobs in POLICIES.items():
        db = sqlrs_tpu_torch.Database(n_devices=N_DEV, device="cpu")
        port_dbgen.load_into(db, tpch_tables)
        for k, v in knobs.items():
            setattr(db, k, v)
        dbs[name] = db
    return dbs


@pytest.fixture(scope="module")
def reference_rows():
    """The JAX package's one-device engine on the same tables (Q4, Q13 and
    Q18, the sample held to it)."""
    db = sqlrs_tpu.Database()
    ref_dbgen.load_into(db, ref_dbgen.gen_tables(SF, seed=SEED))
    return {qn: tpch.run_query(db, qn) for qn in (4, 13, 18)}


@pytest.mark.parametrize("qn,policy", TPCH_RUNS)
def test_tpch_stages_read_no_host(dist_dbs, reference_rows, qn, policy, monkeypatch):
    db = dist_dbs[policy]
    want, c = _held(lambda: tpch.run_query(db, qn), monkeypatch)
    if qn in reference_rows:
        assert not tpch.compare(want, reference_rows[qn], qn)
    if qn in (4, 15, 18) and policy == "auto":
        assert "dist_executor._grouped_partials" in _stages(c)
    if qn in (16, 17) and policy != "auto":
        assert {"dist_join._phase_a_stage", "dist_join._phase_b_stage"} <= _stages(c)


def _fused_tables():
    """A dim of 24 keys (two repeated) and 800 fact rows, NULLs in v."""
    rng = np.random.default_rng(17)
    dim = ",".join(f"({k},{k % 5})" for k in list(range(24)) + [3, 7])
    fact = ",".join(
        f"({int(rng.integers(0, 30))},{'NULL' if i % 11 == 0 else int(rng.integers(-9, 9))},"
        f"{int(rng.integers(-40, 40)) / 4.0})" for i in range(800))
    return ["create table dim(k int, g int)", "create table fact(k int, v int, x double)",
            f"insert into dim values {dim}", f"insert into fact values {fact}"]


FUSED_SQL = [
    "select dim.g, sum(fact.v), count(*), min(fact.x), max(fact.v), avg(fact.x) "
    "from dim join fact on fact.k = dim.k group by dim.g",
    "select dim.k, count(distinct fact.v), sum(distinct fact.v), count(*) "
    "from dim join fact on fact.k = dim.k group by dim.k",
]


@pytest.mark.parametrize("policy", ["auto", "ring"])
def test_fused_agg_over_join_stages(policy, monkeypatch):
    """A rollup over a join takes the broadcast-fused (auto) or ring
    program; a DISTINCT aggregate over it also the pair dedup and the
    shuffle between its two dedups."""
    db = sqlrs_tpu_torch.Database(n_devices=N_DEV, device="cpu")
    db.dist_join_policy = policy
    for stmt in _fused_tables():
        db.run(stmt)
    _, c = _held(lambda: [db.run_lines(q) for q in FUSED_SQL], monkeypatch)
    fused = "dist_join.ring_agg_join" if policy == "ring" else "dist_join.broadcast_agg_join"
    assert {fused, "dist_join.pair_local_dedup", "dist_ops.partition_shuffle",
            "dist_executor._grouped_partials"} <= _stages(c)


# ---- a quarter of the small fuzz seeds over 4 shards -----------------------------------


@pytest.mark.parametrize("seed", sql_fuzz.SMALL_SEEDS[::4])
def test_fuzz_stages_read_no_host(seed, monkeypatch):
    monkeypatch.setenv("SQLRS_TPU_MXU", "interpret")  # the kernels' routes
    case = sql_fuzz.gen_case(seed, "small")
    db = sqlrs_tpu_torch.Database(n_devices=N_DEV, device="cpu")
    import_tables(db, case.tables)

    def run():
        return [sql_fuzz.outcome(db, sql, batch_to_rows) for sql in case.statements]

    want, _ = _held(run, monkeypatch)
    assert sum(o[0] == "ok" for o in want) >= len(want) // 2


# ---- dist_ops on a small star ------------------------------------------------------------


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(N_DEV, devices=["cpu"] * N_DEV)


@pytest.fixture(scope="module")
def star():
    """5,000 zipf(1.3) fact keys into 64 dim keys (an odd count: the blocks
    carry padding)."""
    rng = np.random.default_rng(5)
    n, groups = 5_001, 64
    gid = np.minimum(rng.zipf(1.3, n), groups).astype(np.int64) - 1
    dim_keys = np.arange(groups, dtype=np.int64) * 7 + 3
    vals = rng.integers(0, 10, n).astype(np.int64)
    sums, counts = np.zeros(groups, np.int64), np.zeros(groups, np.int64)
    np.add.at(sums, gid, vals)
    np.add.at(counts, gid, 1)
    return dict(fk=torch.from_numpy(dim_keys[gid]), fv=torch.from_numpy(vals),
                dk=torch.from_numpy(dim_keys), groups=groups, sums=sums, counts=counts, n=n)


STRATEGIES = {
    "broadcast": lambda m, s: dist_ops.dist_join_groupby_broadcast(
        m, s["fk"], s["fv"], s["dk"], s["groups"]),
    "shuffle_checked": lambda m, s: dist_ops.dist_join_groupby_shuffle_checked(
        m, s["fk"], s["fv"], s["dk"], s["groups"], bucket_capacity=16),
    "salted_checked": lambda m, s: dist_ops.dist_join_groupby_salted_checked(
        m, s["fk"], s["fv"], s["dk"], s["groups"], bucket_capacity=16, hot_capacity=1,
        hot_factor=0.5),
    "ring": lambda m, s: dist_ops.dist_join_groupby_ring(
        m, s["fk"], s["fv"], s["dk"], s["groups"]),
}


@pytest.mark.parametrize("strategy", list(STRATEGIES))
def test_star_strategy_programs(mesh, star, strategy, monkeypatch):
    """Each strategy is one program (the checked ones one a try, their
    retries and overflow reads outside it), equal to numpy exactly."""
    (sums, counts), c = _held(lambda: STRATEGIES[strategy](mesh, star), monkeypatch)
    assert np.array_equal(sums.numpy(), star["sums"])
    assert np.array_equal(counts.numpy(), star["counts"])
    name = "dist_join_groupby_" + strategy.removesuffix("_checked")
    assert c.by_program[f"sqlrs_tpu_torch.parallel.dist_ops.{name}"] >= 1
    if strategy.endswith("_checked"):  # capacity 16 overflows: retried
        assert c.by_program[f"sqlrs_tpu_torch.parallel.dist_ops.{name}"] > 1


def test_sorts_and_exchanges_programs(mesh, star, monkeypatch):
    """dist_sort, dist_sort_rows, partition_shuffle, phase A/B directly and
    pair_local_dedup, each one program, the same with programs off."""
    fk = list(star["fk"][: 4 * 1250].reshape(4, -1).unbind(0))
    fv = list(star["fv"][: 4 * 1250].reshape(4, -1).unbind(0))
    ok = live_blocks(mesh, 4 * 1250)
    rowid = shard_positions(mesh, 1250)

    def run():
        ks, valid = dist_ops.dist_sort(mesh, fk, bucket_capacity=1250)
        keys, pays, alive, ovf = dist_ops.dist_sort_rows(mesh, [fk], [fv], ok, 1250)
        shuf = dist_ops.partition_shuffle(mesh, fk, fv, ok, bucket_capacity=1250)
        dedup = dist_join.pair_local_dedup(mesh, fk, fv, ok)
        a = dist_join.shuffle_join_phase_a(
            mesh, [(fk, ok)], [fv], rowid, ok, [(fk, ok)], [fv], rowid, ok,
            bucket_b=1250, bucket_p=1250, hot_capacity=5000)
        cells = dist_join.shuffle_join_phase_b(mesh, a, 1, 1)
        return ks, valid, keys, pays, alive, ovf, shuf, dedup, (a.overflow, a.m), cells

    out, c = _held(run, monkeypatch)
    assert out[5] == 0 and out[8][0] == 0
    got = torch.cat([k[m] for k, m in zip(out[0], out[1])])
    assert torch.equal(got, torch.sort(torch.cat(fk)).values)
    assert {"dist_ops.dist_sort", "dist_ops._sort_rows_stage", "dist_ops.partition_shuffle",
            "dist_join.pair_local_dedup", "dist_join._phase_a_stage",
            "dist_join._phase_b_stage"} <= _stages(c)


@pytest.mark.parametrize("stage", list(STAGES))
def test_each_reference_program_is_one_stage_program(stage):
    """Each of the reference's shard_map programs has one mesh program,
    whose docstring names the reference's file and line (the tests above
    ran each under checking())."""
    import importlib

    mod, name = stage.split(".")
    fn = getattr(importlib.import_module(f"sqlrs_tpu_torch.parallel.{mod}"), name)
    assert isinstance(fn, programs.MeshProgram)
    assert fn.name == f"sqlrs_tpu_torch.parallel.{stage}"
    assert STAGES[stage] in " ".join(fn.__doc__.split())


@pytest.mark.parametrize("stage", list(PORT_STAGES))
def test_each_port_only_stage_is_one_stage_program(stage):
    """A stage of the port's own, beside the reference's 13: one mesh
    program, whose docstring says why the reference has none."""
    import importlib

    mod, name = stage.split(".")
    fn = getattr(importlib.import_module(f"sqlrs_tpu_torch.parallel.{mod}"), name)
    assert isinstance(fn, programs.MeshProgram)
    assert fn.name == f"sqlrs_tpu_torch.parallel.{stage}"
    assert PORT_STAGES[stage] in " ".join(fn.__doc__.split())


# ---- the broadcast hash join's probe stage ------------------------------------------------

PROBE = "sqlrs_tpu_torch.parallel.dist_join.broadcast_probe"


def _join_tables():
    """A build side b of 40 rows whose keys k repeat (m > 1), with NULL
    keys, and a unique key id; a probe side p of 301 rows with misses and
    NULL keys (the blocks carry padding); p.v is BIGINT, for a residual's
    narrowing cast."""
    rng = np.random.default_rng(23)

    def key(i, hi):
        return "NULL" if i % 13 == 0 else str(int(rng.integers(0, hi)))

    b = ",".join(f"({key(i, 25)},{i % 3},{int(rng.integers(-5, 5))},{int(rng.integers(-8, 8)) / 2},"
                 f"{39 - i})" for i in range(40))
    p = ",".join(f"({key(i + 5, 30)},{i % 4},{int(rng.integers(-5, 5))},{int(rng.integers(-8, 8)) / 2})"
                 for i in range(301))
    return ["create table b(k int, k2 int, a int, x double, id int)",
            "create table p(k int, k2 int, v bigint, y double)",
            f"insert into b values {b}", f"insert into p values {p}"]


# (SQL, probe stage calls, calls routed eagerly by reason)
JOINS = {
    "inner_dup_null_keys": ("select b.k, b.a, p.v from b join p on b.k = p.k", 1, {}),
    # one slot a probe row: the probe columns stay out of the stage
    "inner_unique_key": ("select b.id, b.a, p.k, p.v, p.y from b join p on b.id = p.k", 1, {}),
    "left": ("select b.k, b.a, p.v, p.y from b left join p on b.k = p.k", 1, {}),
    "right_two_keys": ("select b.a, b.x, p.k, p.v from b right join p "
                       "on b.k = p.k and b.k2 = p.k2", 1, {}),
    "full_double_key": ("select b.k, b.x, p.k, p.y from b full join p on b.x = p.y", 1, {}),
    "residual": ("select b.k, b.a, p.v from b join p on b.k = p.k and b.a < p.v", 1, {}),
    "residual_on_host": ("select b.k, b.a, p.v from b left join p "
                         "on b.k = p.k and cast(p.v as int) > b.a", 0,
                         {"checked narrowing cast": 1}),
    "empty_build": ("select s.a, p.v from (select * from b where b.a > 100) s join p "
                    "on s.k = p.k", 0, {}),
    # the probe side is a shuffle join's output: scrambled rows, rowid set
    "rowid_probe": ("select b.a, s.v, s.w from b right join (select p.k, p.v, q.v as w "
                    "from p join p q on p.k = q.k2) s on b.k = s.k", 1, {}),
}


@pytest.fixture(scope="module")
def join_dbs():
    dbs = {}
    for name, kw in (("one", {}), ("auto", {"n_devices": N_DEV}),
                     ("shuffle", {"n_devices": N_DEV})):
        db = sqlrs_tpu_torch.Database(device="cpu", **kw)
        for stmt in _join_tables():
            db.run(stmt)
        dbs[name] = db
    dbs["shuffle"].dist_join_policy = "shuffle"
    return dbs


@pytest.mark.parametrize("case", list(JOINS))
def test_broadcast_join_probe_stage(join_dbs, case, monkeypatch):
    """Each join type, NULL and repeated keys (m > 1), a unique key (m = 1,
    the probe columns kept out of the stage), two keys, a DOUBLE key, a
    residual, a probe side with rowids: one probe stage call a join, no
    body refused under checking() and emulating(), the rows (and their
    order) those of SQLRS_TPU_FUSE=0 and of the one-device engine. A
    residual that reads the host runs eagerly, its reason counted; an
    empty build side delegates before the stage, as it did."""
    sql, calls, eager = JOINS[case]
    db = join_dbs["shuffle" if case == "rowid_probe" else "auto"]
    seen = []
    probe = dist_join.broadcast_probe

    def spy(mesh, *args, **kw):
        seen.append((args[7] is not None, kw["m"], len(args[4])))  # p_rowid, m, p_cols
        return probe(mesh, *args, **kw)

    monkeypatch.setattr(dist_join, "broadcast_probe", spy)
    dist_join.reset_stats()
    want, c = _held(lambda: db.run_lines(sql), monkeypatch)
    assert want == join_dbs["one"].run_lines(sql)
    assert bool(want) == (case != "empty_build")
    assert c.by_program[PROBE] == calls
    st = dist_join.stats()
    # the off run, the checked and emulated run and the checked run
    assert (st.probe_calls, st.probe_staged, dict(st.probe_eager), st.probe_delegated) == (
        3 * (calls + sum(eager.values())), 3 * calls, {r: 3 * n for r, n in eager.items()},
        3 * (case == "empty_build"))
    assert c.eager_routed == eager
    assert len(seen) == 3 * (calls + len(eager))
    for rowid, m, carried in seen:
        assert rowid == (case == "rowid_probe")
        assert (m == 1) == (case == "inner_unique_key") == (carried == 0)


def test_q5_broadcast_joins_are_stage_calls(dist_dbs, monkeypatch):
    """TPC-H Q5 over 4 CPU shards at SF 0.002, seed 3: its 5 broadcast
    joins are 5 probe stage calls, and the eager ops made inside
    `_hash_join_dist` fall from 3,253 (the per-shard Python loop this
    stage replaced, counted the same way) to 0 here: at least 85% fewer.
    `dist_join.stats()` and each `dist:HashJoin` span's detail agree."""
    from sqlrs_tpu_torch.parallel.dist_executor import DistributedExecutor
    from sqlrs_tpu_torch.utils import profiling

    db = dist_dbs["auto"]
    tpch.run_query(db, 5)
    inside = []
    orig = DistributedExecutor._hash_join_dist

    def counted(self, *args):
        n0 = programs._CHECKER.eager_ops
        try:
            return orig(self, *args)
        finally:
            inside.append(programs._CHECKER.eager_ops - n0)

    monkeypatch.setattr(DistributedExecutor, "_hash_join_dist", counted)
    dist_join.reset_stats()
    with profiling.recording() as rec:
        c, _ = _checked(lambda: tpch.run_query(db, 5), emulate=False)
    assert len(inside) == db.last_join_strategies.count("broadcast") == 5
    assert sum(inside) <= 0.15 * 3253
    assert c.by_program[PROBE] == 5
    st = dist_join.stats()
    assert (st.probe_calls, st.probe_staged, dict(st.probe_eager), st.probe_delegated) == (
        5, 5, {}, 0)
    details = [s.detail for s in rec.spans() if s.name.startswith("dist:HashJoin") and s.detail]
    assert len(details) == 5
    assert all((d["probe_calls"], d["probe_staged"], d["probe_eager"]) == (1, 1, {})
               for d in details)


# ---- routing: a predicate before the call, the reason counted ----------------------------


def test_process_group_and_two_device_meshes_route_eagerly():
    keys = [torch.tensor([3, 1, 3, 2]), torch.tensor([5, 5, 0, 1])]
    vals = [torch.tensor([1, 1, 1, 2]), torch.tensor([0, 0, 4, 1])]
    ok = [torch.ones(4, dtype=torch.bool)] * 2
    want = dist_join.pair_local_dedup(make_mesh(2, devices=["cpu"] * 2), keys, vals, ok)
    for mesh, reason in (
        (Mesh(["cpu"] * 2, group=object()), "process-group mesh"),
        (Mesh(["cpu", "meta"]), "shards on more than one device"),
    ):
        programs.reset_stats()
        with programs.checking() as c:
            got = dist_join.pair_local_dedup(mesh, keys, vals, ok)
        assert c.programs == 0 and not c.refused
        assert c.eager_routed == {reason: 1}
        assert programs.stats.eager_routed == {reason: 1}
        assert repr(got) == repr(want)
    programs.reset_stats()


def test_probe_stage_routes_eagerly_off_one_device():
    """The broadcast join's probe stage over a process-group mesh and a
    mesh over two devices: its body eagerly, the reason counted in
    programs.stats and dist_join.stats(), the rows of the one-device
    mesh's stage."""
    from sqlrs_tpu_torch.types import LogicalType

    cpu = torch.device("cpu")
    bk = torch.tensor([3, 1, 3, 2, 7])
    bv = torch.tensor([True, True, True, False, True])
    sorted_bh, order, bits, run_max = dist_join.broadcast_build([(bk, bv)], 5, cpu)
    pk = [torch.tensor([3, 2, 9, 1]), torch.tensor([7, 3, 0, 3])]
    pv = [torch.ones(4, dtype=torch.bool)] * 2
    probe = [[(k, v) for k, v in zip(pk, pv)]]
    args = (sorted_bh, order, [(bk, bv)], [(bits[0], bv)], probe, probe, pv, None)
    kw = dict(types=(LogicalType.BIGINT,) * 2, join_type="inner", m=int(run_max))
    want = dist_join.broadcast_probe(make_mesh(2, devices=["cpu"] * 2), *args, **kw)
    assert int(run_max) == 2 and int(torch.cat(want[1]).sum()) == 8
    for mesh, reason in (
        (Mesh(["cpu"] * 2, group=object()), "process-group mesh"),
        (Mesh(["cpu", "cpu:0"]), "shards on more than one device"),
    ):
        programs.reset_stats()
        dist_join.reset_stats()
        with programs.checking() as c:
            got = dist_join.broadcast_probe(mesh, *args, **kw)
        assert c.programs == 0 and not c.refused
        assert c.eager_routed == {reason: 1} == programs.stats.eager_routed
        assert dist_join.stats().probe_eager == {reason: 1}
        assert repr(got) == repr(want)
    programs.reset_stats()


def test_two_meshes_never_share_a_signature():
    """The same stage on the same tensors over two meshes that differ only
    in size and offset: two signatures. And meshes of 2 and 4 shards."""
    keys = [torch.arange(8) % 3, torch.arange(8) % 5]
    vals = [torch.arange(8), torch.arange(8) + 1]
    ok = [torch.ones(8, dtype=torch.bool)] * 2
    m2 = make_mesh(2, devices=["cpu"] * 2)
    m2_of_4 = Mesh(["cpu"] * 2, rank=1, n_proc=2)  # shards 2, 3 of 4 (no group)
    m4 = make_mesh(4, devices=["cpu"] * 4)
    with programs.checking() as c:
        dist_join.pair_local_dedup(m2, keys, vals, ok)
        dist_join.pair_local_dedup(m2_of_4, keys, vals, ok)
        dist_join.pair_local_dedup(m4, keys * 2, vals * 2, ok * 2)
    assert len(c.keys) == 3
    assert {k[1][:4] for k in c.keys} == {("mesh", 2, 2, 0), ("mesh", 4, 2, 2), ("mesh", 4, 4, 0)}
    assert programs.mesh_key(m2) != programs.mesh_key(m4)
