"""The port's sharded engine over several processes (torch.distributed, gloo,
CPU shards): the counterpart of tests/test_multihost.py and mh_worker.py.

This file is also the worker script: `python tests/test_torch_multiprocess.py
MODE RANK N_PROC K INIT_URL OUT` joins the process group at INIT_URL (a
file:// rendezvous in the test's temporary directory, so parallel test
runs never share a port), builds the flat mesh of N_PROC x K CPU shards,
runs MODE and writes what it saw to OUT as JSON. The worker imports torch
and sqlrs_tpu_torch only. Modes:

  main: mh_worker.py's `kernels` mode (the broadcast, shuffle, salted and
    ring join + GROUP BY strategies and dist_sort, each against numpy
    exactly; a (2, 2) make_multihost_mesh and a sum over both axes; the SQL
    join + aggregate), a second initialize_distributed call (a no-op), the
    TPC-H statements below at SF 0.01 (seed 7), and a mesh whose processes
    list different shard counts (every process must raise).
  tpch: the TPC-H statements only.

The TPC-H statements are mh_worker.py's (Q3, the null-aware NOT IN, the
ORDER BY with ties) plus a float rollup, a DISTINCT aggregate (the
delegated path) and a LEFT JOIN with unmatched rows (ShardedBatch.parts).
Every process's lines must equal the port's single-controller run over as
many shards in one process, floats bit for bit (the collectives reduce in
shard order in every process), and the JAX engine's run over a 4-device
mesh by mh_worker._cells_match's rule. Every spawned process has its own
timeout and is killed when it expires.
"""

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TPCH_SF, TPCH_SEED = 0.01, 7
KERNEL_N, KERNEL_GROUPS = 512, 16
STATEMENTS = {
    # name: (SQL, the Database's sharded-engine knobs)
    "q3": (None, {}),  # TPC-H Q3 from the port's tpch_queries
    "not_in": ("select o_custkey from orders where o_custkey not in "
               "(select c_custkey from customer where c_acctbal < 0) "
               "order by o_custkey limit 20", {}),
    "order_ties": ("select l_orderkey, l_linenumber from lineitem "
                   "order by l_extendedprice desc, l_orderkey limit 15", {}),
    "float_rollup": ("select l_returnflag, l_linestatus, "
                     "sum(l_extendedprice * (1 - l_discount)), avg(l_quantity), sum(l_tax), "
                     "count(*) from lineitem group by l_returnflag, l_linestatus "
                     "order by l_returnflag, l_linestatus", {}),
    "distinct_agg": ("select o_orderpriority, count(distinct o_custkey), sum(o_totalprice) "
                     "from orders group by o_orderpriority order by o_orderpriority", {}),
    "left_join": ("select c_custkey, o_orderkey, o_totalprice from customer "
                  "left join orders on c_custkey = o_custkey where c_custkey <= 150", {}),
    # the exchange paths: a shuffle join with its probe exchange as ring
    # hops, a salted shuffle (25 nation keys are hot buckets), the fused
    # aggregate-over-join through the ring and through one all_gather
    "q3_shuffle_ring_hops": (None, {"dist_join_policy": "shuffle",
                                    "dist_exchange_ring": True}),
    "salted_join": ("select c_custkey, n_name, c_acctbal from customer join nation "
                    "on c_nationkey = n_nationkey where c_custkey <= 40",
                    {"dist_join_policy": "shuffle", "dist_hot_min": 1}),
    "ring_rollup": ("select o_orderpriority, sum(l_quantity), min(l_extendedprice), count(*) "
                    "from orders join lineitem on o_orderkey = l_orderkey "
                    "group by o_orderpriority", {"dist_join_policy": "ring"}),
    "fused_rollup": ("select n_name, sum(c_acctbal), max(c_acctbal), count(*) "
                     "from nation join customer on n_nationkey = c_nationkey group by n_name",
                     {}),
    # `||` interns strings in the order a process meets its rows: under a
    # process group the GROUP BY over it runs on the collected rows in every
    # process, where one process runs it sharded (so its join strategies
    # differ from the single controller's; its lines do not)
    "concat_group": ("select c_mktsegment || n_name, count(*), sum(c_acctbal) "
                     "from customer join nation on c_nationkey = n_nationkey "
                     "where c_custkey % 7 = 3 group by c_mktsegment || n_name", {}),
}

# the statements whose operators take another path under a process group
# than in one process: their float sums add in another order, so they match
# the single controller by _cells_match's rule (and every process the others
# exactly), and their join strategies are not compared
BY_ROW = {"concat_group"}


def _sql(name: str) -> str:
    sql = STATEMENTS[name][0]
    if sql is None:
        from sqlrs_tpu_torch.benchmarks import tpch_queries

        return tpch_queries.ALL[3]
    return sql


def _kernel_inputs():
    """mh_worker.py's star: 512 zipf(1.3) fact rows into 16 dim keys."""
    import numpy as np

    rng = np.random.default_rng(0)
    dim_keys = np.arange(KERNEL_GROUPS, dtype=np.int64) * 7 + 3
    gid = np.minimum(rng.zipf(1.3, KERNEL_N), KERNEL_GROUPS).astype(np.int64) - 1
    return dim_keys[gid], rng.integers(0, 100, KERNEL_N).astype(np.int64), dim_keys


def run_statements(db, profile_q3: bool = False) -> dict:
    """Each statement's lines and logged join strategies; with profile_q3,
    also Q3's operator list (op, depth, rows_out) under the profile, whose
    sharded rows_out are collectives (every process must profile)."""
    out = {}
    for name, (_sql_text, knobs) in STATEMENTS.items():
        for key, value in knobs.items():
            setattr(db, key, value)
        db.last_join_strategies = []
        lines = db.run_lines(_sql(name))
        out[name] = {"lines": lines, "strategies": list(db.last_join_strategies)}
        for key in knobs:
            delattr(db, key)
    if profile_q3:
        db.profile_enabled = True
        db.run_lines(_sql("q3"))
        db.profile_enabled = False
        out["q3"]["profile"] = [[s.op, s.depth, s.rows_out] for s in db.last_profile.ops]
    return out


def load_tpch(db) -> None:
    from sqlrs_tpu_torch.benchmarks import tpch_dbgen

    tpch_dbgen.load_into(db, tpch_dbgen.gen_tables(TPCH_SF, seed=TPCH_SEED))


# ---- the worker ---------------------------------------------------------------


def _worker_kernels(mesh) -> dict:
    import torch

    from sqlrs_tpu_torch.parallel import collectives, dist_ops
    from sqlrs_tpu_torch.parallel.mesh import make_multihost_mesh, row_blocks

    fk_np, fv_np, dk_np = _kernel_inputs()
    fk, fv, dk = (torch.from_numpy(a) for a in (fk_np, fv_np, dk_np))
    g, n = KERNEL_GROUPS, KERNEL_N
    out = {}

    def put(name, sums, cnts):
        out[name] = {"sums": sums.tolist(), "counts": cnts.tolist()}

    put("broadcast", *dist_ops.dist_join_groupby_broadcast(mesh, fk, fv, dk, g))
    sums, cnts, ovf = dist_ops.dist_join_groupby_shuffle(mesh, fk, fv, dk, g, bucket_capacity=n)
    put("shuffle", sums, cnts)
    out["shuffle"]["overflow"] = int(ovf)
    sums, cnts, ovf = dist_ops.dist_join_groupby_salted(
        mesh, fk, fv, dk, g, bucket_capacity=n, hot_capacity=32)
    put("salted", sums, cnts)
    out["salted"]["overflow"] = int(ovf)
    put("ring", *dist_ops.dist_join_groupby_ring(mesh, fk, fv, dk, g))
    put("shuffle_checked", *dist_ops.dist_join_groupby_shuffle_checked(
        mesh, fk, fv, dk, g, bucket_capacity=8))
    put("salted_checked", *dist_ops.dist_join_groupby_salted_checked(
        mesh, fk, fv, dk, g, bucket_capacity=8, hot_capacity=2))

    ks, valid = dist_ops.dist_sort(mesh, row_blocks(mesh, fk), bucket_capacity=2 * n)
    ks_all = collectives.gather(mesh, ks, "cpu")
    out["dist_sort"] = ks_all[collectives.gather(mesh, valid, "cpu")].tolist()

    mh = make_multihost_mesh(devices=["cpu"] * mesh.n_local)
    blocks = row_blocks(mh, torch.ones(8))
    out["multihost"] = {
        "shape": mh.shape,
        "psum": [float(t) for t in collectives.psum(mh, [b.sum() for b in blocks])],
    }

    from sqlrs_tpu_torch import Database
    from sqlrs_tpu_torch.storage.memory import import_tables

    db = Database(mesh=mesh)
    import_tables(db, {
        "fact": [("k", "BIGINT", fk_np, None), ("v", "BIGINT", fv_np, None)],
        "dim": [("k", "BIGINT", dk_np, None)],
    })
    out["sql"] = db.run_lines(
        "select count(*), sum(v) from fact join dim on fact.k = dim.k where v >= 0")
    return out


def worker(argv) -> None:
    mode, rank, n_proc, k, init_url, out_path = argv
    rank, n_proc, k = int(rank), int(n_proc), int(k)
    import torch
    import torch.distributed as dist

    torch.set_num_threads(2)
    from sqlrs_tpu_torch import Database
    from sqlrs_tpu_torch.errors import ExecutorError
    from sqlrs_tpu_torch.parallel.mesh import initialize_distributed, make_mesh

    initialize_distributed(init_url, n_proc, rank, backend="gloo")
    group = dist.group.WORLD
    initialize_distributed()  # a no-op once the group is up
    res = {"rank": rank, "second_init_noop": dist.group.WORLD is group
           and dist.get_world_size() == n_proc and dist.get_rank() == rank}
    mesh = make_mesh(devices=["cpu"] * k)
    res["mesh"] = {"size": mesh.size, "n_local": mesh.n_local, "offset": mesh.offset}
    t0 = time.perf_counter()
    if mode == "main":
        res["kernels"] = _worker_kernels(mesh)
    db = Database(mesh=mesh)
    load_tpch(db)
    mesh.reset_stats()
    res["tpch"] = run_statements(db, profile_q3=True)
    res["bytes_crossed"] = mesh.stats["bytes"]
    if mode == "main":
        try:
            make_mesh(devices=["cpu"] * (1 + rank))
            res["mismatch"] = "no error"
        except ExecutorError as e:
            res["mismatch"] = str(e)
    res["seconds"] = time.perf_counter() - t0
    with open(out_path, "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


def jax_worker(argv) -> None:
    """The JAX engine's lines for each statement, on one device (n 0) or
    over an n-device CPU mesh, in a process of its own: the JAX package's
    compiled programs never meet another test's in one process."""
    n, out_path = int(argv[0]), argv[1]
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={max(n, 1)}"
    import jax

    jax.config.update("jax_platforms", "cpu")
    from benchmarks import tpch_dbgen as jax_dbgen
    from sqlrs_tpu import Database as JaxDatabase
    from sqlrs_tpu.parallel.mesh import make_mesh

    db = JaxDatabase() if n == 0 else JaxDatabase(mesh=make_mesh(n))
    jax_dbgen.load_into(db, jax_dbgen.gen_tables(TPCH_SF, seed=TPCH_SEED))
    lines = {name: v["lines"] for name, v in run_statements(db).items()}
    with open(out_path, "w") as f:
        json.dump(lines, f)


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    if sys.argv[1] == "jax":
        jax_worker(sys.argv[2:])
    else:
        worker(sys.argv[1:])
    sys.exit(0)


# ---- the tests ----------------------------------------------------------------

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def _start(argvs: list, outs: list, timeout: float):
    """Start one process of this file per argv; returns a function that
    waits for them (each under the one deadline, all killed when it
    passes) and returns their JSON outputs."""
    env = {key: v for key, v in os.environ.items()
           if key not in ("XLA_FLAGS", "JAX_PLATFORMS", "MASTER_ADDR", "MASTER_PORT",
                          "RANK", "WORLD_SIZE", "LOCAL_RANK")}
    procs = [
        subprocess.Popen([sys.executable, os.path.abspath(__file__), *argv],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                         env=env, cwd=REPO)
        for argv in argvs
    ]
    deadline = time.monotonic() + timeout

    def wait():
        logs = []
        for p in procs:
            try:
                log, _ = p.communicate(timeout=max(deadline - time.monotonic(), 1))
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                for q in procs:
                    q.communicate()
                raise
            logs.append(log)
        for argv, p, log in zip(argvs, procs, logs):
            assert p.returncode == 0, f"{argv[:2]} failed:\n{log[-4000:]}"
        results = []
        for path in outs:
            with open(path) as f:
                results.append(json.load(f))
        return results

    return wait


def _spawn(tmp, mode: str, n_proc: int, k: int, jax_devices, timeout: float):
    """n_proc workers of `mode` over k CPU shards each, on one file://
    rendezvous, and the JAX reference (jax_devices 0: one device; None:
    none); the returned function waits and returns (worker results, JAX
    lines or None)."""
    init_url = f"file://{tmp}/rendezvous"
    outs = [os.path.join(tmp, f"out_{mode}_{r}.json") for r in range(n_proc)]
    argvs = [[mode, str(r), str(n_proc), str(k), init_url, outs[r]] for r in range(n_proc)]
    if jax_devices is not None:
        outs.append(os.path.join(tmp, "out_jax.json"))
        argvs.append(["jax", str(jax_devices), outs[-1]])
    wait = _start(argvs, outs, timeout)

    def results():
        got = wait()
        return (got[:-1], got[-1]) if jax_devices is not None else (got, None)

    return results


def _cells_match(got_line: str, exp_line: str) -> bool:
    """mh_worker._cells_match: floats at rel 1e-9 or abs 1e-6, the rest
    exactly."""
    import math

    gs, es = got_line.split(), exp_line.split()
    if len(gs) != len(es):
        return False
    for g, e in zip(gs, es):
        if g == e:
            continue
        try:
            if math.isclose(float(g), float(e), rel_tol=1e-9, abs_tol=1e-6):
                continue
        except ValueError:
            pass
        return False
    return True


def _single_controller(n_shards: int) -> dict:
    """The single-controller run, on the workers' two intra-op threads (as
    `worker` sets them): with a thread for every core, these runs took
    about 5 s alone but past the children's deadline beside the other test
    workers' load, their parallel regions waiting on descheduled threads."""
    import torch

    import sqlrs_tpu_torch

    n_threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        db = sqlrs_tpu_torch.Database(device="cpu", n_devices=n_shards)
        load_tpch(db)
        return run_statements(db, profile_q3=True)
    finally:
        torch.set_num_threads(n_threads)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both layouts started at once: 2 processes x 2 CPU shards (mode
    main) with the JAX reference on one device, and 3 processes x 1 shard
    (mode tpch: ring hops and exchanges among three processes); the
    single-controller runs are made while they run."""
    wait2 = _spawn(str(tmp_path_factory.mktemp("mp2")), "main", 2, 2, 0, timeout=240)
    wait3 = _spawn(str(tmp_path_factory.mktemp("mp3")), "tpch", 3, 1, None, timeout=240)
    single4, single3 = _single_controller(4), _single_controller(3)
    results2, jax_lines = wait2()
    return (results2, single4, jax_lines), (wait3()[0], single3)


@pytest.fixture(scope="module")
def two_proc(runs):
    return runs[0]


@pytest.fixture(scope="module")
def three_proc(runs):
    return runs[1]


def test_mesh_layout_and_second_initialize(two_proc):
    results, _single, _jax = two_proc
    for r, res in enumerate(results):
        assert res["second_init_noop"], r
        assert res["mesh"] == {"size": 4, "n_local": 2, "offset": 2 * r}


def test_mismatched_local_shard_counts_raise(two_proc):
    """Process 0 lists 1 shard, process 1 lists 2: both raise, neither hangs."""
    results, _single, _jax = two_proc
    for res in results:
        assert "every process must hold as many shards" in res["mismatch"], res["mismatch"]


@pytest.mark.parametrize(
    "strategy", ["broadcast", "shuffle", "salted", "ring", "shuffle_checked", "salted_checked"])
def test_join_groupby_strategies_exact(two_proc, strategy):
    """Each strategy's replicated (sums, counts) equal numpy's in both
    processes (the unchecked ones with capacity for every row: no overflow;
    the checked ones from capacities that overflow and retry)."""
    results, _single, _jax = two_proc
    fk, fv, dk = _kernel_inputs()
    gid = np.searchsorted(dk, fk)
    exp_s = np.bincount(gid, weights=fv, minlength=KERNEL_GROUPS).astype(np.int64)
    exp_c = np.bincount(gid, minlength=KERNEL_GROUPS).astype(np.int64)
    for res in results:
        got = res["kernels"][strategy]
        assert got["sums"] == exp_s.tolist() and got["counts"] == exp_c.tolist()
        assert got.get("overflow", 0) == 0


def test_dist_sort_across_processes(two_proc):
    results, _single, _jax = two_proc
    fk, _fv, _dk = _kernel_inputs()
    for res in results:
        assert res["kernels"]["dist_sort"] == np.sort(fk).tolist()


def test_multihost_mesh_sum_over_both_axes(two_proc):
    results, _single, _jax = two_proc
    for res in results:
        mh = res["kernels"]["multihost"]
        assert mh["shape"] == {"host": 2, "device": 2}
        assert mh["psum"] == [8.0, 8.0]


def test_sql_join_aggregate(two_proc):
    results, _single, _jax = two_proc
    _fk, fv, _dk = _kernel_inputs()
    for res in results:
        assert res["kernels"]["sql"] == [f"{KERNEL_N} {int(fv.sum())}"]


@pytest.mark.parametrize("name", list(STATEMENTS))
def test_every_process_equals_single_controller(two_proc, name):
    """Every process's lines equal the single-controller 4-shard run's,
    floats bit for bit, with the same join strategies (BY_ROW aside), and
    for Q3 the same profiled operator list; data crossed processes."""
    results, single, _jax = two_proc
    for res in results:
        got = res["tpch"][name]
        _assert_same_lines(res, got, single[name], name, results)
        assert got.get("profile") == single[name].get("profile"), (res["rank"], name)
        assert res["bytes_crossed"] > 0
    if name == "left_join":  # unmatched customers (a third have no orders) came as parts
        assert any(line.split()[1] == "NULL" for line in single[name]["lines"])


def _assert_cells_match(got: list, exp: list, name: str) -> None:
    assert len(got) == len(exp), (name, len(got), len(exp))
    for g, e in zip(got, exp):
        assert _cells_match(g, e), (name, g, e)


def _assert_same_lines(res: dict, got: dict, single: dict, name: str, results: list) -> None:
    """A process's statement against the single controller's: lines equal
    and the same join strategies, or for BY_ROW lines equal in every process
    and matching the single controller by _cells_match."""
    if name in BY_ROW:
        for other in results:
            assert got["lines"] == other["tpch"][name]["lines"], (res["rank"], name)
        _assert_cells_match(got["lines"], single["lines"], name)
        return
    assert got["lines"] == single["lines"], (res["rank"], name)
    assert got["strategies"] == single["strategies"], (res["rank"], name)


@pytest.mark.parametrize("name", list(STATEMENTS))
def test_three_processes_one_shard_each(three_proc, name):
    """3 processes x 1 shard: every process's lines and strategies equal
    the single-controller 3-shard run's exactly (BY_ROW aside)."""
    results, single = three_proc
    for res in results:
        assert res["mesh"] == {"size": 3, "n_local": 1, "offset": res["rank"]}
        got = res["tpch"][name]
        _assert_same_lines(res, got, single[name], name, results)


@pytest.mark.parametrize("name", list(STATEMENTS))
def test_statements_equal_jax_engine(two_proc, name):
    """The SF 0.01 statements against the JAX engine (one device), row for
    row by mh_worker._cells_match's rule."""
    results, _single, jax_lines = two_proc
    for res in results:
        _assert_cells_match(res["tpch"][name]["lines"], jax_lines[name], name)


@pytest.mark.slow
def test_four_process_tpch(tmp_path):
    """4 processes x 2 shards (8 in all), the TPC-H statements: every
    process equal to the single-controller 8-shard run exactly (BY_ROW by
    _cells_match) and to the
    JAX engine over a 4-device mesh by _cells_match (test_multihost.py's
    test_four_process_tpch; the JAX mesh compiles for many minutes)."""
    wait = _spawn(str(tmp_path), "tpch", 4, 2, 4, timeout=3000)
    single = _single_controller(8)
    results, jax_mesh = wait()
    for res in results:
        for name in STATEMENTS:
            got = res["tpch"][name]["lines"]
            if name in BY_ROW:
                assert got == results[0]["tpch"][name]["lines"], (res["rank"], name)
                _assert_cells_match(got, single[name]["lines"], name)
            else:
                assert got == single[name]["lines"], (res["rank"], name)
            _assert_cells_match(got, jax_mesh[name], name)
