"""The harness on the CPU, at SF 0.01: the port's answers pass the
comparison (validation parameters, and three qgen seeds); each fault the
cells can have, planted under the timed path, turns `correct` false; a
cell, a mix, a metric, and a configuration with its own layout and
dataset, added as files, are picked up by name; without a card, without
the program, or with the JAX package loaded by anything the run loads, a
run prints no result.

The look for a card is skipped (`device="cpu"`); everything else of a run
is the one the card runs.
"""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from perfbench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SF = 0.01


def with_adhoc_cell(root):
    """A copy of the benchmark with the ad-hoc mix as a cell on tpch-sf1 (a
    cell PERF.md keeps for later; its traffic and the generator are here)."""
    _copy_benchmark(root)
    bench = json.load(open(root / "BENCHMARK.json"))
    bench["workloads"].append({"name": "tpch-sf1.adhoc", "config": "tpch-sf1",
                               "traffic": "adhoc", "chips": 1, "why": "a test"})
    json.dump(bench, open(root / "BENCHMARK.json", "w"))
    return str(root)


@pytest.fixture(scope="module")
def adhoc_root(tmp_path_factory):
    return with_adhoc_cell(tmp_path_factory.mktemp("adhoc"))


def run(workload, seed=2**31 + 21, root=ROOT, trace=False, seconds=0.5):
    logs = []
    out = harness.run_cell(root, workload, seed, seconds, trace, device="cpu",
                           scale_factor=SF, log=logs.append)
    return out, logs


def test_validation_parameters_pass():
    out, _ = run("tpch-sf1.reports", trace=True)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 22
    assert out["checks"]["checked"]["value"] >= 22
    assert list(out)[-1] == "checks"
    # the traced run reads the layers a CPU run can read
    assert {"storage.load_s", "frontend.prepare_ms", "ops.host_self_ms"} <= set(out["metrics"])


@pytest.mark.parametrize("seed", [1, 2**31 + 3, 987654321])
def test_qgen_streams_pass(adhoc_root, seed):
    out, _ = run("tpch-sf1.adhoc", seed=seed, root=adhoc_root)
    assert out["correct"], out["checks"]
    assert {"pass_ms", "power_qph", "setup_s"} <= set(out["metrics"])


def test_sharded_engine_passes():
    out, _ = run("tpch-sf1-4shard.reports", trace=True)
    assert out["correct"], out["checks"]
    assert "dist.host_self_ms" in out["metrics"]


def _alter(batches):
    """The first row's first number moved by one part in a million."""
    for b in batches:
        for c in b.columns:
            if c.data.dtype.is_floating_point or c.data.dtype == torch.int64:
                if len(c.data) and c.data.dtype.is_floating_point:
                    c.data = c.data.clone()
                    c.data[0] = c.data[0] * (1 + 1e-6) + 1e-6
                    return batches
                if len(c.data):
                    c.data = c.data.clone()
                    c.data[0] += 1
                    return batches
    return batches


def _half(batches):
    """Half of each result's rows left out."""
    return [b.slice(0, b.num_rows // 2) if b.num_rows > 1 else b for b in batches]


@pytest.mark.parametrize("fault", ["answer_altered", "half_left_out"])
def test_a_fault_under_the_timed_path_fails(monkeypatch, fault):
    from sqlrs_tpu_torch.session import database

    inner = database.Database._run_statement
    change = _alter if fault == "answer_altered" else _half

    def faulty(self, stmt):
        return change(inner(self, stmt))

    monkeypatch.setattr(database.Database, "_run_statement", faulty)
    out, _ = run("tpch-sf1.reports")
    assert not out["correct"]


def test_exchange_left_out_fails(monkeypatch):
    """The shards' exchanges deliver only what a shard sends itself."""
    from sqlrs_tpu_torch.parallel import collectives

    def all_to_all(mesh, send):
        n = mesh.size
        return [torch.stack([send[j][i] if j == i else torch.zeros_like(send[j][i])
                             for j in range(n)]) for i in range(n)]

    def all_gather(mesh, xs, tiled=False):
        join = torch.cat if tiled else torch.stack
        return [join([x if k == i else torch.zeros_like(x) for k, x in enumerate(xs)])
                for i in range(len(xs))]

    monkeypatch.setattr(collectives, "all_to_all", all_to_all)
    monkeypatch.setattr(collectives, "all_gather", all_gather)
    out, _ = run("tpch-sf1-4shard.reports")
    assert not out["correct"]


def test_stale_answers_fail(monkeypatch, adhoc_root):
    """Each query answered with its first answer, whatever its parameters."""
    first = {}
    inner = harness.execute

    def stale(db, ex):
        if ex.qn not in first:
            first[ex.qn] = inner(db, ex)
        return first[ex.qn]

    monkeypatch.setattr(harness, "execute", stale)
    out, _ = run("tpch-sf1.adhoc", root=adhoc_root)
    assert not out["correct"]


def _copy_benchmark(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    shutil.copytree(os.path.join(ROOT, "perfbench"), tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))


def test_a_cell_a_mix_and_a_metric_added_as_files(tmp_path):
    _copy_benchmark(tmp_path)
    bench = json.load(open(tmp_path / "BENCHMARK.json"))
    mix = json.load(open(tmp_path / "perfbench" / "traffic" / "reports.json"))
    mix["order"] = [6, 14, 1]
    json.dump(mix, open(tmp_path / "perfbench" / "traffic" / "three.json", "w"))
    (tmp_path / "perfbench" / "metrics" / "extra.executions.py").write_text(
        "def read(run):\n    return float(run.attempted)\n")
    bench["workloads"].append({"name": "tpch-sf1.three", "config": "tpch-sf1",
                               "traffic": "three", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "extra.executions", "unit": "executions",
                                "better": "higher", "bound": 0.25, "source": "host_clock",
                                "workloads": ["tpch-sf1.three"]})
    json.dump(bench, open(tmp_path / "BENCHMARK.json", "w"))
    out, _ = run("tpch-sf1.three", root=str(tmp_path))
    assert out["correct"]
    assert out["metrics"]["extra.executions"]["value"] == out["attempted"]
    assert out["attempted"] % 3 == 0


def test_no_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload",
                        "tpch-sf1.reports", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_without_the_program_no_result(tmp_path):
    _copy_benchmark(tmp_path)
    code = ("import sys; sys.path.insert(0, '.'); from perfbench import harness; "
            "print(harness.run_cell('.', 'tpch-sf1.reports', 1, 0.5, False, device='cpu', "
            "scale_factor=0.01))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300, env=env)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "sqlrs_tpu_torch" in p.stderr


def test_forbidden_modules_are_named(monkeypatch):
    assert harness.forbidden_modules() == [] or "jax" in sys.modules
    monkeypatch.setitem(sys.modules, "sqlrs_tpu", object())
    assert "sqlrs_tpu" in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "sqlrs_tpu_torch_x", object())
    assert harness.forbidden_modules().count("sqlrs_tpu") == 1


def test_a_module_of_the_jax_package_loaded_by_a_reader_prints_no_result(tmp_path):
    """A metric's reader that imports `sqlrs_tpu` (a stub here) after the
    window: the run ends without a result and names it."""
    _copy_benchmark(tmp_path)
    (tmp_path / "sqlrs_tpu").mkdir()
    (tmp_path / "sqlrs_tpu" / "__init__.py").write_text("")
    (tmp_path / "perfbench" / "metrics" / "extra.loads.py").write_text(
        "def read(run):\n    import sqlrs_tpu  # noqa: F401\n    return 1.0\n")
    bench = json.load(open(tmp_path / "BENCHMARK.json"))
    bench["end_to_end"].append({"name": "extra.loads", "unit": "x", "better": "lower",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["tpch-sf1.reports"]})
    json.dump(bench, open(tmp_path / "BENCHMARK.json", "w"))
    code = ("import sys; from perfbench import run; sys.exit(run.main(['--workload', "
            "'tpch-sf1.reports', '--seed', '5', '--seconds', '0.5', '--trace', '0'], "
            "device='cpu', scale_factor=0.01))")
    env = dict(os.environ, PYTHONPATH=ROOT)
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                       text=True, timeout=600, env=env)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "sqlrs_tpu" in p.stderr and "check rel_gap" in p.stderr  # judged, then refused


TOY_GENERATOR = """
import numpy as np


def gen_tables(sf, seed=0):
    rng = np.random.default_rng([seed, 1])
    n = max(int(20_000 * sf), 50)
    return {"t": {"k": np.arange(n, dtype=np.int64),
                  "g": rng.choice(np.array(["a", "b", "c"]), n),
                  "d": rng.integers(9131, 9131 + 730, n).astype(np.int64),
                  "v": rng.integers(0, 10_000, n) / 100}}
"""

TOY_QUERIES = """
TEXTS = {1: "select g, count(*) as n, sum(v) as s from t where d < date '{DATE}' "
            "group by g order by g",
         2: "select k, v from t where k < {K} order by k"}
ORDER_KEYS = {1: (0,), 2: (0,)}


def derive(q, raw, sf):
    return {k: str(v) for k, v in raw.items()}


def statements(q, fields):
    return [TEXTS[q].format(**fields)]
"""

TOY_REFERENCE = """
import numpy as np


def with_float(tables, dtype):
    return {t: {c: a.astype(dtype) if a.dtype == np.float64 else a for c, a in cols.items()}
            for t, cols in tables.items()}


def oracle(q, tables, f):
    t = tables["t"]
    if q == 1:
        m = t["d"] < (np.datetime64(f["DATE"], "D") - np.datetime64("1970-01-01", "D")).astype(int)
        return [(g, int(((t["g"] == g) & m).sum()), float(t["v"][(t["g"] == g) & m].sum()))
                for g in sorted(set(t["g"][m]))]
    m = t["k"] < int(f["K"])
    return [(int(k), float(v)) for k, v in zip(t["k"][m], t["v"][m])]
"""


def test_a_configuration_with_its_own_layout_and_dataset_added_as_files(tmp_path, monkeypatch):
    """Another dataset (generator, queries, reference), a 2-shard layout,
    its mix and a cell: files and entries only, run by name."""
    _copy_benchmark(tmp_path)
    toy = tmp_path / "perfbench" / "toy"
    toy.mkdir()
    for name, text in (("gen", TOY_GENERATOR), ("queries", TOY_QUERIES),
                       ("reference", TOY_REFERENCE)):
        (toy / f"{name}.py").write_text(text)
    config = {"name": "toy-2shard", "scale_factor": 1.0,
              "engine": {"kind": "mesh", "cards": [0, 1]},
              "dataset": {"generator": "perfbench/toy/gen.py",
                          "queries": "perfbench/toy/queries.py",
                          "reference": "perfbench/toy/reference.py"},
              "column_types": {"DATE": ["d"]},
              "check_limits": {"failed": 0, "mismatched": 0, "rel_gap": 1e-9}}
    json.dump(config, open(tmp_path / "perfbench" / "configs" / "toy-2shard.json", "w"))
    mix = {"order": [1, 2], "shuffle": False, "check_share": 1.0,
           "parameters": {"1": {"DATE": {"day": ["1995-01-01", "1995-12-31"]}},
                          "2": {"K": {"int": [10, 40]}}}}
    json.dump(mix, open(tmp_path / "perfbench" / "traffic" / "toy.json", "w"))
    bench = json.load(open(tmp_path / "BENCHMARK.json"))
    bench["configs"].append({"name": "toy-2shard", "source": "a test",
                             "file": "perfbench/configs/toy-2shard.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "toy-2shard.toy", "config": "toy-2shard",
                               "traffic": "toy", "chips": 4, "why": "a test"})
    json.dump(bench, open(tmp_path / "BENCHMARK.json", "w"))

    assert harness.engine_devices(config, "cuda") == ["cuda:0", "cuda:1"]
    built = []
    inner = harness.make_database

    def recorded(cfg, devices):
        db = inner(cfg, devices)
        built.append(db.mesh.size)
        return db

    monkeypatch.setattr(harness, "make_database", recorded)
    out, logs = run("toy-2shard.toy", root=str(tmp_path))
    assert out["correct"], out["checks"]
    assert built == [2]
    assert out["checks"]["checked"]["value"] == out["attempted"] >= 2
    # and the same configuration with an answer altered is not correct
    monkeypatch.setattr(harness, "execute", lambda db, ex: _alter_all(inner_execute(db, ex)))
    out, _ = run("toy-2shard.toy", root=str(tmp_path))
    assert not out["correct"]


inner_execute = harness.execute


def _alter_all(outs):
    return [_alter(batches) for batches in outs]
