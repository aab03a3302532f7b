"""The REPL (sqlrs_tpu_torch/cli.py) against the reference's
(sqlrs_tpu/cli.py): the same commands on the same data print the same
text, the `time consumed:` line aside. The port runs with --device cpu
here; its default device is the current CUDA device.
"""

import os
import re
import subprocess
import sys

import pytest

import sqlrs_tpu
import sqlrs_tpu_torch
from sqlrs_tpu.cli import Cli as RefCli
from sqlrs_tpu_torch import cli as port_cli
from sqlrs_tpu_torch.cli import Cli

SETUP = "create table t(a int, b int, s varchar); insert into t values (1,10,'x'),(2,20,null),(3,30,'zz')"
_TIMING = re.compile(r"^time consumed: [0-9.]+s$", re.M)


def _untimed(text: str) -> str:
    assert _TIMING.search(text) or "time consumed" not in text
    return _TIMING.sub("time consumed: <t>", text)


@pytest.fixture()
def db():
    d = sqlrs_tpu_torch.Database(device="cpu")
    d.run(SETUP)
    return d


@pytest.fixture()
def ref_db():
    d = sqlrs_tpu.Database()
    d.run(SETUP)
    return d


@pytest.fixture()
def csv_dir(tmp_path):
    (tmp_path / "people.csv").write_text(
        'id,name,score\n1,ann,1.5\n2,"b, o",\n3,cy,-2\n'
    )
    (tmp_path / "pets.csv").write_text("pid,owner\n7,1\n8,3\n")
    return tmp_path


def test_cli_engine_personality_toggle(db, capsys, monkeypatch):
    """tests/test_session.py's counterpart: typing `enable_v2` flips the
    session into the v2 personality (ClientContext.query); ENABLE_V2=1
    presets it. One engine: identical results either way."""
    monkeypatch.delenv("ENABLE_V2", raising=False)
    cli = Cli(db)
    assert cli.enable_v2 is False
    cli.run_sql("select a from t where a > 1")
    v1_out = capsys.readouterr().out
    assert "2" in v1_out and "3" in v1_out

    cli.run_sql("enable_v2")
    assert cli.enable_v2 is True
    assert "enable sqlrs v2" in capsys.readouterr().out

    cli.run_sql("select a from t where a > 1")
    v2_out = capsys.readouterr().out
    assert _untimed(v2_out) == _untimed(v1_out)
    assert cli._context is not None  # went through the prepared-statement path

    monkeypatch.setenv("ENABLE_V2", "1")
    assert Cli(db).enable_v2 is True


def _both(db, ref_db, capsys, steps, enable_v2=False):
    outs = []
    for cli in (Cli(db, enable_v2=enable_v2), RefCli(ref_db, enable_v2=enable_v2)):
        for kind, line in steps:
            if kind == "cmd":
                cli.run_command(line)
            else:
                cli.run_sql(line)
        outs.append(_untimed(capsys.readouterr().out))
    return outs


@pytest.mark.parametrize("enable_v2", [False, True], ids=["v1", "v2"])
@pytest.mark.parametrize(
    "steps",
    [
        [("cmd", "\\dt")],
        [("cmd", "\\?")],
        [("cmd", "\\explain on"), ("sql", "select a, s from t where b > 15"),
         ("cmd", "\\explain off"), ("sql", "select count(*) from t")],
        [("sql", "select a, b * 2, s from t order by a desc")],
        [("sql", "select s, sum(b) from t group by s")],
        [("sql", "insert into t values (4, 40, 'w'); select max(a) from t")],
        [("cmd", "\\bogus")],
    ],
    ids=["dt", "help", "explain", "select", "group", "multi", "unknown"],
)
def test_commands_print_the_reference_text(db, ref_db, capsys, steps, enable_v2):
    port_out, ref_out = _both(db, ref_db, capsys, steps, enable_v2)
    assert port_out == ref_out


def test_load_csv_command(db, ref_db, capsys, csv_dir):
    path = str(csv_dir / "people.csv")
    steps = [
        ("cmd", f"\\load csv {path}"),
        ("cmd", f"\\load csv {path} folks"),
        ("cmd", "\\dt"),
        ("sql", "select name, score from folks where id > 1"),
    ]
    port_out, ref_out = _both(db, ref_db, capsys, steps)
    assert port_out == ref_out
    assert "loaded" in port_out and "folks" in port_out


def test_main_runs_one_command(capsys, csv_dir):
    port_cli.main(["--device", "cpu", "--csv-dir", str(csv_dir), "-c",
                   "select p.name, q.pid from people p join pets q on p.id = q.owner"])
    out = _untimed(capsys.readouterr().out)
    assert out.splitlines()[:2] == ["loaded table people", "loaded table pets"]
    assert "| ann  | 7   |" in out and "| cy   | 8   |" in out


def test_main_statement_error_exits_1(capsys):
    with pytest.raises(SystemExit) as ex:
        port_cli.main(["--device", "cpu", "-c", "select * from missing_table"])
    assert ex.value.code == 1
    assert capsys.readouterr().out.startswith("error: ")


def test_main_v2_and_devices(capsys):
    port_cli.main(["--device", "cpu", "--v2", "--devices", "2", "-c", "select 1 + 1"])
    out = capsys.readouterr().out
    assert "| 2 " in out


def test_cli_matches_reference_process(csv_dir):
    """`python -m sqlrs_tpu_torch.cli --device cpu` prints the reference
    CLI's table text for the same data (timing line aside)."""
    sql = "select name, score from people order by id"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    outs = []
    for mod, extra in (("sqlrs_tpu_torch.cli", ["--device", "cpu"]), ("sqlrs_tpu.cli", [])):
        proc = subprocess.run(
            [sys.executable, "-m", mod, *extra, "--csv-dir", str(csv_dir), "-c", sql],
            capture_output=True, text=True, timeout=300, env=env,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        )
        assert proc.returncode == 0, proc.stderr[-2000:]
        outs.append(_untimed(proc.stdout))
    assert outs[0] == outs[1]
    assert "| b, o | NULL  |" in outs[0]


def test_default_device_is_cuda():
    """Without --device the session asks for CUDA: on a machine without
    it that is an error, never a quiet run on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(sqlrs_tpu_torch.ExecutorError, match="CUDA"):
        port_cli.main(["-c", "select 1"])
