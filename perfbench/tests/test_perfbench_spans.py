"""`python3 -m perfbench.spans` on the CPU, at SF 0.01: the cell runs as
`perfbench.run --trace 1` runs it, stays correct, and its last line adds
the spans reading: the eight values, set-up's spans, the cost of
recording and the trace file's span track. (The CPU has no CUDA records:
the clock check, its witness and the device's idle time are the card's
to read.)"""

import json

from perfbench import spans

METRICS = {"frontend.run_ms", "frontend.idle_ms", "ops.host_reads", "ops.host_read_ms",
           "ops.idle_ms", "programs.replay_host_ms", "programs.input_copy_device_ms",
           "storage.dictionary_s"}


def test_the_spans_reading_runs_a_cell(capsys, tmp_path):
    assert spans.main(["--workload", "tpch-sf1.reports", "--seed", str(2**31 + 77),
                       "--seconds", "0.5", "--out", str(tmp_path)],
                      device="cpu", scale_factor=0.01) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "reading"
    r = out["reading"]
    assert set(r["metrics"]) == METRICS
    assert r["metrics"]["frontend.run_ms"] > 0 and r["metrics"]["storage.dictionary_s"] > 0
    assert r["executions"] == 22 * r["passes"] and r["spans_a_pass"] > 22 * 5
    assert {"storage.import", "storage.first_scan", "strings.match_table",
            "strings.ranks"} <= set(r["setup_s_by_span"])
    assert len(r["cost"]["on_pass_ms"]) == len(r["cost"]["off_pass_ms"]) == 4
    assert r["trace_file"]["graph_launches"] == 0
    assert r["clock"]["witness"] is None
    with open(tmp_path / "spans_tpch-sf1.reports.json") as f:
        assert json.load(f)["reading"]["metrics"] == r["metrics"]
    assert (tmp_path / "spans_trace_tpch-sf1.reports" / "trace.json").exists()
