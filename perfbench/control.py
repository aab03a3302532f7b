"""python3 -m perfbench.control --workload NAME --seeds N [N ...] [--passes P]

The comparison's control: the configuration's reference put in the
program's place, computed in float32 (the precision below the
configuration's float64 DOUBLE columns), and judged by the run's own
comparison (`harness.judge`, with the configuration's limits), which
computes the float64 reference itself. For each seed it makes the cell's
tables, draws `--passes` passes of the cell's traffic as a run's window
would, and prints `correct` and the numbers compared beside their limits:
`correct` has to come out false. It uses no card; the benchmark's runs
never run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control_reading(root: str, workload: str, seed: int, passes: int,
                    scale_factor: float | None = None, log=None) -> dict:
    from perfbench import harness
    from perfbench.traffic import qgen

    bench = harness.load_benchmark(root)
    cell, entry = harness.find_cell(bench, workload)
    with open(os.path.join(root, entry["file"])) as f:
        config = json.load(f)
    if scale_factor is not None:
        config = dict(config, scale_factor=scale_factor)
    sf = float(config["scale_factor"])
    data = harness.Dataset.load(root, config)
    tables = data.generator.gen_tables(sf, seed=seed)
    low = data.reference.with_float(tables, np.float32)
    stream = qgen.Stream(qgen.load_mix(root, cell["traffic"]), seed, sf, data.queries)
    checked, seen = [], set()
    for _ in range(passes):
        for ex in stream.next_pass():
            if ex.key not in seen:
                seen.add(ex.key)
                checked.append((ex, data.reference.oracle(ex.qn, low, ex.fields)))
    verdict = harness.judge(checked, tables, config, data, log or (lambda msg: None))
    return {"seed": seed, "executions": len(checked), "correct": verdict["correct"],
            "checks": verdict["checks"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--passes", type=int, default=1)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = control_reading(ROOT, args.workload, seed, args.passes,
                            log=lambda msg: print(msg, file=sys.stderr, flush=True))
        r["seconds"] = time.perf_counter() - t0
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
