"""python3 -m perfbench.run --workload NAME --seed N --seconds S --trace 0|1

One run of one cell of BENCHMARK.json on the CUDA card(s) of this machine.
The last line of standard output is the result object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
--trace 1 its per-layer metrics), `device`, with --trace 1 `breakdown`,
and last `checks`, each number the comparison read beside its limit (also
the last lines of standard error). Without the cards the cell asks for, or
if the process holds JAX or the JAX package once the window has closed, it
exits with a code other than 0 and prints no result.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None, device: str = "cuda", scale_factor: float | None = None) -> int:
    """`device` "cpu" and `scale_factor` are for the CPU tests."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every build and kernel cache of the program at a fixed place in the
    # checkout (the port builds its kernels into build/ by itself)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(ROOT, "build", sub)
    sys.path.insert(0, ROOT)
    from perfbench import harness

    try:
        out = harness.run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                               device=device, started=STARTED, scale_factor=scale_factor)
    except (harness.NoDevice, harness.ForbiddenModules) as e:
        print(f"perfbench: {e}", file=sys.stderr, flush=True)
        return 2
    sys.stdout.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
