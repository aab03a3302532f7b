"""Interactive REPL.

The port of sqlrs_tpu/cli.py (parity with the reference CLI, reference
src/cli.rs:13-167): prompt loop with history, `\\`-commands (\\load csv,
\\dt, \\explain on/off), per-statement wall-clock timing, and errors that
abort only the current statement.

Run: python -m sqlrs_tpu_torch.cli [--device cuda|cpu] [--csv-dir DIR]
[--devices N] [-c SQL]. The session runs on the current CUDA device unless
--device names another.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import time

from sqlrs_tpu_torch.errors import SqlrsError
from sqlrs_tpu_torch.session.database import Database
from sqlrs_tpu_torch.utils.render import batch_to_rows, pretty_table

HISTORY_FILE = os.path.expanduser("~/.cache/sqlrs_tpu_torch_history")
PROMPT = "sqlrs_tpu=# "

HELP = """\\q               quit
\\dt              list tables
\\load csv <path> [name]   load a csv file as a table
\\explain on|off  toggle plan printing before execution
\\?               this help"""


class Cli:
    def __init__(self, db: Database, enable_v2: bool | None = None) -> None:
        self.db = db
        self.show_explain = False
        # engine-personality toggle (reference src/cli.rs:17-31): the
        # ENABLE_V2 env var presets it, and typing `enable_v2` flips it for
        # the rest of the session. v2 routes statements through
        # ClientContext.query (the v2 session API: prepare -> pending ->
        # execute); v1 uses Database.run directly. One engine implements
        # the union, so results are identical; the toggle exercises the v2
        # statement path exactly like the reference's.
        if enable_v2 is None:
            enable_v2 = os.environ.get("ENABLE_V2", "0") == "1"
        self.enable_v2 = enable_v2
        self._context = None

    @property
    def context(self):
        if self._context is None:
            from sqlrs_tpu_torch.session.client_context import ClientContext

            self._context = ClientContext(self.db)
        return self._context

    def run_command(self, line: str) -> bool:
        """Handle a backslash command; returns False to exit."""
        parts = line.split()
        cmd = parts[0]
        if cmd in ("\\q", "\\quit"):
            return False
        if cmd == "\\?":
            print(HELP)
        elif cmd == "\\dt":
            self.run_sql("show tables")
        elif cmd == "\\load" and len(parts) >= 3 and parts[1] == "csv":
            path = parts[2]
            name = parts[3] if len(parts) > 3 else os.path.splitext(
                os.path.basename(path)
            )[0]
            self.db.create_csv_table(name, path)
            print(f"loaded {path!r} as table {name}")
        elif cmd == "\\explain":
            self.show_explain = len(parts) > 1 and parts[1] == "on"
            print(f"explain {'on' if self.show_explain else 'off'}")
        else:
            print(f"unknown command {line!r}; \\? for help")
        return True

    def run_sql(self, sql: str) -> None:
        t0 = time.time()
        if sql.strip().lower().startswith("enable_v2"):
            self.enable_v2 = True
            print("---- enable sqlrs v2 ! ----")
            return
        if self.show_explain and sql.strip().lower().startswith("select"):
            print(self.db.explain(sql))
        if self.enable_v2:
            # query_all: multi-statement input runs every statement, like
            # the v1 branch below
            for result in self.context.query_all(sql):
                if result.names:
                    print(pretty_table(result.names, result.rows()))
        else:
            batches = self.db.run(sql)
            rows: list[list[str]] = []
            header: list[str] = []
            for b in batches:
                header = b.schema.names
                rows.extend(batch_to_rows(b))
            if header:
                print(pretty_table(header, rows))
        print(f"time consumed: {time.time() - t0:.4f}s")

    def interactive(self) -> None:
        try:
            import readline

            os.makedirs(os.path.dirname(HISTORY_FILE), exist_ok=True)
            if os.path.exists(HISTORY_FILE):
                readline.read_history_file(HISTORY_FILE)
        except Exception:
            readline = None
        print("sqlrs_tpu_torch — SQL engine on PyTorch. \\? for help, \\q to quit.")
        while True:
            try:
                line = input(PROMPT).strip()
            except (EOFError, KeyboardInterrupt):
                print()
                break
            if not line:
                continue
            if line.startswith("\\"):
                if not self.run_command(line):
                    break
                continue
            try:
                self.run_sql(line)
            except SqlrsError as e:
                print(f"error: {e}")
            except Exception as e:  # keep the REPL alive like the reference
                print(f"internal error: {type(e).__name__}: {e}")
        if readline is not None:
            try:
                readline.write_history_file(HISTORY_FILE)
            except Exception:
                pass


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="sqlrs_tpu_torch REPL")
    ap.add_argument(
        "--csv-dir",
        help="preload every *.csv in DIR as a table named by file stem "
        "(the reference slt harness behavior)",
    )
    ap.add_argument("-c", "--command", help="run one SQL string and exit")
    ap.add_argument(
        "--v2",
        action="store_true",
        help="start in the v2 engine personality (ClientContext.query path; "
        "same as ENABLE_V2=1 or typing `enable_v2` at the prompt)",
    )
    ap.add_argument(
        "--devices",
        type=int,
        default=None,
        help="distributed session: row-shard tables over an N-device mesh",
    )
    ap.add_argument(
        "--device",
        default="cuda",
        help="torch device of the session (default: the current CUDA device)",
    )
    args = ap.parse_args(argv)

    db = Database(n_devices=args.devices, device=args.device)
    if args.csv_dir:
        for p in sorted(glob.glob(os.path.join(args.csv_dir, "*.csv"))):
            db.create_csv_table(os.path.splitext(os.path.basename(p))[0], p)
            print(f"loaded table {os.path.splitext(os.path.basename(p))[0]}")
    cli = Cli(db, enable_v2=True if args.v2 else None)
    if args.command:
        try:
            cli.run_sql(args.command)
        except SqlrsError as e:
            print(f"error: {e}")
            sys.exit(1)
        return
    cli.interactive()


if __name__ == "__main__":
    main()
