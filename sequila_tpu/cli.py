"""sequila-tpu CLI — SQL files or interactive REPL.

Role-equivalent of the reference's sequila-cli (reference
sequila/sequila-cli/src/main.rs): `--file` executes ;-separated SQL
scripts in order, no flag drops into a REPL.  The session is created with
the engine defaults the reference CLI pins (`with_repartition_joins(false)`
analog: single-partition planning is our default).
"""

from __future__ import annotations

import argparse
import sys
import time

from sequila_tpu.config import SequilaConfig
from sequila_tpu.errors import SequilaError
from sequila_tpu.models.table import pretty_format
from sequila_tpu.session import SessionContext


def execute_text(ctx: SessionContext, text: str, out=sys.stdout) -> None:
    t0 = time.perf_counter()
    result = ctx.sql(text)
    dt = time.perf_counter() - t0
    if result is not None:
        print(pretty_format(result), file=out)
        print(
            f"{result.num_rows} row(s) in set. Query took {dt:.3f} seconds.",
            file=out,
        )


def exec_from_files(ctx: SessionContext, files: list[str]) -> int:
    for path in files:
        with open(path) as f:
            text = f.read()
        try:
            execute_text(ctx, text)
        except SequilaError as e:
            print(f"Error in {path}: {e}", file=sys.stderr)
            return 1
    return 0


def exec_from_repl(ctx: SessionContext) -> int:
    print(f"sequila-tpu SQL REPL (devices: {_device_summary()})")
    print("Type SQL terminated by ';', or 'quit;' to exit.")
    buf = ""
    while True:
        try:
            prompt = "sequila> " if not buf else "    ...> "
            line = input(prompt)
        except EOFError:
            print()
            return 0
        except KeyboardInterrupt:
            buf = ""
            print()
            continue
        if not buf and line.strip().lower() in ("quit", "exit", "\\q"):
            return 0
        buf += line + "\n"
        if ";" not in line:
            continue
        text, buf = buf, ""
        if text.strip().rstrip(";").lower() in ("quit", "exit", "\\q"):
            return 0
        try:
            execute_text(ctx, text)
        except SequilaError as e:
            print(f"Error: {e}", file=sys.stderr)
        except Exception as e:  # REPL must survive
            print(f"Internal error: {type(e).__name__}: {e}", file=sys.stderr)


def _device_summary() -> str:
    try:
        import jax

        return ", ".join(str(d) for d in jax.devices())
    except Exception as e:
        return f"unavailable ({e})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="sequila-tpu",
        description="GPU-accelerated genomic interval query engine",
    )
    ap.add_argument(
        "-f", "--file", nargs="+", default=None,
        help="SQL file(s) to execute in order",
    )
    ap.add_argument(
        "-c", "--command", default=None, help="SQL string to execute"
    )
    args = ap.parse_args(argv)

    ctx = SessionContext(SequilaConfig())
    if args.command:
        try:
            execute_text(ctx, args.command)
            return 0
        except SequilaError as e:
            print(f"Error: {e}", file=sys.stderr)
            return 1
    if args.file:
        return exec_from_files(ctx, args.file)
    return exec_from_repl(ctx)


if __name__ == "__main__":
    sys.exit(main())
