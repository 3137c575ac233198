"""CLI entrypoint: ``python -m daft_tpu_torch <command>`` (port of
``daft_tpu/__main__.py``; reference: src/daft-cli).

``version`` prints the package's version. ``sql "<query>" --table
name=path`` runs a SQL query over parquet (or ``.csv``) tables and prints
its first rows; it runs on the card unless ``--device cpu`` is given.
``dashboard`` raises: the dashboard's web app is ROADMAP A.8.6
(``subscribers/dashboard.py::DashboardServer`` serves the front door's
routes).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="daft_tpu_torch", description="daft_tpu_torch CLI")
    sub = parser.add_subparsers(dest="command")

    dash = sub.add_parser("dashboard", help="launch the engine dashboard")
    dash.add_argument("--port", type=int, default=8238)

    sub.add_parser("version", help="print version")

    q = sub.add_parser("sql", help="run a SQL query against parquet/csv tables")
    q.add_argument("query")
    q.add_argument("--table", action="append", default=[],
                   help="name=path table binding (parquet dir/file, or a .csv)")
    q.add_argument("--device", default=None,
                   help="where the relational layer runs (default: the card, 'cuda')")

    args = parser.parse_args(argv)
    if args.command == "version":
        import daft_tpu_torch

        print(daft_tpu_torch.__version__)
        return 0
    if args.command == "dashboard":
        from daft_tpu_torch.errors import DaftNotImplementedError

        raise DaftNotImplementedError(
            "the dashboard's server is not ported to daft_tpu_torch yet: ROADMAP A.8.6")
    if args.command == "sql":
        import daft_tpu_torch

        bindings = {}
        for spec in args.table:
            name, path = spec.split("=", 1)
            bindings[name] = daft_tpu_torch.read_parquet(path) if not path.endswith(".csv") \
                else daft_tpu_torch.read_csv(path)
        overrides = {"device": args.device} if args.device else {}
        with daft_tpu_torch.execution_config_ctx(**overrides):
            df = daft_tpu_torch.sql(args.query, **bindings)
            print(df._materialize_preview(20))
        return 0
    parser.print_help()
    return 1


if __name__ == "__main__":
    sys.exit(main())
