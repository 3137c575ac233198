"""SQL entrypoints (port of ``daft_tpu/sql/sql.py``; reference:
daft/sql/sql.py + src/daft-sql).

The SQL frontend (``sql/parser.py`` + ``sql/planner.py``) lowers SQL text to a
LogicalPlanBuilder, mirroring the reference's sqlparser-rs → builder path.
The DataFrame it returns runs where the execution config says: on the card
by default, on the CPU under ``execution_config_ctx(device="cpu")``.
"""

from __future__ import annotations

from typing import Optional


def sql(query: str, **bindings):
    """Run a SQL query against DataFrames bound by name.

    DataFrames are resolved from ``bindings`` kwargs first, then from the
    caller's local/global scope (reference: daft.sql catalog resolution).
    """
    import inspect

    from daft_tpu_torch.dataframe.dataframe import DataFrame

    if not bindings:
        frame = inspect.currentframe().f_back
        bindings = {
            k: v for k, v in {**frame.f_globals, **frame.f_locals}.items()
            if isinstance(v, DataFrame)
        }
    from daft_tpu_torch.sql.planner import plan_sql

    return plan_sql(query, bindings)


def sql_expr(text: str):
    """Parse a scalar SQL expression into an Expression
    (reference: daft.sql_expr)."""
    from daft_tpu_torch.sql.parser import parse_expression

    return parse_expression(text)
