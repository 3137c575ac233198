"""Time TPC-H q03, q04, q05, q07-q10, q12-q14 and q19 in DataFrame form
(``tools/tpch.py``) over one seeded SF10 database, on the card, for
whichever tree ``PYTHONPATH`` names: each query once warm at 8 workers,
then timed, with the build rows of its joins in ``join_counters``' order.

    PYTHONPATH=<tree> python3 -m daft_tpu_torch.tools.tpch_frames [sf] [tag]

Prints one line per query and one JSON line of the walls. Two trees run one
after the other in one call compare their optimizers on the same card
(run order parent, change, change, parent).
"""

from __future__ import annotations

import json
import sys
import time

NAMES = ("q03", "q04", "q05", "q07", "q08", "q09", "q10", "q12", "q13", "q14", "q19")
WORKERS = 8


def _frames(dt, tpch, tables, name):
    if name in tpch.EXPR_QUERIES:
        return lambda: tpch.EXPR_QUERIES[name](dt, tpch.expr_frames(dt, tables, name))
    cols = tpch.Q03_COLUMNS if name == "q03" else tpch.Q04_COLUMNS
    f = {t: dt.from_pydict({c: tables[t][c] for c in cc}) for t, cc in cols.items()}
    if name == "q03":
        return lambda: tpch.q03(dt, f["customer"], f["orders"], f["lineitem"])
    return lambda: tpch.q04(dt, f["orders"], f["lineitem"])


def main(argv) -> int:
    import torch

    import daft_tpu_torch as dt
    from daft_tpu_torch.execution.join_index import join_counters
    from daft_tpu_torch.tools import tpch

    sf = float(argv[1]) if len(argv) > 1 else 10
    tag = argv[2] if len(argv) > 2 else dt.__file__
    tables = tpch.tpch_tables(sf, seed=0, expressions=True)
    walls = {}
    for name in NAMES:
        query = _frames(dt, tpch, tables, name)
        with dt.execution_config_ctx(num_compute_threads=WORKERS):
            query().to_pydict()  # warm
            join_counters.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            query().to_pydict()
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0
        builds = [j["build_rows"] for j in join_counters.snapshot()]
        print(f"[frames {tag}] {name}: {walls[name]:.3f} s at {WORKERS} workers, "
              f"build rows {builds}", flush=True)
    print(json.dumps({"tag": tag, "sf": sf, "walls_s": walls}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
