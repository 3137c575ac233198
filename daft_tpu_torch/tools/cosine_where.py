"""Time the cosine scan's ``where`` on the card: ``chip_smoke.py`` phase 7's
1M x 768 f32 embeddings (seed 8), ``with_column("d", cosine_distance)``
then ``where(d < 0.95)``, warm once and then timed ``--repeats`` times.

Prints one JSON line: the label, each timed wall in seconds, the rows kept,
the ``device_eval`` counters of the last run and the card's name and power
limit. The script touches the package only through its public surface, so it
also times another tree's package, which is how two trees are compared on
one card::

    PYTHONPATH=<tree> python daft_tpu_torch/tools/cosine_where.py --label <tree>
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--dim", type=int, default=768)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--label", default="")
    args = ap.parse_args()

    import torch

    import daft_tpu_torch as dt
    from daft_tpu_torch.ops import device_eval as de

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    rng = np.random.default_rng(8)
    emb = rng.standard_normal((args.rows, args.dim), dtype=np.float32)
    query = rng.standard_normal(args.dim, dtype=np.float32)
    dtype = dt.DataType.embedding(dt.DataType.float32(), args.dim)
    df = dt.from_pydict({
        "id": np.arange(args.rows, dtype=np.int64),
        "e": dt.Series.from_numpy(emb, "e", dtype),
        "q": dt.Series.from_numpy(np.broadcast_to(query, emb.shape), "q", dtype)})
    del emb
    dist = dt.col("e").embedding.cosine_distance(dt.col("q"))

    def run():
        t0 = time.perf_counter()
        kept = df.with_column("d", dist).where(dt.col("d") < 0.95).select("id", "d").to_pydict()
        torch.cuda.synchronize()
        return kept, time.perf_counter() - t0

    run()
    walls = []
    for _ in range(args.repeats):
        de.device_eval_counters.reset()
        kept, wall = run()
        walls.append(wall)
    snap = de.device_eval_counters.snapshot()
    print(json.dumps({"label": args.label, "where_s": walls, "kept": len(kept["id"]),
                      "fused_rows": snap["fused_rows"], "host_rows": snap["host_rows"],
                      "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
