"""What sets the engine-overhead watchdog's ratio on the CPU.

``tests/test_torch_engine_overhead.py`` times the tiny CLIP image tower's
``embed_image`` standalone and through ``UDFProject``. Three things are
measured here over ``n`` 32x32 images, the variants interleaved rep by rep:

1. **A second OpenMP team** (``teams``). PyTorch's CPU build runs its
   intra-op work on OpenMP (libgomp): each thread that enters a parallel
   region masters a team of its own, whose workers live as long as that
   thread. While the workers of all teams outnumber the CPUs, libgomp
   throttles them: they spin about 100 rounds at a barrier instead of
   300,000, then sleep, so each of a forward's many small parallel regions
   pays a futex wake. A forward runs slower on any thread while another
   thread's team is alive. Timed: on the main thread alone (``main_s``);
   on it while a parked thread holds a team (``main_second_team_s``); on it
   once that thread has ended (``main_after_s``); on a thread made for the
   call, the main thread's team alive (``fresh_thread_s``); the same with
   ``torch.set_num_threads`` called on that thread first
   (``fresh_thread_set_s``: a per-thread setting, which leaves the
   throttle).
2. **The spread of one forward's wall** (``spread``) at one intra-op
   thread per CPU and at ``--threads``, each on a thread made for the call:
   the min, median and max of ``reps`` walls.
3. **The engine's own time** (``engine``): the query's wall through
   ``read -> UDFProject(embed_image) -> collect`` at ``--threads``, less the
   provider's ``stage_s + fwd_fetch_s`` of the one ``embed_image`` call
   the query makes (``batch`` divides ``n``; the morsel is all ``n`` rows).

Run: ``python -m daft_tpu_torch.tools.cpu_watchdog [--n 12288] [--reps 5]
[--threads 2]``; it prints one JSON object. CPU only: these are host readings,
and they move with whatever else the host runs.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import threading
import time

import numpy as np
import torch


def _on_thread(fn, prepare=None):
    out = []

    def body():
        if prepare is not None:
            prepare()
        out.append(fn())

    t = threading.Thread(target=body)
    t.start()
    t.join()
    return out[0]


def _summary(walls) -> dict:
    return {"min_s": min(walls), "median_s": statistics.median(walls), "max_s": max(walls),
            "walls": walls}


def measure(n: int = 12288, batch: int = 1024, reps: int = 5, threads: int = 2) -> dict:
    import daft_tpu_torch
    from daft_tpu_torch import col
    from daft_tpu_torch.ai.cuda_provider import CUDACLIPImageEmbedder
    from daft_tpu_torch.datatype import DataType
    from daft_tpu_torch.functions.ai import embed_image

    imgs = np.random.default_rng(0).integers(0, 255, (n, 32, 32, 3), dtype=np.uint8)
    emb = CUDACLIPImageEmbedder("tiny", batch_size=batch, device="cpu")
    per_cpu = os.cpu_count() or 1

    def forward() -> float:
        t0 = time.perf_counter()
        emb.embed_image(imgs)
        return time.perf_counter() - t0

    # 1. teams, at one intra-op thread per CPU.
    torch.set_num_threads(per_cpu)
    forward()
    teams = {k: [] for k in ("main_s", "main_second_team_s", "main_after_s",
                             "fresh_thread_s", "fresh_thread_set_s")}
    for _ in range(reps):
        teams["main_s"].append(forward())
        release = threading.Event()

        def park():
            torch.ones(512, 512) @ torch.ones(512, 512)  # this thread's team
            release.wait()

        parked = threading.Thread(target=park)
        parked.start()
        time.sleep(0.2)
        teams["main_second_team_s"].append(forward())
        release.set()
        parked.join()
        teams["main_after_s"].append(forward())
        teams["fresh_thread_s"].append(_on_thread(forward))
        teams["fresh_thread_set_s"].append(
            _on_thread(forward, lambda: torch.set_num_threads(torch.get_num_threads())))

    # 2. spread, and 3. the engine's own time, at `threads`.
    series = daft_tpu_torch.Series.from_numpy(imgs.reshape(n, -1), "img",
                                              DataType.image("RGB", 32, 32))
    df = daft_tpu_torch.from_pydict({"img": series})
    expr = embed_image(col("img"), provider="cuda_random", model="tiny", batch_size=batch,
                       device="cpu")

    def engine() -> tuple:
        with daft_tpu_torch.execution_config_ctx(default_morsel_size=n):
            t0 = time.perf_counter()
            df.with_column("emb", expr).select("emb").collect()
            wall = time.perf_counter() - t0
        stats = expr._expr.udf._instances[0].last_forward_stats
        return wall, stats["stage_s"] + stats["fwd_fetch_s"]

    spread = {per_cpu: [], threads: []}
    eng = {"wall_s": [], "forward_s": [], "own_s": []}
    for k in spread:
        torch.set_num_threads(k)
        _on_thread(forward)
        for _ in range(reps):
            spread[k].append(_on_thread(forward))
    engine()
    for _ in range(reps):
        wall, fwd = engine()
        eng["wall_s"].append(wall)
        eng["forward_s"].append(fwd)
        eng["own_s"].append(wall - fwd)
    torch.set_num_threads(per_cpu)
    return {"n": n, "batch": batch, "reps": reps, "cpus": per_cpu, "threads": threads,
            "teams": {k: {"median_s": statistics.median(v), "walls": v}
                      for k, v in teams.items()},
            "spread": {f"threads_{k}": _summary(v) for k, v in spread.items()},
            "engine": {k: _summary(v) for k, v in eng.items()}}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=12288)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--threads", type=int, default=2)
    a = ap.parse_args(argv)
    print(json.dumps(measure(a.n, a.batch, a.reps, a.threads)))


if __name__ == "__main__":
    main()
