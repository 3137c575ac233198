"""One rank of a ring-attention world, started once per rank.

    python3 -m daft_tpu_torch.tools.ring_world INPUTS OUT_DIR STORE RANK WORLD \
        [--backend gloo] [--device cpu] [--timeout 120]

Joins a world of WORLD ranks through a ``FileStore`` at the path STORE (no
port is opened for the rendezvous), then, for each case in the ``.npz``
INPUTS (arrays named ``CASE/q``, ``CASE/k``, ``CASE/v``, each ``[B, T, D]``,
the same on every rank), runs ``sequence_parallel_attention`` on the whole
tensors and ``ring_attention`` on this rank's shards, on ``--device``
(``cuda`` is ``cuda:0`` on every rank: the ranks share one card). It writes
``OUT_DIR/CASE.rankRANK.npz`` holding ``whole`` (the gathered
``[B, T, D]``), ``local`` (this rank's ``[B, T/WORLD, D]``),
``seconds`` (the wall of each call, synchronised on CUDA) and ``launches``
(the flash-attention kernel's launches on the rank, which the ring makes
none of). Exits non-zero
when a call raises, a peer included. ``launch`` starts the ranks and reads
their results back.
"""

from __future__ import annotations

import argparse
import datetime
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np


def launch(cases: Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray]], world: int,
           workdir, backend: str = "gloo", device: str = "cpu",
           timeout: float = 120.0) -> Dict[str, List[dict]]:
    """Run every case in a fresh world of ``world`` ranks, one process each,
    all started together; returns, per case, each rank's ``whole``,
    ``local`` and ``seconds``. Raises naming the ranks that failed, with
    their stderr, after stopping every rank still running."""
    workdir = Path(workdir)
    inputs = workdir / "inputs.npz"
    np.savez(inputs, **{f"{case}/{n}": a for case, qkv in cases.items()
                        for n, a in zip("qkv", qkv)})
    store = workdir / "store"
    env = dict(os.environ)
    root = str(Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "daft_tpu_torch.tools.ring_world", str(inputs), str(workdir),
         str(store), str(r), str(world), "--backend", backend, "--device", device,
         "--timeout", str(timeout)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    errors = []
    try:
        for r, p in enumerate(procs):
            _, err = p.communicate(timeout=timeout + 60)
            if p.returncode != 0:
                errors.append(f"rank {r} exited {p.returncode}: {err[-2000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if errors:
        raise RuntimeError("ring world failed: " + " | ".join(errors))
    return {case: [dict(np.load(workdir / f"{case}.rank{r}.npz")) for r in range(world)]
            for case in cases}


def main(argv: list) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("inputs")
    ap.add_argument("out_dir")
    ap.add_argument("store")
    ap.add_argument("rank", type=int)
    ap.add_argument("world", type=int)
    ap.add_argument("--backend", default="gloo")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--timeout", type=float, default=120.0)
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from daft_tpu_torch.ops.flash_attention import flash_attention
    from daft_tpu_torch.ops.ring_attention import ring_attention, sequence_parallel_attention

    device = torch.device(args.device)
    store = dist.FileStore(args.store, args.world)
    dist.init_process_group(args.backend, store=store, rank=args.rank, world_size=args.world,
                            timeout=datetime.timedelta(seconds=args.timeout))
    try:
        data = np.load(args.inputs)
        cases = sorted({key.split("/")[0] for key in data.files})
        for case in cases:
            q, k, v = (torch.from_numpy(data[f"{case}/{n}"]).to(device) for n in "qkv")
            t = q.shape[1] // args.world
            lo, hi = args.rank * t, (args.rank + 1) * t
            walls = []

            def timed(fn, *xs):
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                t0 = time.perf_counter()
                out = fn(*xs)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                walls.append(time.perf_counter() - t0)
                return out

            whole = timed(sequence_parallel_attention, q, k, v)
            local = timed(ring_attention, q[:, lo:hi].contiguous(), k[:, lo:hi].contiguous(),
                          v[:, lo:hi].contiguous())
            np.savez(Path(args.out_dir) / f"{case}.rank{args.rank}.npz",
                     whole=whole.cpu().numpy(), local=local.cpu().numpy(),
                     seconds=np.asarray(walls), launches=flash_attention.launch_count)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
