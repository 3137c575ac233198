"""A/B timing of flash-attention builds on one GPU, in one process.

    python3 -m daft_tpu_torch.tools.ab_attention NAME=CSRC_DIR[:NVCC_FLAGS] ... \
        [--timing-only NAME ...]

Each CSRC_DIR holds a ``flash_attention.cu`` with the C ABI of
``daft_tpu_torch/csrc/flash_attention.cu`` and the headers it includes. Each
build is compiled with the flags of ``ops/build.py`` plus its own NVCC_FLAGS
(one nvcc per build, all started together) and its ``ptxas -v`` registers and
spills are printed. Its bf16 output is held against ``flash_attention_plain``
on fused-qkv views at every head dim and at ragged and whole tiles (tolerance
3e-2; a build named by ``--timing-only`` is reported, not held). Then, at each
shape of ``TIMED``, every build is timed with CUDA events in the order first to
last, last to first, twice over, with SDPA on the same inputs in each round.
The line of a shape gives each build's least time and its ratio to SDPA's
least time in the same run: compare builds only within one run.

Exits non-zero with no CUDA device, or when a build fails or disagrees.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

BF16_TOL = 3e-2
CHECKED = [(2, T, 4, D) for D in (32, 64, 128) for T in (5, 257, 300, 1024)]
# CLIP ViT-L/14 and ViT-B/32 at 224x224 (whole and ragged last key tiles), a long sequence.
TIMED = [(128, 257, 16, 64), (512, 50, 12, 64), (32, 1024, 16, 64)]
ROUNDS = 2


def parse_build(arg: str) -> tuple:
    """``NAME=DIR[:FLAGS]`` -> (name, source file, extra nvcc flags)."""
    name, sep, rest = arg.partition("=")
    if not sep or not name or not rest:
        raise argparse.ArgumentTypeError(f"expected NAME=CSRC_DIR[:NVCC_FLAGS], got {arg!r}")
    d, _, flags = rest.partition(":")
    return name, Path(d) / "flash_attention.cu", flags.split()


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compile_all(builds: list, out_dir: Path) -> dict:
    """Compiles every build at once; returns the loaded library of each that built."""
    from daft_tpu_torch.ops import build

    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src, flags in builds:
        out = out_dir / f"lib_{name}.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, *flags, "-o", str(out), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), out)
    libs = {}
    for name, (proc, out) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            print(f"[{name}] build failed (nvcc exit {proc.returncode}):\n{log}", flush=True)
            continue
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[{name}] {line.split(':', 1)[-1].strip()}", flush=True)
        libs[name] = ctypes.CDLL(str(out))
    return libs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("builds", nargs="+", type=parse_build)
    parser.add_argument("--timing-only", action="append", default=[], metavar="NAME")
    args = parser.parse_args(argv)

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("ab_attention: no CUDA device is visible", file=sys.stderr)
        return 2
    from daft_tpu_torch.ops import build
    from daft_tpu_torch.ops import flash_attention as fa

    libs = compile_all(args.builds, build.BUILD_DIR / "ab")
    ok = len(libs) == len(args.builds)

    def use(name):
        build._LIBS["flash_attention"] = libs[name]

    gen = torch.Generator(device="cuda").manual_seed(0)

    def fused_qkv(B, T, H, D):
        x = torch.randn((B, T, 3 * H * D), generator=gen, device="cuda").to(torch.bfloat16)
        return [t.view(B, T, H, D) for t in x.split(H * D, dim=-1)]

    for shape in CHECKED + TIMED:
        q, k, v = fused_qkv(*shape)
        ref = fa.flash_attention_plain(q, k, v).float()
        for name in libs:
            use(name)
            err = (fa.flash_attention(q, k, v).float() - ref).abs().max().item()
            held = name not in args.timing_only
            print(f"[{name}] B,T,H,D={shape}: max_abs_err {err:.3e}"
                  + ("" if held else " (timing only, not held)"), flush=True)
            ok &= err <= BF16_TOL or not held

    for B, T, H, D in TIMED:
        q, k, v = fused_qkv(B, T, H, D)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        times = {name: [] for name in libs}
        sdpa = []
        for _ in range(ROUNDS):
            for name in list(libs) + list(libs)[::-1]:
                use(name)
                times[name].append(time_ms(lambda: fa.flash_attention(q, k, v)))
            sdpa.append(time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt)))
        s = min(sdpa)
        print(f"B={B} T={T} H={H} D={D}: sdpa {s:.4f} ms, " + ", ".join(
            f"{n} {min(t):.4f} ms ({min(t) / s:.3f})" for n, t in times.items()), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
