"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA GPU, nvcc and
PyTorch built for CUDA. Phases, each of which fails the run on any error:

1. print the card's name and power limit; build every kernel of
   ``daft_tpu_torch/csrc`` (one nvcc per source, started together);
2. hold each kernel against its plain PyTorch version on the card, at the
   stated tolerance and at every head dim it takes (bf16 on fused-qkv views
   and on separate tensors), and time kernel, plain version and the PyTorch
   library call for the same function at the main path's shape (CUDA events,
   after a warm-up) beside the least time the card could take;
3. drive the main path through the engine's entry points — 512 random uint8
   224x224 images, ``embed_image(provider="cuda_random", model="ViT-L/14",
   batch_size=128)``, ``iter_partitions`` — with every kernel's launch count set
   to 0 just before and read just after; check the row count, finite unit-norm
   embeddings, launches = 24 per forward chunk, that one chunk equals a direct
   forward of the tower, and that the tower with the kernel agrees with the
   tower on the CPU (plain attention) on two images;
4. put ``torch.profiler`` over one more chunk of the same path and print the
   ten device kernels with the most time, the time by kind (attention,
   matmul, LayerNorm, GELU, copies and casts, other) and the device's idle share over
   the window ("not measured" where the profiler records no device activity);
5. drive the text and zero-shot paths through the engine at full width, on
   seeded strings of 1-200 words from a fixed word list with a few empty
   ones: ``embed_text`` with MiniLM-L6 and with the CLIP ViT-L/14 text tower
   (4096 strings each), ``classify_image`` (ViT-L/14, 256 images, 10 labels)
   and ``classify_text`` (ViT-L/14, 4096 strings); each with every kernel's
   launch count set to 0 just before and read just after, rows/s, peak
   device memory and the phase split. It checks that each tower on the card
   agrees with the same tower on the CPU (cosine >= 0.99; 48 seeded non-empty
   strings per text tower), that the card received the token ids the host
   made, that MiniLM gives exact zero vectors for the empty strings and
   unit-norm finite rows for the rest, that the text paths launch no flash
   attention and ``classify_image`` 24 per chunk, and that each engine run
   equals a direct forward; for ``classify_image`` also that the image
   embeddings the engine's run made and their similarities to the labels
   equal a direct forward's, that those similarities agree with the CPU
   towers', and that reversing the label list names the same label per row;
6. drive generation through the engine at full width: ``prompt(provider=
   "cuda_random")`` with ``default-lm`` (vocab 32000, hidden 2048, 16 layers,
   16 heads) on 256 seeded strings, every fourth repeating the one before, 32
   new tokens at temperature 0, after a warm run of 16, with every launch
   count set to 0 just before and read just after; print prompts/s, tokens/s,
   the phase split, ms per decode step beside its byte bound and peak device
   memory beside the weights and KV cache, and trace 16 decode steps of a full
   8-slot pool with ``torch.profiler``. It checks that every response is at
   most 32 ids in [1, vocab), that identical prompts are answered alike with
   at least one prefix hit, that a second direct run on the same instance
   gives the same responses, that no flash attention is launched, and that
   the card's LM agrees with a CPU copy of its weights on 2 prompts (prefill
   logits and 8 teacher-forced decode steps, cosine >= 0.99 per position).
   Then one wave at the ``8b`` widths (vocab 128256, hidden 4096, 32 layers)
   straight through ``ContinuousBatcher``: 8 distinct prompts, 16 new tokens,
   with its peak memory and ms per decode step beside its bound;
7. print one JSON line of per-kernel numbers (with the launches on each
   path), then, last, the device line.

Exits non-zero, printing no result, when no CUDA device is visible.
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time

# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and bf16
# tensor-core / f32 CUDA-core operations/s.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}

NUM_IMAGES = 512
BATCH = 128
IMAGE = 224
VIT_L_LAYERS = 24
BF16_TOL = 3e-2   # bf16 inputs and output (tests/test_pallas.py's tolerance)
F32_TOL = 2e-5    # f32 throughout, TF32 off
CHUNK_TOL = 1e-5  # same weights, same kernels, same batch: only run-to-run noise
CPU_COSINE_MIN = 0.99  # GPU tower vs CPU tower in bf16: rounding differs per layer
CPU_SIM_TOL = 1e-2    # image-label cosines from the GPU towers vs the CPU towers
CPU_TEXT_SAMPLE = 48  # non-empty strings per text tower held against its CPU tower
BF16_PARITY_T = (5, 64, 257, 300, 1024)  # one short, whole, ragged and long sequences

NUM_PROMPTS = 256
WARM_PROMPTS = 16
MAX_NEW_TOKENS = 32
CPU_PROMPTS = 2       # prompts of the card's LM held against its CPU copy
TEACHER_STEPS = 8     # decode steps, fed the card's tokens, after their prefill
TRACE_STEPS = 16      # decode steps under torch.profiler
WAVE_8B_NEW_TOKENS = 16

NUM_TEXTS = 4096
NUM_CLASSIFY_IMAGES = 256
MAX_WORDS = 200
EMPTY_EVERY = 1000  # rows 0, 1000, 2000, ... are empty strings
LABELS = ["cat", "dog", "car", "airplane", "ship", "tree", "house", "flower", "horse", "bird"]
WORD_LIST = ("the a of and to in is was for on with as by at from it that this be are "
             "photo picture image small large red blue green black white old new bright "
             "dark quick slow cat dog car airplane ship tree house flower horse bird "
             "river mountain city street road field sky water light night day morning "
             "people person man woman child group walking running sitting standing "
             "near over under beside behind front inside outside big little").split()


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
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


def attention_bound_ms(B: int, T: int, H: int, D: int, dtype_name: str, itemsize: int):
    """The least time for one attention: q, k, v read once and o written
    once over the HBM rate, or 4*B*H*T^2*D operations over the peak rate."""
    bytes_moved = 4 * B * T * H * D * itemsize
    ops = 4 * B * H * T * T * D
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tower_flops(cfg) -> float:
    """Operations of one image through the CLIP image tower: the patchify,
    per layer the qkv/out/MLP products (2 * T * 12 * w^2 at mlp ratio 4) and
    attention (4 * T^2 * w), and ``proj``. Normalisation and elementwise work
    are left out."""
    w, p = cfg.vision_width, cfg.patch_size
    patches = (cfg.image_size // p) ** 2
    T, hidden = patches + 1, round(w * cfg.vision_mlp_ratio)
    per_layer = 2 * T * (4 * w * w + 2 * w * hidden) + 4 * T * T * w
    return 2 * patches * p * p * 3 * w + cfg.vision_layers * per_layer + 2 * w * cfg.embed_dim


def text_flops(width: int, layers: int, T: int, mlp_ratio: float = 4.0) -> float:
    """Operations of one text through a text tower at its padded length T
    (every position is computed): per layer the qkv/out/MLP products and
    attention (4 * T^2 * w). Embedding, normalisation, pooling and the
    projection are left out."""
    hidden = round(width * mlp_ratio)
    return layers * (2 * T * (4 * width * width + 2 * width * hidden) + 4 * T * T * width)


def kernel_name(ptxas_line: str) -> str:
    """``attn_bf16_tma_wgmma<64>`` from the mangled name in a ptxas line: the
    last identifier of the (nested) name and its integer template arguments.
    A name that is not mangled is returned as it stands."""
    m = re.search(r"'([^']+)'", ptxas_line)
    if m is None:
        return "?"
    name = m.group(1)
    if not name.startswith("_Z"):
        return name
    nested = name.startswith("_ZN")
    i, ident = (3 if nested else 2), None
    while i < len(name) and name[i].isdigit():
        n = re.match(r"\d+", name[i:]).group(0)
        i += len(n)
        ident, i = name[i:i + int(n)], i + int(n)
        if not nested:
            break
    if not ident:
        return "?"
    args = []
    if name.startswith("I", i):
        i += 1
        while (arg := re.match(r"L[a-z](n?\d+)E", name[i:])) is not None:
            args.append(arg.group(1).replace("n", "-"))
            i += arg.end()
    return f"{ident}<{', '.join(args)}>" if args else ident


def phase_build() -> None:
    from daft_tpu_torch.ops import build

    t0 = time.perf_counter()
    paths = build.build()
    print(f"[build] {len(paths)} kernel(s) in {time.perf_counter() - t0:.1f} s: "
          f"{sorted(paths)}", flush=True)
    for name, path in paths.items():
        # ptxas -v: one "Compiling entry function" line per kernel instance,
        # then its spills and its registers.
        fn = "?"
        for line in path.with_suffix(".log").read_text().splitlines():
            if "Compiling entry function" in line:
                fn = kernel_name(line)
            elif "registers" in line or "spill" in line:
                print(f"[build] {name} {fn}: {line.split(':', 1)[-1].strip()}", flush=True)


def phase_kernels(card: str) -> dict:
    """Flash attention against its plain version; returns the kernel's record."""
    import torch
    import torch.nn.functional as F

    from daft_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)

    def qkv(B, T, H, D, dtype, fused=True):
        if not fused:  # three separately allocated contiguous tensors
            return [torch.randn((B, T, H, D), generator=gen, device="cuda").to(dtype)
                    for _ in range(3)]
        # Views into one fused (B, T, 3*H*D) projection, as the model makes them.
        x = torch.randn((B, T, 3 * H * D), generator=gen, device="cuda").to(dtype)
        return [t.view(B, T, H, D) for t in x.split(H * D, dim=-1)]

    for T in (5, 257, 300):
        for D in (32, 64, 128):
            q, k, v = qkv(2, T, 4, D, torch.float32)
            out = flash_attention(q, k, v)
            torch.cuda.synchronize()
            err = (out - flash_attention_plain(q, k, v)).abs().max().item()
            print(f"[kernels] flash_attention f32 B=2 T={T} H=4 D={D}: "
                  f"max_abs_err {err:.3e} (tol {F32_TOL})", flush=True)
            check(err <= F32_TOL, f"flash_attention f32 T={T} D={D}: err {err} > {F32_TOL}")

    # bf16 at every head dim the kernel takes, across ragged and whole tiles,
    # on fused-qkv views and on separate contiguous tensors.
    for T in BF16_PARITY_T:
        for D in (32, 64, 128):
            for fused in (True, False):
                q, k, v = qkv(2, T, 4, D, torch.bfloat16, fused)
                out = flash_attention(q, k, v)
                torch.cuda.synchronize()
                err = (out.float() - flash_attention_plain(q, k, v).float()).abs().max().item()
                layout = "fused" if fused else "separate"
                print(f"[kernels] flash_attention bf16 B=2 T={T} H=4 D={D} {layout}: "
                      f"max_abs_err {err:.3e} (tol {BF16_TOL})", flush=True)
                check(bool(torch.isfinite(out).all()),
                      f"flash_attention bf16 T={T} D={D} {layout}: output is not finite")
                check(err <= BF16_TOL,
                      f"flash_attention bf16 T={T} D={D} {layout}: err {err} > {BF16_TOL}")

    B, T, H, D = BATCH, (IMAGE // 14) ** 2 + 1, 16, 64  # ViT-L/14 at batch 128
    q, k, v = qkv(B, T, H, D, torch.bfloat16)
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    ref = flash_attention_plain(q, k, v)
    err = (out.float() - ref.float()).abs().max().item()
    print(f"[kernels] flash_attention bf16 B={B} T={T} H={H} D={D}: "
          f"max_abs_err {err:.3e} (tol {BF16_TOL})", flush=True)
    check(bool(torch.isfinite(out).all()), "flash_attention bf16 output is not finite")
    check(err <= BF16_TOL, f"flash_attention bf16: err {err} > {BF16_TOL}")

    ms = time_ms(lambda: flash_attention(q, k, v))
    plain_ms = time_ms(lambda: flash_attention_plain(q, k, v), iters=5)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
    bound_ms, bound_by = attention_bound_ms(B, T, H, D, "bfloat16", 2)
    print(f"[kernels] flash_attention bf16 B={B} T={T} H={H} D={D}: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}); kernel / sdpa {ms / library_ms:.3f}, kernel / bound "
          f"{ms / bound_ms:.2f} [{card}]", flush=True)
    return {"name": "flash_attention", "route": "cuda",
            "source": "daft_tpu_torch/csrc/flash_attention.cu",
            "replaces": "daft_tpu/ops/pallas_attention.py:72",
            "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}


def phase_main_path(card: str) -> tuple:
    """The engine's embed_image path at ViT-L/14 width; returns the launch
    count of each kernel and the run's wall time in ms."""
    import numpy as np
    import torch

    import daft_tpu_torch as dt
    from daft_tpu_torch.functions.ai import embed_image
    from daft_tpu_torch.models.clip import embed
    from daft_tpu_torch.ops.flash_attention import flash_attention

    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (NUM_IMAGES, IMAGE * IMAGE * 3), dtype=np.uint8)
    series = dt.Series.from_numpy(imgs, "img", dt.DataType.image("RGB", IMAGE, IMAGE))
    df = dt.from_pydict({"img": series})
    expr = embed_image(dt.col("img"), provider="cuda_random", model="ViT-L/14",
                       batch_size=BATCH)
    with dt.execution_config_ctx(default_morsel_size=NUM_IMAGES):
        t0 = time.perf_counter()
        df.limit(BATCH).with_column("emb", expr).collect()  # weights + first forward
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()

        flash_attention.launch_count = 0
        t0 = time.perf_counter()
        parts = list(df.with_column("emb", expr).select("emb").iter_partitions())
        elapsed = time.perf_counter() - t0
        launches = flash_attention.launch_count

    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # The instance the UDF made (weights on the card) and its phase split.
    inst = expr._expr.udf._get_instance()
    rows = sum(len(p) for p in parts)
    chunks = sum(math.ceil(len(p) / BATCH) for p in parts)
    emb = np.concatenate([np.asarray(p.to_pydict()["emb"], dtype=np.float32) for p in parts])
    norms = np.linalg.norm(emb, axis=1)
    print(f"[main] {rows} images in {elapsed:.3f} s = {rows / elapsed:.1f} img/s; "
          f"set-up {setup_s:.1f} s; phases {inst.last_forward_stats}; peak device memory "
          f"{peak_gb:.2f} GB [{card}]", flush=True)
    print(f"[main] flash_attention launches {launches} for {chunks} chunk(s) of <= {BATCH}",
          flush=True)
    bound_s = tower_flops(inst.cfg) * rows / PEAK_OPS_PER_S["bfloat16"]
    print(f"[main] bound: {tower_flops(inst.cfg) / 1e9:.1f} GFLOP per image, {bound_s * 1e3:.1f} ms "
          f"for {rows} images at the bf16 peak ({rows / bound_s:.0f} img/s); the run took "
          f"{bound_s / elapsed:.3f} of that rate [{card}]", flush=True)
    check(rows == NUM_IMAGES, f"expected {NUM_IMAGES} rows, got {rows}")
    check(emb.shape == (NUM_IMAGES, 768), f"embedding shape {emb.shape}")
    check(bool(np.isfinite(emb).all()), "non-finite embeddings")
    check(bool(np.abs(norms - 1).max() < 1e-3), f"norms off 1 by {np.abs(norms - 1).max()}")
    check(launches == VIT_L_LAYERS * chunks,
          f"flash_attention launched {launches} times, expected {VIT_L_LAYERS} x {chunks}")

    # One chunk through the tower directly, on the same weights.
    direct = embed(inst.encoder, torch.from_numpy(
        imgs[:BATCH].reshape(BATCH, IMAGE, IMAGE, 3)).cuda()).cpu().numpy()
    chunk_err = float(np.abs(direct - emb[:BATCH]).max())
    print(f"[main] engine chunk vs direct forward: max_abs_err {chunk_err:.3e} "
          f"(tol {CHUNK_TOL})", flush=True)
    check(chunk_err <= CHUNK_TOL, f"engine chunk differs from direct forward by {chunk_err}")

    check_image_tower("main", inst, imgs[:2].reshape(2, IMAGE, IMAGE, 3), emb[:2])
    return {"flash_attention": launches}, elapsed * 1e3


def phase_trace(card: str) -> None:
    """One chunk of the main path under torch.profiler (``trace_window``)."""
    import numpy as np

    import daft_tpu_torch as dt
    from daft_tpu_torch.functions.ai import embed_image

    rng = np.random.default_rng(1)
    imgs = rng.integers(0, 256, (BATCH, IMAGE * IMAGE * 3), dtype=np.uint8)
    series = dt.Series.from_numpy(imgs, "img", dt.DataType.image("RGB", IMAGE, IMAGE))
    df = dt.from_pydict({"img": series})
    expr = embed_image(dt.col("img"), provider="cuda_random", model="ViT-L/14",
                       batch_size=BATCH)
    trace_window(card, "trace", f"one chunk of {BATCH} images",
                 lambda: df.with_column("emb", expr).collect())


def trace_window(card: str, tag: str, what: str, run):
    """``run()`` once warm, then once under torch.profiler: device time by
    kernel and by kind, and the share of the window in which no device work
    ran ("not measured" where the profiler records no device activity).
    Returns the µs in which device work ran, or None where not measured."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()  # weights and a warm forward
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    events = list(prof.events())
    spans = [(e.time_range.start, e.time_range.end) for e in events]
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    if not device:
        print(f"[{tag}] top kernels: not measured; device idle share: not measured "
              "(the profiler recorded no device activity)", flush=True)
        return None
    by_name: dict = {}
    for e in device:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    busy_us, end = 0.0, -math.inf
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in device):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    window_us = max(b for _, b in spans) - min(a for a, _ in spans)
    total_us = sum(by_name.values())
    print(f"[{tag}] {what}: window {window_us / 1e3:.3f} ms, device busy "
          f"{busy_us / 1e3:.3f} ms, idle share {1 - busy_us / window_us:.4f} [{card}]", flush=True)
    kinds = (("attention", ("attn_bf16",)), ("softmax", ("softmax",)),
             ("masked_fill", ("masked_fill",)), ("cache writes", ("index_put", "indexing")),
             ("matmul", ("gemm", "gemv", "xmma", "cutlass", "nvjet", "splitk")),
             ("layernorm", ("layer_norm",)), ("gelu", ("gelu",)),
             ("copies", ("memcpy", "memset", "copy_kernel")))
    by_kind: dict = {}
    for name, us in by_name.items():
        kind = next((k for k, keys in kinds if any(key in name.lower() for key in keys)), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + us
    print(f"[{tag}] device time by kind: " + ", ".join(
        f"{k} {us / 1e3:.3f} ms ({us / total_us:.1%})"
        for k, us in sorted(by_kind.items(), key=lambda kv: -kv[1])), flush=True)
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"[{tag}]   {us / 1e3:9.3f} ms {us / total_us:6.1%}  {name[:120]}", flush=True)
    return busy_us


def make_texts(n: int, seed: int) -> list:
    """``n`` strings of 1..MAX_WORDS words drawn from WORD_LIST; every
    EMPTY_EVERY-th is empty."""
    import numpy as np

    rng = np.random.default_rng(seed)
    words = np.array(WORD_LIST)
    texts = [" ".join(words[rng.integers(0, len(words), rng.integers(1, MAX_WORDS + 1))])
             for _ in range(n)]
    for i in range(0, n, EMPTY_EVERY):
        texts[i] = ""
    return texts


def engine_run(card: str, name: str, df, rows: int, expr, warm_rows: int) -> tuple:
    """``expr`` over the ``rows`` rows of ``df`` through the engine: a warm
    run over the first ``warm_rows`` rows (weights and first forwards), then
    the timed run with every launch count set to 0 just before and read just
    after. Prints rows/s, the phase split and the peak device memory, also as
    the part above what was allocated before the path's weights were made.
    Returns the result column as a list, the launch counts, the UDF's
    instance and the timed run's seconds."""
    import gc

    import torch

    import daft_tpu_torch as dt
    from daft_tpu_torch.ops.flash_attention import flash_attention

    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    with dt.execution_config_ctx(default_morsel_size=rows):
        t0 = time.perf_counter()
        df.limit(warm_rows).with_column("out", expr).collect()
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        flash_attention.launch_count = 0
        t0 = time.perf_counter()
        parts = list(df.with_column("out", expr).select("out").iter_partitions())
        elapsed = time.perf_counter() - t0
        launches = {"flash_attention": flash_attention.launch_count}
    peak = torch.cuda.max_memory_allocated()
    out = [v for p in parts for v in p.to_pydict()["out"]]
    inst = expr._expr.udf._get_instance()
    stats = getattr(inst, "last_forward_stats", None)
    if stats is None:  # a classifier: the tower that embedded the rows
        tower = inst.image_embedder if name == "classify_image" else inst.text_embedder
        stats = tower.last_forward_stats
    print(f"[{name}] {len(out)} rows in {elapsed:.3f} s = {len(out) / elapsed:.1f} rows/s; "
          f"set-up {setup_s:.1f} s; phases of the last morsel {stats}; peak device memory "
          f"{peak / 1e9:.2f} GB ({(peak - base) / 1e9:.2f} GB above what was allocated before "
          f"the path); launches {launches} [{card}]", flush=True)
    check(len(out) == rows, f"{name}: expected {rows} rows, got {len(out)}")
    return out, launches, inst, elapsed


def check_staged_tokens(name: str, inst, texts: list) -> None:
    """The token ids the card received equal the ids the host made: the
    instance's stager is wrapped for one call over ``texts``."""
    import numpy as np
    import torch

    stage, staged = inst._stage, []

    def record(chunk, rows):
        dev = stage(chunk, rows)
        staged.append((chunk, dev))
        return dev

    inst._stage = record
    try:
        inst.embed_text(texts)
    finally:
        inst._stage = stage
    host_max = 0
    for chunk, dev in staged:
        check(dev.dtype == torch.int32, f"{name}: tokens staged as {dev.dtype}, not int32")
        got = dev.cpu().numpy()
        check(np.array_equal(got[:len(chunk)], chunk) and not got[len(chunk):].any(),
              f"{name}: the card received other token ids than the host made")
        host_max = max(host_max, int(chunk.max()))
    check(host_max > 255, f"{name}: ids never pass 255, the check would not see a uint8 buffer")
    print(f"[{name}] staged token ids equal the host's: {len(staged)} chunk(s), int32, "
          f"largest id {host_max}", flush=True)


def on_cpu(inst):
    """A shallow copy of an embedder whose tower is the same tower, same
    weights, on the CPU (where attention is the plain version)."""
    import copy

    import torch

    cpu = copy.copy(inst)
    cpu.device = torch.device("cpu")
    cpu.encoder = type(inst.encoder)(inst.cfg, device="cpu")
    cpu.encoder.load_state_dict(inst.encoder.state_dict())
    return cpu


def cosines(a, b):
    import numpy as np

    return (a * b).sum(axis=1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


def check_image_tower(name: str, inst, imgs, emb):
    """The image tower on the card against the same tower on the CPU, on
    ``imgs`` (B, H, W, 3) uint8 whose card embeddings are ``emb``; returns
    the CPU embeddings."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    ref = on_cpu(inst).forward(torch.from_numpy(imgs)).numpy()
    cos = cosines(ref, emb)
    print(f"[{name}] GPU tower vs CPU tower ({len(imgs)} images, {time.perf_counter() - t0:.1f} "
          f"s): cosine {cos.min():.6f} (min {CPU_COSINE_MIN}), max_abs_err "
          f"{np.abs(ref - emb).max():.3e}", flush=True)
    check(bool(cos.min() >= CPU_COSINE_MIN), f"{name}: GPU and CPU towers disagree: cosine {cos}")
    return ref


def check_text_tower(name: str, inst, texts: list, emb, sample: int = CPU_TEXT_SAMPLE):
    """The text tower on the card against the same tower on the CPU, on up
    to ``sample`` seeded non-empty strings of ``texts`` and the first empty
    one (whose rows must agree too: both zero in MiniLM); ``emb`` holds the
    card's embeddings of ``texts``. Returns the CPU embeddings of the
    sample, in ``texts``' order, and its indices."""
    import numpy as np
    import torch

    full = [i for i, t in enumerate(texts) if t]
    idx = sorted(np.random.default_rng(4).choice(full, min(sample, len(full)), replace=False))
    idx += [i for i, t in enumerate(texts) if not t][:1]
    tokens, lengths = inst.tokenizer.encode_batch([texts[i] for i in idx])
    t0 = time.perf_counter()
    ref = on_cpu(inst).forward(torch.from_numpy(tokens)).numpy()
    got = emb[idx]
    cos = cosines(ref[lengths > 0], got[lengths > 0])
    print(f"[{name}] GPU tower vs CPU tower ({int((lengths > 0).sum())} non-empty strings "
          f"and {int((lengths == 0).sum())} empty, {time.perf_counter() - t0:.1f} s): cosine "
          f"{cos.min():.6f} (min {CPU_COSINE_MIN}), max_abs_err {np.abs(ref - got).max():.3e}",
          flush=True)
    check(bool(cos.min() >= CPU_COSINE_MIN), f"{name}: GPU and CPU towers disagree: cosine {cos}")
    check(np.allclose(ref[lengths == 0], got[lengths == 0], atol=1e-2),
          f"{name}: the empty string's rows differ between the GPU and CPU towers")
    return ref, idx


def check_classify_image(inst, idf, imgs, labels_out: list) -> None:
    """``classify_image``'s engine run against direct forwards. The engine
    runs again, untimed, on the same instance ``inst``, with its image
    tower's ``embed_image`` recorded:
    its embeddings and their similarities to the label prompts must equal a
    direct forward's, its labels the argmax of those similarities. The
    similarities must agree with the CPU towers' on a few images, and the
    label list reversed must name the same label for every row (random
    weights may give every row one label, which a wrong index would then
    hide)."""
    import numpy as np

    import daft_tpu_torch as dt
    from daft_tpu_torch.functions.ai import classify_image

    tower = inst.image_embedder
    embed_image, made = tower.embed_image, []
    tower.embed_image = lambda images: made.append(embed_image(images)) or made[-1]
    try:
        with dt.execution_config_ctx(default_morsel_size=len(imgs)):
            runs = {}
            for order in (LABELS, LABELS[::-1]):
                made.clear()
                expr = classify_image(dt.col("img"), order, provider="cuda_random",
                                      model="ViT-L/14")
                expr._expr.udf._instance = inst
                labels = idf.with_column("out", expr).to_pydict()["out"]
                check(bool(made), "classify_image: the engine run embedded no image")
                runs[tuple(order)] = (labels, np.concatenate(made))
    finally:
        tower.embed_image = embed_image
    out, engine_emb = runs[tuple(LABELS)]
    check(out == labels_out, "classify_image: a second engine run gave other labels")
    prompts = [f"a photo of a {l}" for l in LABELS]
    lab = inst.text_embedder.embed_text(prompts)
    direct_emb = embed_image(imgs)
    emb_err = float(np.abs(engine_emb - direct_emb).max())
    sims = engine_emb @ lab.T
    sim_err = float(np.abs(sims - direct_emb @ lab.T).max())
    top = np.sort(sims, axis=1)
    print(f"[classify_image] engine vs direct forward: embeddings max_abs_err {emb_err:.3e}, "
          f"similarities max_abs_err {sim_err:.3e} (tol {CHUNK_TOL}); similarities "
          f"{sims.min():.4f}..{sims.max():.4f}, top-two margin {(top[:, -1] - top[:, -2]).min():.2e}"
          f"..{(top[:, -1] - top[:, -2]).max():.2e}; {len(set(out))} distinct label(s)", flush=True)
    check(engine_emb.shape == (len(imgs), inst.image_embedder.dimensions),
          f"classify_image: the engine embedded {engine_emb.shape}")
    check(emb_err <= CHUNK_TOL and sim_err <= CHUNK_TOL,
          "classify_image: the engine's embeddings or similarities differ from a direct forward")
    check(out == [LABELS[i] for i in sims.argmax(axis=1)],
          "classify_image: engine labels are not the argmax of the engine's similarities")
    check(runs[tuple(LABELS[::-1])][0] == out,
          "classify_image: reversing the label list changed a row's label")

    ref_img = check_image_tower("classify_image", tower, imgs[:4], direct_emb[:4])
    ref_lab, _ = check_text_tower("classify_image prompts", inst.text_embedder, prompts, lab)
    cpu_sims = ref_img @ ref_lab.T
    cpu_err = float(np.abs(cpu_sims - sims[:4]).max())
    print(f"[classify_image] similarities of 4 images, GPU vs CPU towers: max_abs_err "
          f"{cpu_err:.3e} (tol {CPU_SIM_TOL}); labels equal a direct forward, and the same "
          f"with the label list reversed", flush=True)
    check(cpu_err <= CPU_SIM_TOL, f"classify_image: GPU and CPU similarities differ by {cpu_err}")


def phase_text(card: str) -> dict:
    """The text and zero-shot paths at full width; returns the launch counts
    of each path by name."""
    import numpy as np

    import daft_tpu_torch as dt
    from daft_tpu_torch.functions.ai import classify_image, classify_text, embed_text

    texts = make_texts(NUM_TEXTS, seed=2)
    empty = np.array([t == "" for t in texts])
    df = dt.from_pydict({"t": texts})
    by_path = {}
    for name, model, dims in (("embed_text MiniLM-L6", "all-MiniLM-L6-v2", 384),
                              ("embed_text ViT-L/14", "ViT-L/14", 768)):
        expr = embed_text(dt.col("t"), provider="cuda_random", model=model)
        out, launches, inst, elapsed = engine_run(card, name, df, NUM_TEXTS, expr, warm_rows=512)
        cfg = inst.cfg
        per_text = (text_flops(cfg.hidden, cfg.layers, cfg.max_length) if "MiniLM" in name else
                    text_flops(cfg.text_width, cfg.text_layers, cfg.context_length,
                               cfg.text_mlp_ratio))
        bound_s = per_text * NUM_TEXTS / PEAK_OPS_PER_S["bfloat16"]
        print(f"[{name}] bound: {per_text / 1e9:.2f} GFLOP per text, {bound_s * 1e3:.1f} ms for "
              f"{NUM_TEXTS} texts at the bf16 peak; the run took {bound_s / elapsed:.3f} of that "
              f"rate [{card}]", flush=True)
        emb = np.asarray(out, dtype=np.float32)
        norms = np.linalg.norm(emb, axis=1)
        check(emb.shape == (NUM_TEXTS, dims), f"{name}: embedding shape {emb.shape}")
        check(bool(np.isfinite(emb).all()), f"{name}: non-finite embeddings")
        rest = ~empty if "MiniLM" in name else np.ones_like(empty)
        check(bool(np.abs(norms[rest] - 1).max() < 1e-3),
              f"{name}: norms off 1 by {np.abs(norms[rest] - 1).max()}")
        if "MiniLM" in name:
            check(not emb[empty].any(), f"{name}: empty strings do not give zero vectors")
            print(f"[{name}] {int(empty.sum())} empty strings: exact zero vectors; "
                  f"{int((~empty).sum())} others unit-norm", flush=True)
        check(launches["flash_attention"] == 0,
              f"{name}: the masked path launched flash_attention {launches['flash_attention']} times")
        # The engine's last chunk of 512 rows, embedded directly.
        err = float(np.abs(inst.embed_text(texts[-512:]) - emb[-512:]).max())
        print(f"[{name}] engine chunk vs direct forward: max_abs_err {err:.3e} "
              f"(tol {CHUNK_TOL})", flush=True)
        check(err <= CHUNK_TOL, f"{name}: engine chunk differs from a direct forward by {err}")
        check_staged_tokens(name, inst, texts[:1024])
        check_text_tower(name, inst, texts, emb)
        head = df.limit(512)
        trace_window(card, f"trace {name}", "one chunk of 512 strings",
                     lambda: head.with_column("out", expr).collect())
        by_path[name] = launches

    rng = np.random.default_rng(3)
    imgs = rng.integers(0, 256, (NUM_CLASSIFY_IMAGES, IMAGE * IMAGE * 3), dtype=np.uint8)
    idf = dt.from_pydict({"img": dt.Series.from_numpy(
        imgs, "img", dt.DataType.image("RGB", IMAGE, IMAGE))})
    expr = classify_image(dt.col("img"), LABELS, provider="cuda_random", model="ViT-L/14")
    out, launches, inst, _ = engine_run(card, "classify_image", idf, NUM_CLASSIFY_IMAGES, expr,
                                        warm_rows=BATCH)
    chunks = math.ceil(NUM_CLASSIFY_IMAGES / inst.image_embedder.max_batch)
    check(launches["flash_attention"] == VIT_L_LAYERS * chunks,
          f"classify_image: flash_attention launched {launches['flash_attention']} times, "
          f"expected {VIT_L_LAYERS} x {chunks}")
    check_classify_image(inst, idf, imgs.reshape(-1, IMAGE, IMAGE, 3), out)
    print(f"[classify_image] flash_attention launches {launches['flash_attention']} for "
          f"{chunks} chunk(s)", flush=True)
    by_path["classify_image"] = launches

    expr = classify_text(dt.col("t"), LABELS, provider="cuda_random", model="ViT-L/14")
    out, launches, inst, _ = engine_run(card, "classify_text", df, NUM_TEXTS, expr, warm_rows=512)
    sims = inst.text_embedder.embed_text(texts) @ inst.text_embedder.embed_text(LABELS).T
    check(out == [LABELS[i] for i in sims.argmax(axis=1)],
          "classify_text: engine labels differ from a direct forward")
    check(launches["flash_attention"] == 0,
          f"classify_text: flash_attention launched {launches['flash_attention']} times")
    print(f"[classify_text] labels equal a direct forward; {len(set(out))} distinct", flush=True)
    by_path["classify_text"] = launches
    return by_path


def decode_step_bound(model, batcher, kv_positions: float) -> tuple:
    """The least time of one decode step of ``batcher``'s pool that attends
    to ``kv_positions`` cache positions in all (summed over the slots): every
    weight read once (of the two embeddings only the B rows gathered), the K/V
    of those positions read once, the new K/V and the f32 logits written once,
    over the HBM rate; or its operations (2 per weight and row of the
    products, 4·hidden per attended position and layer) over the bf16 peak.
    The port's attention reads the whole cache, B·S positions; the work needs
    only the live ones. Returns (ms, "bytes" or "operations", bytes)."""
    cfg, B = model.cfg, batcher.B
    weights, _ = model_bytes(model, batcher)
    gathered = (model.tok_embed.weight, model.pos_embed)
    dense = sum(p.numel() for p in model.parameters() if p.dim() == 2) - model.tok_embed.weight.numel()
    itemsize = batcher.caches[0][0].element_size()
    moved = (weights - sum(p.numel() * p.element_size() for p in gathered)
             + 2 * B * cfg.hidden * 4 + kv_positions * 2 * cfg.layers * cfg.hidden * itemsize
             + 2 * cfg.layers * B * cfg.hidden * itemsize + B * cfg.vocab_size * 4)
    ops = 2 * B * dense + 4 * cfg.layers * kv_positions * cfg.hidden
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S["bfloat16"] * 1e3
    return (t_bytes, "bytes", moved) if t_bytes >= t_ops else (t_ops, "operations", moved)


def model_bytes(model, batcher) -> tuple:
    """(bytes of the weights, bytes of the batcher's KV cache)."""
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    cache = sum(k.numel() * k.element_size() * 2 for k, _ in batcher.caches)
    return weights, cache


def check_lm_on_cpu(card: str, model, tokens, lengths) -> None:
    """The card's LM against a CPU copy of the same weights on a few prompts:
    the prefill logits at every real position, then TEACHER_STEPS decode
    steps that feed both models the card's greedy tokens. Each position's
    logits must have cosine >= CPU_COSINE_MIN; the share of positions whose
    argmax agrees is printed (random weights give near-ties)."""
    import numpy as np
    import torch

    from daft_tpu_torch.models.lm import DecoderLM, init_caches

    t0 = time.perf_counter()
    cpu = DecoderLM(model.cfg, device="cpu")
    cpu.load_state_dict(model.state_dict())
    cpu.eval().requires_grad_(False)
    B, P = tokens.shape
    runs = {}
    for name, m, dev in (("gpu", model, "cuda"), ("cpu", cpu, "cpu")):
        caches = init_caches(m.cfg, B, P + TEACHER_STEPS, device=dev)
        with torch.no_grad():
            logits, _ = m(torch.from_numpy(tokens).to(dev), caches,
                          torch.arange(P, device=dev).expand(B, P))
        runs[name] = (caches, [logits.float().cpu()])
    cos_min, agree, total = 1.0, 0, 0
    pos = torch.from_numpy(lengths.astype(np.int64))
    for step in range(TEACHER_STEPS + 1):
        g, c = runs["gpu"][1][-1], runs["cpu"][1][-1]
        if step == 0:  # the prefill: every real position of each prompt
            valid = torch.arange(P)[None, :] < pos[:, None]
            g, c = g[valid], c[valid]
            last = runs["gpu"][1][0][torch.arange(B), pos - 1]
        else:
            g, c = g[:, 0], c[:, 0]
            last = g
        cos = torch.nn.functional.cosine_similarity(g, c, dim=-1)
        cos_min = min(cos_min, float(cos.min()))
        agree += int((g.argmax(-1) == c.argmax(-1)).sum())
        total += len(g)
        if step == TEACHER_STEPS:
            break
        tok = last.argmax(-1).to(torch.int32)[:, None]
        for name, m, dev in (("gpu", model, "cuda"), ("cpu", cpu, "cpu")):
            caches, outs = runs[name]
            with torch.no_grad():
                logits, _ = m(tok.to(dev), caches, (pos + step)[:, None].to(dev))
            outs.append(logits.float().cpu())
    print(f"[prompt] GPU LM vs CPU LM ({B} prompts of {lengths.tolist()} tokens, prefill and "
          f"{TEACHER_STEPS} teacher-forced decode steps, {time.perf_counter() - t0:.1f} s): "
          f"cosine {cos_min:.6f} (min {CPU_COSINE_MIN}) over {total} positions; argmax agrees "
          f"at {agree}/{total} = {agree / total:.3f} [{card}]", flush=True)
    check(cos_min >= CPU_COSINE_MIN, f"prompt: GPU and CPU LMs disagree: cosine {cos_min}")


def report_decode(card: str, tag: str, model, batcher, stats: dict, elapsed: float,
                  responses: int, tokens: int) -> None:
    """prompts/s, tokens/s and ms per decode step beside its bound over the
    positions the run attended to, and beside the bound over the whole cache."""
    steps = max(stats["decode_steps"], 1)
    live = stats["kv_positions"] / steps
    bound_ms, bound_by, moved = decode_step_bound(model, batcher, live)
    whole_ms, _, whole = decode_step_bound(model, batcher, batcher.B * batcher.S)
    step_ms = stats["decode_s"] * 1e3 / steps
    print(f"[{tag}] {responses} prompts, {tokens} generated ids in {elapsed:.3f} s = "
          f"{responses / elapsed:.2f} prompts/s, {tokens / elapsed:.1f} tokens/s; "
          f"{stats['decode_steps']} decode steps at {step_ms:.3f} ms each (stream time); bound "
          f"{bound_ms:.3f} ms ({bound_by}: {moved / 1e9:.3f} GB per step at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s, {live:.1f} live cache positions per step), "
          f"step / bound {step_ms / bound_ms:.2f}; over the whole cache ({batcher.B * batcher.S} "
          f"positions, as the port reads it) {whole_ms:.3f} ms ({whole / 1e9:.3f} GB), step / "
          f"that {step_ms / whole_ms:.2f}; prefills {stats['prefill_s']:.3f} s [{card}]",
          flush=True)


def phase_generate(card: str) -> dict:
    """``prompt`` through the engine with ``default-lm`` at full width, then
    one wave of the ``8b`` widths straight through ``ContinuousBatcher``;
    returns the launch counts of each path by name."""
    import gc

    import numpy as np
    import torch

    import daft_tpu_torch as dt
    from daft_tpu_torch.functions.ai import prompt
    from daft_tpu_torch.models.lm import EOS_ID, DecoderLM, DecoderLMConfig, init_random_
    from daft_tpu_torch.models.serving import ContinuousBatcher, Request
    from daft_tpu_torch.ops.flash_attention import flash_attention
    from daft_tpu_torch.utils.tokenizer import HashingTokenizer

    texts = make_texts(NUM_PROMPTS, seed=5)
    for i in range(3, NUM_PROMPTS, 4):  # every fourth string repeats the one before
        texts[i] = texts[i - 1]
    df = dt.from_pydict({"t": texts})
    expr = prompt(dt.col("t"), provider="cuda_random", max_new_tokens=MAX_NEW_TOKENS,
                  temperature=0.0)
    out, launches, inst, elapsed = engine_run(card, "prompt default-lm", df, NUM_PROMPTS, expr,
                                              warm_rows=WARM_PROMPTS)
    peak = torch.cuda.max_memory_allocated()
    stats = dict(inst.last_forward_stats)
    ids = [[int(t) for t in r.split()] for r in out]
    report_decode(card, "prompt default-lm", inst.model, inst._batcher, stats, elapsed, len(out),
                  sum(map(len, ids)))
    weights, cache = model_bytes(inst.model, inst._batcher)
    print(f"[prompt default-lm] peak device memory {peak / 1e9:.2f} GB against weights "
          f"{weights / 1e9:.3f} GB + KV cache {cache / 1e9:.3f} GB = {(weights + cache) / 1e9:.3f} "
          f"GB [{card}]", flush=True)
    check(all(len(r) <= MAX_NEW_TOKENS and all(1 <= t < inst.cfg.vocab_size for t in r)
              for r in ids), f"prompt: a response is not <= {MAX_NEW_TOKENS} ids in [1, vocab)")
    check(all(out[i] == out[i - 1] for i in range(3, NUM_PROMPTS, 4)),
          "prompt: identical prompts gave different responses")
    check(stats["prefix_hits"] >= 1, f"prompt: no prefix hit in {stats}")
    check(launches["flash_attention"] == 0,
          f"prompt: flash_attention launched {launches['flash_attention']} times")
    again = inst.prompt(texts)
    check(again == out, "prompt: the engine's responses differ from a direct run")
    print(f"[prompt default-lm] responses equal a direct run; {len(set(out))} distinct of "
          f"{len(out)}; every repeated prompt answered alike; {stats['prefix_hits']} prefix hits",
          flush=True)
    tokens, lengths = inst.tokenizer.encode_batch(texts[1:1 + CPU_PROMPTS])
    check_lm_on_cpu(card, inst.model, tokens[:, :int(lengths.max())], lengths)

    # TRACE_STEPS decode steps of a full pool, on a batcher of its own.
    batcher = ContinuousBatcher(inst.model, num_slots=inst.num_slots)
    for slot in range(batcher.B):
        row = tokens[slot % len(tokens)]
        batcher._prefill(Request(tokens=row[row != 0], max_new_tokens=4 * TRACE_STEPS), slot)
    start = batcher._positions + 1  # every slot active; trace_window runs the steps twice
    busy_us = trace_window(card, "trace prompt default-lm",
                           f"{TRACE_STEPS} decode steps of 8 slots",
                           lambda: [batcher._decode() for _ in range(TRACE_STEPS)])
    live = float(np.mean([(start + k).sum() for k in range(TRACE_STEPS, 2 * TRACE_STEPS)]))
    bound_ms, bound_by, _ = decode_step_bound(inst.model, batcher, live)
    if busy_us is not None:
        print(f"[trace prompt default-lm] device time {busy_us / 1e3 / TRACE_STEPS:.3f} ms per "
              f"step against its bound {bound_ms:.3f} ms ({bound_by}, {live:.1f} live cache "
              f"positions per step): {busy_us / 1e3 / TRACE_STEPS / bound_ms:.2f}x [{card}]",
              flush=True)
    by_path = {"prompt": launches}
    del batcher, inst, expr
    gc.collect()
    torch.cuda.empty_cache()

    # One wave at the 8b widths.
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    cfg = DecoderLMConfig.from_name("8b")
    model = init_random_(DecoderLM(cfg, device="cuda"), torch.Generator("cuda").manual_seed(0))
    model.eval().requires_grad_(False)
    batcher = ContinuousBatcher(model, num_slots=8)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    tokens, lengths = HashingTokenizer(cfg.vocab_size, 128).encode_batch(
        make_texts(8, seed=6)[1:] + ["one more distinct prompt for the eighth slot"])

    def wave(new_tokens: int) -> list:
        return batcher.run([Request(tokens=tokens[i, :max(int(lengths[i]), 1)],
                                    max_new_tokens=new_tokens) for i in range(len(tokens))])

    wave(2)  # cuBLAS handles and the first forwards
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launch_count = 0
    t0 = time.perf_counter()
    rows = wave(WAVE_8B_NEW_TOKENS)
    elapsed = time.perf_counter() - t0
    launches_8b = {"flash_attention": flash_attention.launch_count}
    peak = torch.cuda.max_memory_allocated()
    stats = batcher.last_run_stats
    report_decode(card, "prompt_8b", model, batcher, stats, elapsed, len(rows),
                  sum(map(len, rows)))
    weights, cache = model_bytes(model, batcher)
    print(f"[prompt_8b] set-up {setup_s:.1f} s; stats {stats}; peak device memory "
          f"{peak / 1e9:.2f} GB ({(peak - base) / 1e9:.2f} GB above what was allocated before), "
          f"weights {weights / 1e9:.3f} GB + KV cache {cache / 1e9:.3f} GB; launches "
          f"{launches_8b} [{card}]", flush=True)
    check(all(len(r) == WAVE_8B_NEW_TOKENS or (r and r[-1] == EOS_ID) for r in rows),
          "prompt_8b: a request stopped early without EOS")
    check(all(0 <= t < cfg.vocab_size for r in rows for t in r), "prompt_8b: an id out of range")
    check(stats["prefills"] == len(rows) and stats["prefix_hits"] == 0,
          f"prompt_8b: expected {len(rows)} prefills of distinct prompts, got {stats}")
    check(launches_8b["flash_attention"] == 0,
          f"prompt_8b: flash_attention launched {launches_8b['flash_attention']} times")
    by_path["prompt_8b"] = launches_8b
    del batcher, model
    gc.collect()
    torch.cuda.empty_cache()
    return by_path


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    card = card_line()
    print(card, flush=True)
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)
    try:
        phase_build()
        records = [phase_kernels(card)]
        launches, wall_ms = phase_main_path(card)
        phase_trace(card)
        by_path = {"embed_image": launches}
        by_path.update(phase_text(card))
        by_path.update(phase_generate(card))
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    for rec in records:
        rec["launches"] = launches[rec["name"]]
        rec["launches_by_path"] = {path: counts[rec["name"]] for path, counts in by_path.items()}
        # Each launch of the main path ran at the timed shape (chunks of BATCH).
        print(f"[main] {rec['name']}: {rec['launches']} launches x {rec['ms']:.4f} ms = "
              f"{rec['launches'] * rec['ms']:.1f} ms of the main path's "
              f"{wall_ms:.1f} ms wall [{card}]", flush=True)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
