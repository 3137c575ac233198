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
   matmul, LayerNorm, GELU or sigmoid, copies and casts, other) and the
   device's idle share over the window ("not measured" where the profiler
   records no device activity);
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
7. drive the relational device layer through the engine on the card: TPC-H
   q06 (validation parameters) over the numeric columns of SF10's lineitem,
   59,986,052 rows generated from a seed by the TPC-H distributions
   (``daft_tpu_torch/tools/lineitem.py``), a warm run and a timed one with the
   counts set to 0 just before; print rows/s, column GB/s, the staging /
   host→device / device / fetch split (CUDA events), the pinned host→device
   rate of a 1 GB copy and the q06 bound it implies beside the HBM bound of the
   scan, the idle share over a ``torch.profiler`` window of four chunks and the
   peak device memory. It checks the revenue against an f64 numpy reference
   (rtol 1e-5), that the two runs' revenues are the same bytes, that every row
   ran in the device chain (none on a host route), that the program cache
   missed once per distinct padded chunk length, and that no flash attention
   was launched. On the first 1M rows, the filter→with_columns chain of q01's
   projection (``l_quantity < 48``; ``disc_price``, ``charge`` with f32
   literals) and the same projection through device_eval
   (``compiled_eval_enabled=False``) must equal the host route
   (``device_eval=False``) bit for bit; with Python literals the host's f64
   intermediates are one or two f32 roundings away, and the largest gap is
   printed. Then TPC-H q01 whole (grouped by ``l_returnflag``,
   ``l_linestatus``; DELTA 90) over the same 59,986,052 rows with q01's
   columns, warm and timed, with the counts set to 0 just before each run:
   rows/s, column GB/s, the counters (the filter's rows in the device chain,
   the ``disc_price`` / ``charge`` children in device_eval, the means' f64
   casts and the grouped partials on the host), the split and a profiler
   window of four chunks. It checks the four groups, ``count_order`` and
   ``sum_qty`` exactly and every float within 1e-5 of an f64 reference, that
   the two runs are the same bytes, the counters' exact values, no flash
   launch, and, on the first 1M rows, the card's route against the host
   route bit for bit. Then a high-cardinality grouped query (sum and count of
   ``l_quantity`` per ``l_partkey`` under q01's filter) over SF1's 6,001,215
   rows: the first-morsel probe must take the partitioned route, and every
   group must equal ``np.bincount``'s. Last, ``cosine_distance`` of
   1,000,000 x 768 f32 embeddings (CLIP ViT-L/14's width) against a query
   vector, and a ``where`` on it, on the card and through the port on the
   CPU: distances within 1e-6, the same rows kept;
   The pinned staging memory the device path holds is printed after q06 and
   after the scan, held to one buffer per staged column of the largest padded
   chunk, and must fall to 0 after ``reset_programs``; a column of f32 subnormals
   (3e-39, and 1e-20 squared) through device_eval on the card is printed as
   kept or flushed;
8. local HF checkpoints (nothing downloaded): write two checkpoint
   directories with the published configs' widths, seeded random f32
   weights under HF's key names saved with ``torch.save`` and synthetic
   seeded tokenizer files — sentence-transformers all-MiniLM-L6-v2 (BERT,
   WordPiece ``vocab.txt``) and openai/clip-vit-large-patch14 (CLIP,
   ``vocab.json`` + ``merges.txt``, end of text the highest id) — then
   through the engine with ``weights_path``: ``embed_text`` over phase 5's
   4096 strings with the BERT directory, ``embed_image`` over 512 images and
   ``classify_text`` over the 4096 strings with the CLIP directory, each
   with the launch counts set to 0 just before and read just after. It
   checks that the converted modules' parameters equal the HF tensors
   (after the layout changes, rounded to the parameter's dtype), finite
   unit-norm embeddings (exact zero vectors for BERT's empty strings), that
   the card receives the host's WordPiece / BPE ids, one engine chunk
   against a direct forward, each converted tower on the card against the
   same tower on the CPU (cosine >= 0.99), 24 flash-attention launches per
   image chunk and none on the text paths; one chunk of the BERT and of the
   image path is traced as in phase 4;
9. the image path, on 1024 seeded encoded photos (short side 256-640, aspect
   0.75-1.33, gradients plus noise; JPEG at quality 90, one in 16 PNG, one
   grayscale, one RGBA, one null, one corrupt): ``.image.decode(mode="RGB",
   on_error="null")`` and ``.image.resize(224, 224)`` on the host, each timed,
   every row held against PIL's own decode and resize and the null and
   corrupt rows null; (a) bytes to ViT-L/14 ``embed_image`` through the
   engine (rows/s, the decode / resize / forward split, 24 flash launches per
   chunk, one chunk equal to a direct forward); (b) ResNet-18 at its default
   config (bf16, seeded weights and BatchNorm statistics) as a batch ``Udf``
   over morsels of 256 resized rows giving the top-1 class: rows/s, peak
   memory, no flash launch, one traced batch (time by kind, idle share), the
   card's logits on 8 images against a CPU copy (cosine >= 0.99, top-1
   equal); (c) 1024 seeded 256x256 RGB ``FixedShapeImage`` rows resized to
   224x224 on the card: that it ran on CUDA, its time with the batch resident
   beside the byte bound, 64 rows against the CPU route (one level on < 1 %
   of values), one traced engine call;
10. print the whole run's time and one JSON line of per-kernel numbers (with
   the launches on each path), then, last, the device line.

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

Q06_RTOL = 1e-5          # f32 sums per chunk against an f64 reference
Q06_TRACE_ROWS = 4 * 2 * 256 * 1024  # four aggregation chunks
PARITY_ROWS = 1_000_000  # rows of the host-route bit-equality checks
Q01_PROFILE_ROWS = 64 * 256 * 1024  # 64 morsels of q01 under cProfile
EMBED_ROWS, EMBED_DIM = 1_000_000, 768
COSINE_TOL = 1e-6        # card against the CPU, f32 reductions in another order
COSINE_KEEP = 0.95       # the where's threshold on the cosine distance
PINNED_PROBE_BYTES = 1 << 30
NUMERIC_COLS = ("l_quantity", "l_extendedprice", "l_discount", "l_tax", "l_shipdate")

# The published configs of the two local HF checkpoints (config.json, the
# fields the converters read and the architecture's name).
HF_MINILM_CONFIG = {  # sentence-transformers/all-MiniLM-L6-v2
    "architectures": ["BertModel"], "model_type": "bert", "vocab_size": 30522,
    "hidden_size": 384, "num_hidden_layers": 6, "num_attention_heads": 12,
    "intermediate_size": 1536, "max_position_embeddings": 512, "type_vocab_size": 2,
    "layer_norm_eps": 1e-12, "hidden_act": "gelu", "pad_token_id": 0}
HF_CLIP_CONFIG = {  # openai/clip-vit-large-patch14
    "architectures": ["CLIPModel"], "model_type": "clip", "projection_dim": 768,
    "text_config": {"hidden_size": 768, "intermediate_size": 3072, "num_attention_heads": 12,
                    "num_hidden_layers": 12, "max_position_embeddings": 77, "vocab_size": 49408,
                    "hidden_act": "quick_gelu", "layer_norm_eps": 1e-5, "bos_token_id": 0,
                    "eos_token_id": 2, "pad_token_id": 1, "projection_dim": 768},
    "vision_config": {"hidden_size": 1024, "intermediate_size": 4096, "num_attention_heads": 16,
                      "num_hidden_layers": 24, "patch_size": 14, "image_size": 224,
                      "hidden_act": "quick_gelu", "layer_norm_eps": 1e-5,
                      "projection_dim": 768}}

# Phase 9: encoded photos with the side and aspect spread of LAION and
# ImageNet, mostly JPEG; ResNet-18 at torchvision's published config.
NUM_ENCODED = 1024
SIDES = (256, 640)
ASPECTS = (0.75, 1.33)
PNG_EVERY = 16
JPEG_QUALITY = 90
GRAY_ROW, RGBA_ROW, NULL_ROW, CORRUPT_ROW = 1, 2, 3, 4
RESNET_BATCH = 256
RESNET_CPU_ROWS = 8
RESIZE_SIDE = 256
RESIZE_CPU_ROWS = 64
RESIZE_MAX_OFF, RESIZE_OFF_SHARE = 1, 0.01  # tests/test_torch_image.py's uint8 tolerance

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
             ("convolution", ("fprop", "implicit_convolve", "conv2d", "winograd", "cudnn")),
             ("max-pool", ("max_pool",)),
             ("matmul", ("gemm", "gemv", "xmma", "cutlass", "nvjet", "splitk")),
             ("layernorm", ("layer_norm",)), ("gelu / sigmoid", ("gelu", "sigmoid")),
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


def phase_relational(card: str) -> dict:
    """The relational layer through the engine on the card: q06 over SF10's
    lineitem, the q01 projection chain and the device_eval route held against
    the host route, q01 whole (grouped) over SF10's lineitem, the partitioned
    grouped route over SF1's rows, and a cosine-distance scan held against the
    CPU. Returns the launch counts of each path (q06, q01, partitioned)."""
    import gc

    import numpy as np
    import torch

    import daft_tpu_torch as dt
    from daft_tpu_torch.execution.pipeline import chunk_morsels
    from daft_tpu_torch.ops import device_eval as de
    from daft_tpu_torch.ops.flash_attention import flash_attention
    from daft_tpu_torch.tools import lineitem

    rows = lineitem.SF10_LINEITEM_ROWS
    t0 = time.perf_counter()
    cols = lineitem.lineitem_columns(rows, seed=0)
    df = dt.from_pydict({k: cols[k] for k in NUMERIC_COLS})
    gen_s = time.perf_counter() - t0
    scan_bytes = sum(cols[k].nbytes for k in ("l_shipdate", "l_discount", "l_quantity",
                                              "l_extendedprice"))
    ref = lineitem.q06_reference(cols)
    # The padded lengths q06's chunks take: morsels of default_morsel_size
    # rows, chunks of more than AGG_CHUNK_ROWS, the fixed bucket ladder.
    cfg = dt.get_context().execution_config
    morsel = cfg.default_morsel_size
    morsels = [range(min(morsel, rows - s)) for s in range(0, rows, morsel)]
    chunk_rows = [sum(map(len, c)) for c in chunk_morsels(morsels, 256 * 1024)]
    shapes = {de._bucket(n, cfg.device_batch_buckets) for n in chunk_rows}
    print(f"[relational] lineitem SF10 columns (q06's five, q01's four more): {rows} rows "
          f"generated in {gen_s:.1f} s; "
          f"q06 reads {scan_bytes / 1e9:.3f} GB in {len(chunk_rows)} chunks, padded lengths "
          f"{sorted(shapes)}", flush=True)

    de.reset_programs()
    results, launches = [], None
    for run in ("warm", "timed"):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        de.device_eval_counters.reset()
        de.phase_timer.reset()
        de.phase_timer.enabled = run == "timed"
        flash_attention.launch_count = 0
        t0 = time.perf_counter()
        out = lineitem.q06(dt, df).to_pydict()
        elapsed = time.perf_counter() - t0
        de.phase_timer.enabled = False
        snap = de.device_eval_counters.snapshot()
        results.append((out["revenue"][0], elapsed, snap))
        check(snap["chain_rows"] == {"filter_project_agg": rows} and not snap["host_rows"],
              f"q06 {run}: not every row ran in the device chain: {snap}")
        launches = flash_attention.launch_count
        check(launches == 0, f"q06 {run}: flash_attention launched {launches} times")
    (warm_rev, warm_s, warm_snap), (rev, elapsed, snap) = results
    peak = torch.cuda.max_memory_allocated()
    split = de.phase_timer.totals
    check(warm_snap["program_misses"] == len(shapes),
          f"q06: {warm_snap['program_misses']} program-cache misses for {len(shapes)} distinct "
          f"padded lengths")
    check(snap["program_misses"] == 0, f"q06 timed run built programs: {snap}")
    err = abs(rev - ref) / abs(ref)
    check(err <= Q06_RTOL, f"q06 revenue {rev} vs f64 reference {ref}: rel err {err}")
    check(np.float32(rev).tobytes() == np.float32(warm_rev).tobytes(),
          f"q06: two runs gave {warm_rev!r} and {rev!r}")

    # The pinned host -> device rate, measured here with a 1 GB copy.
    host = torch.empty(PINNED_PROBE_BYTES, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(PINNED_PROBE_BYTES, dtype=torch.uint8, device="cuda")
    dev.copy_(host, non_blocking=True)
    pinned_ms = time_ms(lambda: dev.copy_(host, non_blocking=True), iters=5, warmup=1)
    pinned_rate = PINNED_PROBE_BYTES / (pinned_ms / 1e3)
    del host, dev
    pcie_bound_s = scan_bytes / pinned_rate
    hbm_bound_s = scan_bytes / HBM_BYTES_PER_S
    print(f"[relational] q06 over {rows} rows: revenue {rev:.6f} (f64 reference {ref:.6f}, rel err "
          f"{err:.2e}, tol {Q06_RTOL}); warm run {warm_s:.3f} s, timed run {elapsed:.3f} s = "
          f"{rows / elapsed:.4e} rows/s, {scan_bytes / elapsed / 1e9:.3f} GB/s of columns [{card}]",
          flush=True)
    print(f"[relational] q06 split: staging (host copies into pinned buffers) "
          f"{split['stage_s']:.3f} s, host->device {split['h2d_ms']:.3f} ms, device "
          f"{split['device_ms']:.3f} ms, fetch {split['d2h_ms']:.3f} ms (stream time, CUDA "
          f"events, summed over {snap['chain_morsels']['filter_project_agg']} chunks); "
          f"program cache: {warm_snap['program_misses']} misses in the warm run, "
          f"{snap['program_hits']} hits and 0 misses in the timed run [{card}]", flush=True)
    print(f"[relational] pinned host->device copy of 1 GB: {pinned_ms:.3f} ms = "
          f"{pinned_rate / 1e9:.2f} GB/s, so q06's {scan_bytes / 1e9:.3f} GB cannot cross in less "
          f"than {pcie_bound_s * 1e3:.1f} ms ({elapsed / pcie_bound_s:.2f}x that in the timed run); "
          f"the same bytes read once from HBM at {HBM_BYTES_PER_S / 1e12:.2f} TB/s: "
          f"{hbm_bound_s * 1e3:.3f} ms; peak device memory {peak / 1e9:.3f} GB [{card}]",
          flush=True)

    # Pinned staging: one buffer per staged column, of the largest chunk.
    pinned_q06 = de.pinned_bytes()
    q06_bound = 4 * max(shapes) * 4  # four 4-byte columns
    print(f"[relational] pinned staging held after q06: {pinned_q06 / 1e6:.3f} MB (four columns "
          f"of the largest chunk: {q06_bound / 1e6:.3f} MB)", flush=True)
    check(pinned_q06 == q06_bound, f"q06 holds {pinned_q06} pinned bytes, not {q06_bound}")

    head = dt.from_pydict({k: cols[k][:Q06_TRACE_ROWS] for k in NUMERIC_COLS})
    trace_window(card, "trace relational", f"q06 over {Q06_TRACE_ROWS} rows (four chunks)",
                 lambda: lineitem.q06(dt, head).to_pydict())

    check_relational_routes(card, {k: cols[k][:PARITY_ROWS] for k in NUMERIC_COLS})
    del df, head
    gc.collect()
    q01_launches, q01_pad = check_q01(card, cols)
    part_launches = check_partitioned(card, {k: cols[k][:lineitem.SF1_LINEITEM_ROWS]
                                             for k in ("l_shipdate", "l_partkey", "l_quantity")})
    del cols
    gc.collect()
    check_cosine_scan(card)
    scan_rows = de._bucket(cfg.default_morsel_size, cfg.device_batch_buckets)
    # Five 4-byte columns are staged by name: q06's four, and l_tax (the q01
    # projection), each at the largest padded length that q06's chunks and
    # the filters' morsels gave it; the scan stages e and q, f32.
    col_pad = max(max(shapes), q01_pad)
    scan_bound = 5 * col_pad * 4 + 2 * scan_rows * EMBED_DIM * 4
    pinned_scan = de.pinned_bytes()
    de.reset_programs()
    pinned_reset = de.pinned_bytes()
    print(f"[relational] pinned staging held after the cosine scan: {pinned_scan / 1e9:.3f} GB "
          f"(bound: five 4-byte columns of {col_pad} rows and two {EMBED_DIM}-wide f32 "
          f"columns of {scan_rows} rows, "
          f"{scan_bound / 1e9:.3f} GB); after reset_programs: {pinned_reset} bytes", flush=True)
    check(pinned_scan <= scan_bound, f"the scan holds {pinned_scan} pinned bytes > {scan_bound}")
    check(pinned_reset == 0, f"reset_programs left {pinned_reset} pinned bytes")
    check_subnormals(card)
    return {"relational": {"flash_attention": launches}, "q01": {"flash_attention": q01_launches},
            "q01_partitioned": {"flash_attention": part_launches}}


def check_q01(card: str, cols: dict) -> tuple:
    """TPC-H q01 whole over every row of ``cols``: warm and timed, with the
    counts set to 0 just before each run; the four groups against the f64
    reference, the runs against each other, the routes against the host
    route on PARITY_ROWS rows and a profiler window. Returns the flash
    launches of the timed run and the padded length of the filter's morsels."""
    import gc

    import numpy as np
    import torch

    import daft_tpu_torch as dt
    from daft_tpu_torch.ops import device_eval as de
    from daft_tpu_torch.ops.flash_attention import flash_attention
    from daft_tpu_torch.tools import lineitem

    q01_cols = ("l_quantity", "l_extendedprice", "l_discount", "l_tax", "l_shipdate",
                "l_returnflag", "l_linestatus")
    df = dt.from_pydict({k: cols[k] for k in q01_cols})
    rows = len(cols["l_shipdate"])
    read_bytes = sum(cols[k].nbytes for k in q01_cols)
    t0 = time.perf_counter()
    ref = lineitem.q01_reference(cols)
    ref_s = time.perf_counter() - t0
    # What the counters must show: the Filter's rows in the device chain (one
    # predicate per row), and the grouped partials with their children on the
    # host (agg_grouped), as in the JAX package, over every chunk and once more
    # over the first morsel (the cardinality probe).
    cfg = dt.get_context().execution_config
    morsel = cfg.default_morsel_size
    keep = cols["l_shipdate"] <= lineitem.Q01_SHIPDATE_MAX
    kept = int(keep.sum())
    probe = int(keep[:morsel].sum())
    pad = de._bucket(morsel, cfg.device_batch_buckets)
    want_counts = {"chain_rows": {"filter_project": rows}, "fused_rows": rows,
                   "host_rows": {"agg_grouped": kept + probe}}
    results = []
    for run in ("warm", "timed"):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        de.device_eval_counters.reset()
        de.phase_timer.reset()
        de.phase_timer.enabled = run == "timed"
        flash_attention.launch_count = 0
        t0 = time.perf_counter()
        out = lineitem.sorted_groups(lineitem.q01(dt, df).to_pydict())
        elapsed = time.perf_counter() - t0
        de.phase_timer.enabled = False
        snap = de.device_eval_counters.snapshot()
        launches = flash_attention.launch_count
        results.append((out, elapsed, snap))
        got_counts = {k: snap[k] for k in want_counts}
        check(got_counts == want_counts, f"q01 {run}: counters {got_counts}, want {want_counts}")
        check(launches == 0, f"q01 {run}: flash_attention launched {launches} times")
    (warm, warm_s, _), (out, elapsed, snap) = results
    peak = torch.cuda.max_memory_allocated()
    split = de.phase_timer.totals
    groups = list(zip(out["l_returnflag"], out["l_linestatus"]))
    check(groups == [("A", "F"), ("N", "F"), ("N", "O"), ("R", "F")], f"q01 groups {groups}")
    check(out["count_order"] == ref["count_order"] and out["sum_qty"] == ref["sum_qty"],
          f"q01 counts / sum_qty {out['count_order']} {out['sum_qty']} vs the reference "
          f"{ref['count_order']} {ref['sum_qty']}")
    errs = {k: max(abs(a - b) / abs(b) for a, b in zip(out[k], ref[k]))
            for k in ("sum_base_price", "sum_disc_price", "sum_charge", "avg_qty", "avg_price",
                      "avg_disc")}
    check(max(errs.values()) <= Q06_RTOL, f"q01 vs the f64 reference: {errs}")
    check(out == warm, "q01: the warm and the timed run differ")
    print(f"[relational] q01 over {rows} rows ({kept} kept, 4 groups, reference in {ref_s:.1f} s): "
          f"warm run {warm_s:.3f} s, timed run {elapsed:.3f} s = {rows / elapsed:.4e} rows/s, "
          f"{read_bytes / elapsed / 1e9:.3f} GB/s of the {read_bytes / 1e9:.3f} GB of columns it "
          f"reads; largest rel err vs the f64 reference {max(errs.values()):.2e} (tol {Q06_RTOL}); "
          f"counts and sum_qty exact; peak device memory {peak / 1e9:.3f} GB, pinned staging "
          f"{de.pinned_bytes() / 1e6:.3f} MB [{card}]", flush=True)
    print(f"[relational] q01 counters (timed run): chain_rows {snap['chain_rows']}, fused_rows "
          f"{snap['fused_rows']} (the filter's rows), host_rows {snap['host_rows']} (the chunks' "
          f"{kept} kept rows and the {probe}-row probe), program cache "
          f"{snap['program_hits']} hits / {snap['program_misses']} misses; flash launches 0",
          flush=True)
    print(f"[relational] q01 split: staging {split['stage_s']:.3f} s, host->device "
          f"{split['h2d_ms']:.3f} ms, device {split['device_ms']:.3f} ms, fetch "
          f"{split['d2h_ms']:.3f} ms (stream time, CUDA events, summed over the filter's "
          f"morsels); the rest of the {elapsed:.3f} s is host work (split below) "
          f"[{card}]",
          flush=True)
    head = dt.from_pydict({k: cols[k][:Q06_TRACE_ROWS] for k in q01_cols})
    trace_window(card, "trace relational", f"q01 over {Q06_TRACE_ROWS} rows (four chunks)",
                 lambda: lineitem.q01(dt, head).to_pydict())
    head = dt.from_pydict({k: cols[k][:Q01_PROFILE_ROWS] for k in q01_cols})
    host_split(card, f"q01 over {Q01_PROFILE_ROWS} rows", lambda: lineitem.q01(dt, head).to_pydict(),
               (("Acero's hash aggregation", "pyarrow/acero.py", "_group_by"),
                ("the filter's device program (staging, copies, fetch)", "ops/compiled_eval.py",
                 "run_morsel"),
                ("  of it, the host's selection of the kept rows", "ops/compiled_eval.py",
                 "_assemble"),
                ("the keys and the children on the host", "expressions/evaluator.py", "evaluate"),
                ("concatenating each chunk's morsels", "daft_tpu_torch/recordbatch.py", "concat"),
                ("the merge and finalize", "execution/aggregation.py", "finalize")))

    # The card's routes against the host route, bit for bit.
    part = dt.from_pydict({k: cols[k][:PARITY_ROWS] for k in q01_cols})
    card_out = lineitem.sorted_groups(lineitem.q01(dt, part).to_pydict())
    with dt.execution_config_ctx(device_eval=False, compiled_eval_enabled=False):
        part = dt.from_pydict({k: cols[k][:PARITY_ROWS] for k in q01_cols})
        host_out = lineitem.sorted_groups(lineitem.q01(dt, part).to_pydict())
    check(card_out == host_out, "q01: the card's route differs from the host route on "
          f"{PARITY_ROWS} rows")
    print(f"[relational] q01 on the first {PARITY_ROWS} rows: the card's route (filter in the "
          f"device chain) equals the host route bit for bit [{card}]",
          flush=True)
    return launches, pad


def host_split(card: str, what: str, run, parts) -> None:
    """``run()`` once under cProfile: the host seconds inside each of
    ``parts`` ((label, file suffix, function name)), beside the profiled wall
    time. cProfile's own cost falls on the Python calls, not on the native
    work inside them."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    run()
    prof.disable()
    wall = time.perf_counter() - t0
    stats = pstats.Stats(prof).stats
    rows = []
    for label, suffix, name in parts:
        cum = sum(v[3] for (f, _line, n), v in stats.items() if n == name and f.endswith(suffix))
        rows.append(f"{label} {cum:.3f} s ({cum / wall:.1%})")
    print(f"[relational] host split of {what} (cProfile, {wall:.3f} s wall): " + "; ".join(rows)
          + f" [{card}]", flush=True)


def check_partitioned(card: str, cols: dict) -> int:
    """A high-cardinality grouped query over ``cols`` (SF1's rows): where
    l_shipdate <= q01's cutoff, then sum(l_quantity) and count per l_partkey.
    With the default config the first-morsel probe must take the partitioned
    route; every group's sum and count must equal np.bincount's. The same
    query is then timed on the partitioned route with one bucket and on the
    merge route (the threshold above any reduction), each held to the same
    check, and the default once more. Returns the default run's flash
    launches."""
    import numpy as np
    import torch

    import daft_tpu_torch as dt
    from daft_tpu_torch.execution.executor import Executor
    from daft_tpu_torch.ops import device_eval as de
    from daft_tpu_torch.ops.flash_attention import flash_attention
    from daft_tpu_torch.tools import lineitem

    rows = len(cols["l_partkey"])
    keep = cols["l_shipdate"] <= lineitem.Q01_SHIPDATE_MAX
    keys = cols["l_partkey"][keep]
    want_sum = np.bincount(keys, weights=cols["l_quantity"][keep].astype(np.float64))
    want_n = np.bincount(keys)
    present = np.flatnonzero(want_n)
    real = Executor._partitioned_agg
    df = dt.from_pydict(cols)
    c = dt.col

    def run(label: str, **cfg) -> tuple:
        routes = []

        def spy(self, *args, **kwargs):
            routes.append(self.compute_threads)
            return real(self, *args, **kwargs)

        Executor._partitioned_agg = spy
        try:
            with dt.execution_config_ctx(**cfg):
                de.device_eval_counters.reset()
                flash_attention.launch_count = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = (df.where(c("l_shipdate") <= lineitem.Q01_SHIPDATE_MAX).groupby("l_partkey")
                       .agg(c("l_quantity").sum().alias("sum_qty"),
                            c("l_quantity").count().alias("n")).to_pydict())
                elapsed = time.perf_counter() - t0
                launches = flash_attention.launch_count
                snap = de.device_eval_counters.snapshot()
        finally:
            Executor._partitioned_agg = real
        order = np.argsort(np.asarray(out["l_partkey"]))
        got_keys = np.asarray(out["l_partkey"])[order]
        check(np.array_equal(got_keys, present), f"partitioned query, {label}: {len(got_keys)} "
              f"groups, want {len(present)}")
        check(np.array_equal(np.asarray(out["sum_qty"])[order], want_sum[present].astype(np.int64))
              and np.array_equal(np.asarray(out["n"])[order], want_n[present]),
              f"partitioned query, {label}: a group's sum or count differs from np.bincount")
        check(launches == 0, f"partitioned query, {label}: flash_attention launched {launches} "
              "times")
        return routes, elapsed, launches, snap

    routes, elapsed, launches, snap = run("default")
    check(len(routes) == 1, f"partitioned query: the probe took {len(routes)} partitioned routes")
    print(f"[relational] partitioned grouped query over {rows} rows ({int(keep.sum())} kept): "
          f"{len(present)} groups of l_partkey in {routes[0]} buckets, {elapsed:.3f} s = "
          f"{rows / elapsed:.4e} rows/s; every sum and count equals np.bincount; counters: "
          f"chain_rows {snap['chain_rows']}, host_rows {snap['host_rows']} [{card}]", flush=True)
    times = {f"partitioned, {routes[0]} buckets": elapsed}
    one, times["partitioned, 1 bucket"], _, _ = run("1 bucket", num_compute_threads=1)
    check(one == [1], f"partitioned query, 1 bucket: routes {one}")
    merge, times["merge"], _, _ = run("merge", high_cardinality_aggregation_threshold=1.0)
    check(merge == [], f"partitioned query, merge: routes {merge}")
    again, times[f"partitioned, {routes[0]} buckets, again"], _, _ = run("default again")
    check(again == routes, f"partitioned query, default again: routes {again}")
    print("[relational] partitioned query by route (same rows, every group equal to "
          "np.bincount): " + ", ".join(f"{k} {v:.3f} s" for k, v in times.items())
          + f" [{card}]", flush=True)
    return launches


def check_subnormals(card: str) -> None:
    """f32 subnormals through device_eval on the card: 3e-39 * 2.0,
    3e-39 > 0.0, 1e-20 * 1e-20 and 3e-39 + 0.0 against numpy's values, which
    keep them. Prints whether CUDA keeps or flushes them; the route must be
    the device's."""
    import numpy as np

    import daft_tpu_torch as dt
    from daft_tpu_torch.ops import device_eval as de

    n = 4096
    data = {"d": np.full(n, 3e-39, np.float32), "s": np.full(n, 1e-20, np.float32)}
    exprs = {"d * 2.0": (dt.col("d") * 2.0, np.float32(3e-39) * np.float32(2)),
             "d > 0.0": (dt.col("d") > 0.0, True),
             "s * s": (dt.col("s") * dt.col("s"), np.float32(1e-20) * np.float32(1e-20)),
             "d + 0.0": (dt.col("d") + 0.0, np.float32(3e-39))}
    rb = dt.RecordBatch.from_pydict({k: dt.Series.from_numpy(v, k) for k, v in data.items()})
    kept = {}
    with dt.execution_config_ctx(device_eval_min_rows=1):
        de.device_eval_counters.reset()
        for i, (label, (expr, want)) in enumerate(exprs.items()):
            got = de.try_evaluate_fused(rb, [expr.alias(f"r{i}")._expr])
            check(got is not None, f"subnormals: {label} did not run on the card")
            kept[label] = bool((got[0].to_numpy() == want).all())
    flushed = [k for k, ok in kept.items() if not ok]
    print(f"[relational] f32 subnormals on the card ({n} rows each): "
          + ", ".join(f"{k} {'kept' if ok else 'flushed'}" for k, ok in kept.items())
          + (f"; CUDA flushes on {flushed} (ROADMAP C.22)" if flushed else
             "; CUDA keeps them, as the JAX package's host path does") + f" [{card}]", flush=True)


def check_relational_routes(card: str, cols: dict) -> None:
    """q01's projection under its filter on the card (the compiled chain), the
    same projection through device_eval (compiled_eval_enabled=False), and
    the host route (device_eval=False): bit-equal with f32-typed literals; the
    largest gap in f32 roundings is printed for Python literals."""
    import numpy as np

    import daft_tpu_torch as dt
    from daft_tpu_torch.ops import device_eval as de

    df = dt.from_pydict(cols)
    c = dt.col

    def proj(one):
        price, disc = c("l_extendedprice"), c("l_discount")
        return {"disc_price": price * (one - disc),
                "charge": price * (one - disc) * (one + c("l_tax"))}

    def routes(one):
        out = {}
        for route, cfg in (("chain", {}), ("device_eval", {"compiled_eval_enabled": False}),
                           ("host", {"compiled_eval_enabled": False, "device_eval": False})):
            de.device_eval_counters.reset()
            with dt.execution_config_ctx(**cfg):
                out[route] = (
                    df.where(c("l_quantity") < 48).with_columns(proj(one)).to_pydict(),
                    df.with_columns(proj(one)).select("disc_price", "charge").to_pydict())
            out[route] += (de.device_eval_counters.snapshot(),)
        return out

    f32_one = dt.lit(1.0, dt.DataType.float32())
    exact = routes(f32_one)
    n = len(cols["l_quantity"])
    check(exact["chain"][2]["chain_rows"] == {"filter_project": 2 * n},
          f"q01 chain: not every row ran in the device chain: {exact['chain'][2]}")
    kept = len(exact["chain"][0]["disc_price"])
    check(exact["device_eval"][2]["fused_rows"] == 2 * (kept + n) and
          not exact["device_eval"][2]["chain_rows"],
          f"q01 projection: device_eval did not take it: {exact['device_eval'][2]}")
    for route in ("chain", "device_eval"):
        for got, want in zip(exact[route][:2], exact["host"][:2]):
            for k in got:
                check(np.asarray(got[k]).tobytes() == np.asarray(want[k]).tobytes(),
                      f"q01 {route}: column {k} differs from the host route")
    weak = routes(1)
    gap = 0
    for route in ("chain", "device_eval"):
        for got, want in zip(weak[route][:2], weak["host"][:2]):
            for k in ("disc_price", "charge"):
                a = np.asarray(got[k], dtype=np.float32)
                b = np.asarray(want[k], dtype=np.float32)
                gap = max(gap, int(np.abs(a.view(np.int32).astype(np.int64)
                                          - b.view(np.int32).astype(np.int64)).max()))
    check(gap <= 2, f"q01 with Python literals: the device is {gap} f32 steps from the host")
    print(f"[relational] q01 projection on {n} rows ({kept} kept by l_quantity < 48): the device "
          f"chain and device_eval equal the host route bit for bit with f32 literals; with Python "
          f"literals (f64 intermediates on the host) the largest gap is {gap} f32 step(s) [{card}]",
          flush=True)


def check_cosine_scan(card: str) -> None:
    """cosine_distance of EMBED_ROWS x EMBED_DIM f32 embeddings against a
    query vector (a column of the query repeated: a literal vector takes the
    host route, as in the JAX package), and a where on it: card and CPU."""
    import numpy as np
    import torch

    import daft_tpu_torch as dt
    from daft_tpu_torch.ops import device_eval as de

    rng = np.random.default_rng(8)
    emb = rng.standard_normal((EMBED_ROWS, EMBED_DIM), dtype=np.float32)
    query = rng.standard_normal(EMBED_DIM, dtype=np.float32)
    dtype = dt.DataType.embedding(dt.DataType.float32(), EMBED_DIM)
    df = dt.from_pydict({
        "id": np.arange(EMBED_ROWS, dtype=np.int64),
        "e": dt.Series.from_numpy(emb, "e", dtype),
        "q": dt.Series.from_numpy(np.broadcast_to(query, emb.shape), "q", dtype)})
    del emb
    dist = dt.col("e").embedding.cosine_distance(dt.col("q"))

    def run():
        de.device_eval_counters.reset()
        t0 = time.perf_counter()
        d = np.asarray(df.select(dist.alias("d")).to_pydict()["d"])
        t1 = time.perf_counter()
        kept = df.with_column("d", dist).where(dt.col("d") < COSINE_KEEP).select("id", "d").to_pydict()
        return d, kept, t1 - t0, time.perf_counter() - t1, de.device_eval_counters.snapshot()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    d_gpu, kept_gpu, d_s, where_s, snap = run()
    peak = torch.cuda.max_memory_allocated()
    # The distance resolves to f64 (computed in f32, cast up after the
    # fetch), which only device_eval takes: each query's distances run there,
    # and the where compares the fetched f64 distances on the host, as in
    # the JAX package.
    check(snap["fused_rows"] == 2 * EMBED_ROWS and not snap["chain_rows"],
          f"cosine scan: the distances did not all run on the card: {snap}")
    with dt.execution_config_ctx(device="cpu"):
        d_cpu, kept_cpu, cpu_s, _, _ = run()
    err = float(np.abs(d_gpu - d_cpu).max())
    ids_gpu, ids_cpu = set(kept_gpu["id"]), set(kept_cpu["id"])
    edge = set(np.flatnonzero(np.abs(d_cpu - COSINE_KEEP) <= COSINE_TOL).tolist())
    print(f"[relational] cosine_distance of {EMBED_ROWS} x {EMBED_DIM} f32 embeddings: card "
          f"{d_s:.3f} s ({EMBED_ROWS * EMBED_DIM * 8 / d_s / 1e9:.2f} GB/s of the two columns), "
          f"where d < {COSINE_KEEP}: {where_s:.3f} s, {len(ids_gpu)} rows kept; CPU {cpu_s:.3f} s; "
          f"card vs CPU max_abs_err {err:.3e} (tol {COSINE_TOL}); peak device memory "
          f"{peak / 1e9:.3f} GB [{card}]", flush=True)
    check(bool(np.isfinite(d_gpu).all()) and d_gpu.shape == (EMBED_ROWS,),
          "cosine scan: distances not finite or of the wrong shape")
    check(err <= COSINE_TOL, f"cosine scan: card and CPU differ by {err}")
    check(ids_gpu ^ ids_cpu <= edge, f"cosine scan: the where kept other rows on the card "
          f"({len(ids_gpu ^ ids_cpu)} differ, {len(edge)} within {COSINE_TOL} of the threshold)")
    got = dict(zip(kept_gpu["id"], kept_gpu["d"]))
    check(all(abs(got[i] - d_cpu[i]) <= COSINE_TOL for i in ids_gpu & ids_cpu),
          "cosine scan: a kept row's distance differs from the CPU's")


def hf_shapes(cfg: dict) -> dict:
    """HF state-dict key -> shape for the published ``config.json`` ``cfg``
    (BertModel with its pooler, or CLIPModel)."""
    shapes: dict = {}

    def linear(name, n_out, n_in):
        shapes[f"{name}.weight"], shapes[f"{name}.bias"] = (n_out, n_in), (n_out,)

    def norm(name, n):
        shapes[f"{name}.weight"], shapes[f"{name}.bias"] = (n,), (n,)

    if cfg["model_type"] == "bert":
        h, f = cfg["hidden_size"], cfg["intermediate_size"]
        for e, rows in (("word", "vocab_size"), ("position", "max_position_embeddings"),
                        ("token_type", "type_vocab_size")):
            shapes[f"embeddings.{e}_embeddings.weight"] = (cfg[rows], h)
        norm("embeddings.LayerNorm", h)
        for i in range(cfg["num_hidden_layers"]):
            p = f"encoder.layer.{i}"
            for n in ("attention.self.query", "attention.self.key", "attention.self.value",
                      "attention.output.dense"):
                linear(f"{p}.{n}", h, h)
            linear(f"{p}.intermediate.dense", f, h)
            linear(f"{p}.output.dense", h, f)
            norm(f"{p}.attention.output.LayerNorm", h)
            norm(f"{p}.output.LayerNorm", h)
        linear("pooler.dense", h, h)
        return shapes
    tc, vc = cfg["text_config"], cfg["vision_config"]
    for tower, c in (("text_model", tc), ("vision_model", vc)):
        h, f = c["hidden_size"], c["intermediate_size"]
        for i in range(c["num_hidden_layers"]):
            p = f"{tower}.encoder.layers.{i}"
            for n in "qkv":
                linear(f"{p}.self_attn.{n}_proj", h, h)
            linear(f"{p}.self_attn.out_proj", h, h)
            linear(f"{p}.mlp.fc1", f, h)
            linear(f"{p}.mlp.fc2", h, f)
            norm(f"{p}.layer_norm1", h)
            norm(f"{p}.layer_norm2", h)
    shapes["text_model.embeddings.token_embedding.weight"] = (tc["vocab_size"], tc["hidden_size"])
    shapes["text_model.embeddings.position_embedding.weight"] = (
        tc["max_position_embeddings"], tc["hidden_size"])
    norm("text_model.final_layer_norm", tc["hidden_size"])
    w, p = vc["hidden_size"], vc["patch_size"]
    shapes["vision_model.embeddings.class_embedding"] = (w,)
    shapes["vision_model.embeddings.patch_embedding.weight"] = (w, 3, p, p)
    shapes["vision_model.embeddings.position_embedding.weight"] = (
        (vc["image_size"] // p) ** 2 + 1, w)
    norm("vision_model.pre_layrnorm", w)  # the released checkpoints' spelling
    norm("vision_model.post_layernorm", w)
    shapes["visual_projection.weight"] = (cfg["projection_dim"], w)
    shapes["text_projection.weight"] = (cfg["projection_dim"], tc["hidden_size"])
    shapes["logit_scale"] = ()
    return shapes


def hf_random_state_dict(shapes: dict, seed: int) -> dict:
    """Seeded random f32 tensors on the host: normal(0.02) for biases and
    embeddings, 1 + normal(0.02) for LayerNorm weights, variance 1/fan_in
    for the other weights, log(100) for ``logit_scale``."""
    import torch

    gen = torch.Generator("cuda").manual_seed(seed)
    sd = {}
    for name, shape in shapes.items():
        x = torch.randn(shape, generator=gen, device="cuda")
        if name == "logit_scale":
            x = torch.tensor(math.log(100.0))
        elif name.endswith(".bias") or ("embedding" in name and "patch" not in name):
            x = x * 0.02
        elif len(shape) == 1:
            x = 1 + 0.02 * x
        else:
            x = x / math.sqrt(math.prod(shape[1:]))
        sd[name] = x.cpu()
    return sd


def write_wordpiece_vocab(path, size: int, seed: int) -> None:
    """A ``vocab.txt`` of ``size`` entries laid out like BERT's (``[PAD]``,
    99 unused, ``[UNK] [CLS] [SEP] [MASK]``, then the pieces) that covers
    WORD_LIST: every other word of more than three letters only as a prefix
    and a ``##`` continuation, the rest whole; seeded filler pieces."""
    import numpy as np

    special = ["[PAD]"] + [f"[unused{i}]" for i in range(99)] + ["[UNK]", "[CLS]", "[SEP]",
                                                                    "[MASK]"]
    pieces = []
    for i, w in enumerate(sorted(set(WORD_LIST))):
        pieces += [w[:2], "##" + w[2:]] if len(w) > 3 and i % 2 else [w]
    pieces = list(dict.fromkeys(pieces))
    body = pieces + [f"piece{i}" for i in range(size - len(special) - len(pieces))]
    np.random.default_rng(seed).shuffle(body)
    path.write_text("\n".join(special + body) + "\n")


def write_clip_bpe(directory, size: int, seed: int) -> None:
    """A ``vocab.json`` + ``merges.txt`` of ``size`` entries laid out like
    CLIP's: the 256 byte characters and each with ``</w>``, the merges'
    products and seeded filler pieces, then ``<|startoftext|>`` and
    ``<|endoftext|>`` at ``size`` - 2 and ``size`` - 1. Each word of
    WORD_LIST is merged left to right."""
    import numpy as np

    from daft_tpu_torch.utils.tokenizer import _bytes_to_unicode

    chars = list(_bytes_to_unicode().values())
    merges = []
    for w in sorted(set(WORD_LIST)):
        parts = list(w[:-1]) + [w[-1] + "</w>"]
        while len(parts) > 1:
            merges.append((parts[0], parts[1]))
            parts = [parts[0] + parts[1]] + parts[2:]
    merges = list(dict.fromkeys(merges))
    body = list(dict.fromkeys(a + b for a, b in merges))
    body += [f"piece{i}</w>" for i in range(size - 2 - 2 * len(chars) - len(body))]
    np.random.default_rng(seed).shuffle(body)
    tokens = chars + [c + "</w>" for c in chars] + body + ["<|startoftext|>", "<|endoftext|>"]
    (directory / "vocab.json").write_text(json.dumps({t: i for i, t in enumerate(tokens)}))
    (directory / "merges.txt").write_text(
        "#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))


def write_hf_dir(directory, cfg: dict, seed: int) -> dict:
    """A local HF checkpoint directory: ``config.json``, the seeded random
    state dict as ``pytorch_model.bin`` (f32) and the tokenizer files.
    Returns the state dict."""
    import torch

    directory.mkdir()
    (directory / "config.json").write_text(json.dumps(cfg, indent=2))
    sd = hf_random_state_dict(hf_shapes(cfg), seed)
    torch.save(sd, directory / "pytorch_model.bin")
    if cfg["model_type"] == "bert":
        write_wordpiece_vocab(directory / "vocab.txt", cfg["vocab_size"], seed)
    else:
        write_clip_bpe(directory, cfg["text_config"]["vocab_size"], seed)
    return sd


def hf_expected_params(sd: dict, tower: str = "") -> dict:
    """The port's parameter name -> the tensor an HF state dict gives it,
    after the layout changes: per CLIP block the q, k, v weights stacked into
    ``qkv``, the patch conv (w, 3, p, p) as a (w, p*p*3) patchify weight, the
    class and position embeddings with their leading axes. ``tower`` is ""
    for BERT, "vision" or "text" for a CLIP tower."""
    import torch

    if not tower:
        # Prefixes first (only at the start of a key), then the layer parts.
        renames = (("embeddings.LayerNorm", "emb_ln"), ("embeddings.", ""),
                   ("encoder.layer.", "layers."), ("attention.self.query", "q"),
                   ("attention.self.key", "k"), ("attention.self.value", "v"),
                   ("attention.output.LayerNorm", "attn_ln"),
                   ("attention.output.dense", "attn_out"),
                   ("intermediate.dense", "fc1"), ("output.LayerNorm", "out_ln"),
                   ("output.dense", "fc2"))
        out = {}
        for k, v in sd.items():
            if k.startswith("pooler."):
                continue
            for a, b in renames:
                k = b + k[len(a):] if k.startswith(a) else k.replace(a, b)
            out[k] = v
        return out
    src = "vision_model" if tower == "vision" else "text_model"
    out = {}
    blocks = {k for k in sd if k.startswith(f"{src}.encoder.layers.")}
    for k in blocks:
        i, rest = k[len(f"{src}.encoder.layers."):].split(".", 1)
        rest = (rest.replace("layer_norm1", "ln1").replace("layer_norm2", "ln2")
                .replace("self_attn.out_proj", "attn.out"))
        if "_proj" in rest:
            continue
        out[f"blocks.{i}.{rest}"] = sd[k]
    for i in {k.split(".")[3] for k in blocks}:
        for leaf in ("weight", "bias"):
            out[f"blocks.{i}.attn.qkv.{leaf}"] = torch.cat(
                [sd[f"{src}.encoder.layers.{i}.self_attn.{x}_proj.{leaf}"] for x in "qkv"])
    e = f"{src}.embeddings"
    if tower == "vision":
        conv = sd[f"{e}.patch_embedding.weight"]
        out.update({"cls": sd[f"{e}.class_embedding"][None, None],
                    "pos_embed": sd[f"{e}.position_embedding.weight"][None],
                    "patch_embed.weight": conv.permute(0, 2, 3, 1).reshape(conv.shape[0], -1),
                    "proj.weight": sd["visual_projection.weight"]})
        pairs = (("ln_pre", "pre_layrnorm"), ("ln_post", "post_layernorm"))
    else:
        out.update({"tok_embed.weight": sd[f"{e}.token_embedding.weight"],
                    "pos_embed": sd[f"{e}.position_embedding.weight"][None],
                    "proj.weight": sd["text_projection.weight"]})
        pairs = (("ln_final", "final_layer_norm"),)
    for ours, theirs in pairs:
        for leaf in ("weight", "bias"):
            out[f"{ours}.{leaf}"] = sd[f"{src}.{theirs}.{leaf}"]
    return out


def check_hf_params(name: str, module, expected: dict) -> float:
    """Every parameter of ``module`` equals its HF tensor rounded to the
    parameter's dtype, and every one has an HF tensor. Returns the seconds
    the check took."""
    t0 = time.perf_counter()
    params = dict(module.named_parameters())
    check(set(params) == set(expected),
          f"{name}: parameters without an HF tensor {sorted(set(params) - set(expected))[:4]}, "
          f"HF tensors without a parameter {sorted(set(expected) - set(params))[:4]}")
    for k, p in params.items():
        want = expected[k].to(p.dtype).to(p.device)
        check(tuple(p.shape) == tuple(want.shape) and bool((p == want).all()),
              f"{name}: parameter {k} differs from its HF tensor")
    print(f"[{name}] the {len(params)} converted parameters equal their HF tensors "
          f"({sum(p.numel() for p in params.values())} values)", flush=True)
    return time.perf_counter() - t0


def phase_hf(card: str) -> dict:
    """Local HF checkpoints at the published widths through the engine;
    returns the launch counts of each path by name."""
    import gc
    import pathlib
    import tempfile

    import numpy as np
    import torch

    import daft_tpu_torch as dt
    from daft_tpu_torch.functions.ai import classify_text, embed_image, embed_text
    from daft_tpu_torch.models.convert import load_hf_checkpoint

    texts = make_texts(NUM_TEXTS, seed=2)  # phase 5's strings
    empty = np.array([t == "" for t in texts])
    df = dt.from_pydict({"t": texts})
    by_path = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        bert_dir, clip_dir = pathlib.Path(tmp) / "all-MiniLM-L6-v2", pathlib.Path(tmp) / "clip"
        bert_sd = write_hf_dir(bert_dir, HF_MINILM_CONFIG, seed=10)
        clip_sd = write_hf_dir(clip_dir, HF_CLIP_CONFIG, seed=11)
        sizes = {d.name: sum(f.stat().st_size for f in d.iterdir()) for d in (bert_dir, clip_dir)}
        print(f"[hf] wrote two checkpoint directories in {time.perf_counter() - t0:.1f} s: "
              + ", ".join(f"{k} {v / 1e9:.3f} GB" for k, v in sizes.items()), flush=True)

        # Conversion alone, and the converted parameters against the HF tensors.
        for name, path, sd, tower in (("hf BERT", bert_dir, bert_sd, ""),
                                      ("hf CLIP vision", clip_dir, clip_sd, "vision"),
                                      ("hf CLIP text", clip_dir, clip_sd, "text")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, module = load_hf_checkpoint(str(path), torch.bfloat16, "cuda", tower or None)
            torch.cuda.synchronize()
            convert_s = time.perf_counter() - t0
            print(f"[{name}] load and convert onto the card: {convert_s:.2f} s [{card}]",
                  flush=True)
            check_hf_params(name, module, hf_expected_params(sd, tower))
            del module
        del bert_sd, clip_sd
        gc.collect()
        torch.cuda.empty_cache()

        name = "hf embed_text all-MiniLM-L6-v2"
        expr = embed_text(dt.col("t"), weights_path=str(bert_dir))
        out, launches, inst, _ = engine_run(card, name, df, NUM_TEXTS, expr, warm_rows=512)
        emb = np.asarray(out, dtype=np.float32)
        norms = np.linalg.norm(emb, axis=1)
        check(type(inst.encoder).__name__ == "BertEncoder" and
              type(inst.tokenizer).__name__ == "WordPieceTokenizer",
              f"{name}: served {type(inst.encoder).__name__} behind "
              f"{type(inst.tokenizer).__name__}")
        check(emb.shape == (NUM_TEXTS, 384) and bool(np.isfinite(emb).all()),
              f"{name}: embeddings {emb.shape}, or not finite")
        check(bool(np.abs(norms[~empty] - 1).max() < 1e-3) and not emb[empty].any(),
              f"{name}: rows not unit-norm, or an empty string's row not zero")
        check(launches["flash_attention"] == 0,
              f"{name}: flash_attention launched {launches['flash_attention']} times")
        err = float(np.abs(inst.embed_text(texts[-512:]) - emb[-512:]).max())
        print(f"[{name}] engine chunk vs direct forward: max_abs_err {err:.3e} (tol "
              f"{CHUNK_TOL}); {int(empty.sum())} empty strings give zero vectors", flush=True)
        check(err <= CHUNK_TOL, f"{name}: engine chunk differs from a direct forward by {err}")
        check_staged_tokens(name, inst, texts[:1024])
        check_text_tower(name, inst, texts, emb)
        head = df.limit(512)
        trace_window(card, f"trace {name}", "one chunk of 512 strings",
                     lambda: head.with_column("out", expr).collect())
        by_path[name] = launches
        del inst, expr, out
        gc.collect()
        torch.cuda.empty_cache()

        name = "hf embed_image ViT-L/14"
        rng = np.random.default_rng(0)
        imgs = rng.integers(0, 256, (NUM_IMAGES, IMAGE * IMAGE * 3), dtype=np.uint8)
        idf = dt.from_pydict({"img": dt.Series.from_numpy(
            imgs, "img", dt.DataType.image("RGB", IMAGE, IMAGE))})
        expr = embed_image(dt.col("img"), weights_path=str(clip_dir), batch_size=BATCH)
        out, launches, inst, _ = engine_run(card, name, idf, NUM_IMAGES, expr, warm_rows=BATCH)
        emb = np.asarray(out, dtype=np.float32)
        chunks = math.ceil(NUM_IMAGES / BATCH)
        check(inst.cfg.hidden_act == "quick_gelu" and inst.cfg.ln_eps == 1e-5,
              f"{name}: the converted config has {inst.cfg.hidden_act}, eps {inst.cfg.ln_eps}")
        check(emb.shape == (NUM_IMAGES, 768) and bool(np.isfinite(emb).all()),
              f"{name}: embeddings {emb.shape}, or not finite")
        check(bool(np.abs(np.linalg.norm(emb, axis=1) - 1).max() < 1e-3), f"{name}: not unit-norm")
        check(launches["flash_attention"] == VIT_L_LAYERS * chunks,
              f"{name}: flash_attention launched {launches['flash_attention']} times, expected "
              f"{VIT_L_LAYERS} x {chunks}")
        direct = inst.forward(torch.from_numpy(
            imgs[:BATCH].reshape(BATCH, IMAGE, IMAGE, 3)).cuda()).cpu().numpy()
        err = float(np.abs(direct - emb[:BATCH]).max())
        print(f"[{name}] flash_attention launches {launches['flash_attention']} for {chunks} "
              f"chunk(s); engine chunk vs direct forward: max_abs_err {err:.3e} (tol "
              f"{CHUNK_TOL})", flush=True)
        check(err <= CHUNK_TOL, f"{name}: engine chunk differs from a direct forward by {err}")
        check_image_tower(name, inst, imgs[:2].reshape(2, IMAGE, IMAGE, 3), emb[:2])
        head = idf.limit(BATCH)
        trace_window(card, f"trace {name}", f"one chunk of {BATCH} images",
                     lambda: head.with_column("out", expr).collect())
        by_path[name] = launches
        del inst, expr, out
        gc.collect()
        torch.cuda.empty_cache()

        name = "hf classify_text ViT-L/14"
        expr = classify_text(dt.col("t"), LABELS, weights_path=str(clip_dir))
        out, launches, inst, _ = engine_run(card, name, df, NUM_TEXTS, expr, warm_rows=512)
        tower = inst.text_embedder
        check(tower.encoder.cfg.text_pool == "argmax_id" and
              type(tower.tokenizer).__name__ == "MergesBPETokenizer",
              f"{name}: pools by {tower.encoder.cfg.text_pool} behind "
              f"{type(tower.tokenizer).__name__}")
        emb = tower.embed_text(texts)
        check(bool(np.isfinite(emb).all()) and
              bool(np.abs(np.linalg.norm(emb, axis=1) - 1).max() < 1e-3),
              f"{name}: text embeddings not finite or not unit-norm")
        sims = emb @ tower.embed_text(LABELS).T
        check(out == [LABELS[i] for i in sims.argmax(axis=1)],
              f"{name}: engine labels differ from a direct forward")
        check(launches["flash_attention"] == 0,
              f"{name}: flash_attention launched {launches['flash_attention']} times")
        print(f"[{name}] labels equal a direct forward; {len(set(out))} distinct", flush=True)
        check_staged_tokens(name, tower, texts[:1024])
        check_text_tower(name, tower, texts, emb)
        by_path[name] = launches
        del inst, expr, tower
        gc.collect()
        torch.cuda.empty_cache()
    return by_path


def make_encoded(n: int, seed: int) -> list:
    """``n`` seeded encoded photos: the short side drawn from ``SIDES``, the
    aspect from ``ASPECTS``, smooth per-channel gradients plus noise (so the
    JPEG sizes are those of photos, not of flat or random images); JPEG at
    ``JPEG_QUALITY`` but every ``PNG_EVERY``-th PNG, row ``GRAY_ROW`` a
    grayscale JPEG, ``RGBA_ROW`` an RGBA PNG, ``NULL_ROW`` null and
    ``CORRUPT_ROW`` a JPEG header over garbage. The draws are made in order;
    the images are encoded on a thread pool (PIL and numpy release the GIL)."""
    import io
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    top = int(SIDES[1] * ASPECTS[1]) + 1
    noise = rng.integers(-20, 21, (top, top, 4), dtype=np.int16)
    draws = []
    for _ in range(n):
        short = int(rng.integers(SIDES[0], SIDES[1] + 1))
        aspect = float(rng.uniform(*ASPECTS))
        h, w = (short, round(short * aspect)) if aspect >= 1 else (round(short / aspect), short)
        draws.append((h, w, rng.uniform(-160, 160, (2, 4)).astype(np.float32),
                      rng.uniform(60, 200, 4).astype(np.float32),
                      int(rng.integers(0, top - h + 1)), int(rng.integers(0, top - w + 1))))
    garbage = rng.bytes(4096)

    def encode(i: int):
        if i == NULL_ROW:
            return None
        if i == CORRUPT_ROW:
            return b"\xff\xd8\xff\xe0" + garbage
        h, w, slope, level, oy, ox = draws[i]
        ramp = (level + slope[0] * np.linspace(0, 1, h, dtype=np.float32)[:, None, None]
                + slope[1] * np.linspace(0, 1, w, dtype=np.float32)[None, :, None])
        pixels = np.clip(ramp + noise[oy:oy + h, ox:ox + w], 0, 255).astype(np.uint8)
        buf = io.BytesIO()
        if i == RGBA_ROW:
            Image.fromarray(pixels, "RGBA").save(buf, format="PNG")
        elif i == GRAY_ROW:
            Image.fromarray(pixels[..., 0], "L").save(buf, format="JPEG", quality=JPEG_QUALITY)
        elif i % PNG_EVERY == PNG_EVERY - 1:
            Image.fromarray(pixels[..., :3], "RGB").save(buf, format="PNG")
        else:
            Image.fromarray(pixels[..., :3], "RGB").save(buf, format="JPEG",
                                                         quality=JPEG_QUALITY)
        return buf.getvalue()

    with ThreadPoolExecutor(8) as pool:
        return list(pool.map(encode, range(n)))


def pil_decode_resize(raw: bytes):
    """PIL's own decode to RGB and bilinear resize to IMAGE x IMAGE."""
    import io

    import numpy as np
    from PIL import Image

    img = Image.open(io.BytesIO(raw))
    img = img if img.mode == "RGB" else img.convert("RGB")
    return np.asarray(img.resize((IMAGE, IMAGE), Image.BILINEAR))


def image_column(df, name: str):
    """Column ``name`` of ``df``'s result as one Series (to_pydict would
    turn every pixel into a Python int)."""
    from daft_tpu_torch.micropartition import MicroPartition

    return MicroPartition.concat(list(df.iter_partitions())).combined().get_column(name)


def uint8_close(a, b) -> tuple:
    """(largest gap in levels, share of values that differ)."""
    import numpy as np

    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    return int(d.max()), float((d > 0).mean())


def phase_image(card: str) -> dict:
    """Encoded photos through decode, resize and two models, and the card's
    fixed-shape resize; returns the launch counts of each model path."""
    import gc
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    import daft_tpu_torch as dt
    from daft_tpu_torch.functions.ai import embed_image
    from daft_tpu_torch.kernels import image_ops
    from daft_tpu_torch.kernels.registry import get_kernel
    from daft_tpu_torch.models import ResNet18, ResNetConfig, init_resnet_params
    from daft_tpu_torch.models.clip import embed
    from daft_tpu_torch.ops.flash_attention import flash_attention
    from daft_tpu_torch.udf import Udf

    phase_start = t0 = time.perf_counter()
    raw = make_encoded(NUM_ENCODED, seed=20)
    sizes = np.array([len(r) for r in raw if r is not None])
    print(f"[image] {NUM_ENCODED} encoded images in {time.perf_counter() - t0:.1f} s: "
          f"{sizes.sum() / 1e6:.1f} MB, {sizes.mean() / 1e3:.1f} kB per image "
          f"({sizes.min() / 1e3:.1f}..{sizes.max() / 1e3:.1f}) [{card}]", flush=True)
    bdf = dt.from_pydict({"b": raw})
    decode = dt.col("b").image.decode(mode="RGB", on_error="null")
    by_path = {}

    # Decode, then resize, each timed on the host (PIL, one thread). A
    # DataFrame built on a collected one plans from its source again, so
    # each later step starts from a new frame over the column it needs.
    with dt.execution_config_ctx(default_morsel_size=NUM_ENCODED):
        t0 = time.perf_counter()
        decoded = image_column(bdf.with_column("img", decode).select("img"), "img")
        decode_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        col = image_column(dt.from_pydict({"img": decoded}).with_column(
            "img", dt.col("img").image.resize(IMAGE, IMAGE)), "img")
        resize_s = time.perf_counter() - t0
    resized = dt.from_pydict({"img": col})
    pixels, mask = col.to_numpy_masked()
    check(repr(col.dtype) == f"Image[RGB; {IMAGE} x {IMAGE}]", f"resized column is {col.dtype!r}")
    check(mask is not None and np.flatnonzero(mask).tolist() == [NULL_ROW, CORRUPT_ROW],
          f"null rows {None if mask is None else np.flatnonzero(mask).tolist()}, expected "
          f"the null and the corrupt row")
    t0 = time.perf_counter()
    rows = [i for i in range(NUM_ENCODED) if i not in (NULL_ROW, CORRUPT_ROW)]
    with ThreadPoolExecutor(8) as pool:
        for i, want in zip(rows, pool.map(pil_decode_resize, [raw[i] for i in rows])):
            check(np.array_equal(pixels[i], want),
                  f"row {i}: engine decode + resize differs from PIL's")
    print(f"[image] decode {decode_s:.3f} s ({NUM_ENCODED / decode_s:.1f} rows/s), resize "
          f"{resize_s:.3f} s ({NUM_ENCODED / resize_s:.1f} rows/s) on the host; every row equals "
          f"PIL's own decode and resize ({time.perf_counter() - t0:.1f} s to check), rows "
          f"{NULL_ROW} (null) and {CORRUPT_ROW} (corrupt) null [{card}]", flush=True)

    # (a) bytes -> ViT-L/14 embeddings through the engine, and the forward alone.
    name = "image embed_image ViT-L/14"
    expr = embed_image(decode.image.resize(IMAGE, IMAGE), provider="cuda_random",
                       model="ViT-L/14", batch_size=BATCH)
    out, launches, inst, elapsed = engine_run(card, name, bdf, NUM_ENCODED, expr, warm_rows=BATCH)
    emb = np.asarray(out, dtype=np.float32)  # null rows embed as black images
    chunks = math.ceil(NUM_ENCODED / BATCH)
    check(launches["flash_attention"] == VIT_L_LAYERS * chunks,
          f"{name}: flash_attention launched {launches['flash_attention']} times, expected "
          f"{VIT_L_LAYERS} x {chunks}")
    check(emb.shape == (NUM_ENCODED, 768) and bool(np.isfinite(emb).all()),
          f"{name}: embeddings {emb.shape}, or not finite")
    fwd_expr = embed_image(dt.col("img"), provider="cuda_random", model="ViT-L/14",
                           batch_size=BATCH)
    fwd_expr._expr.udf._instance = inst
    with dt.execution_config_ctx(default_morsel_size=NUM_ENCODED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fwd = image_column(resized.with_column("emb", fwd_expr).select("emb"), "emb")
        forward_s = time.perf_counter() - t0
    direct = embed(inst.encoder, torch.tensor(pixels[:BATCH]).cuda()).cpu().numpy()
    err = float(np.abs(direct - emb[:BATCH]).max())
    same = float(np.abs(fwd.to_numpy() - emb).max())
    print(f"[{name}] bytes to embeddings {NUM_ENCODED / elapsed:.1f} rows/s; split: decode "
          f"{decode_s:.3f} s, resize {resize_s:.3f} s, forward {forward_s:.3f} s "
          f"({NUM_ENCODED / forward_s:.1f} rows/s from the resized column); flash_attention "
          f"launches {launches['flash_attention']} for {chunks} chunk(s); engine chunk vs direct "
          f"forward: max_abs_err {err:.3e} (tol {CHUNK_TOL}); the forward alone vs the whole "
          f"path: {same:.3e} [{card}]", flush=True)
    check(err <= CHUNK_TOL, f"{name}: engine chunk differs from a direct forward by {err}")
    check(same <= CHUNK_TOL, f"{name}: the forward alone differs from the whole path by {same}")
    by_path[name] = launches
    del inst, expr, fwd_expr, out
    gc.collect()
    torch.cuda.empty_cache()

    # (b) ResNet-18 at its default config as a batch UDF: the top-1 class.
    name = "image ResNet-18"
    cfg = ResNetConfig()
    model = init_resnet_params(cfg, seed=21).eval()
    params = sum(p.numel() for p in model.parameters())

    @torch.no_grad()
    def top1(s):
        x = torch.from_numpy(np.require(s.to_numpy(), requirements=("C", "W"))).cuda()
        return model(x).argmax(dim=1).to(torch.int64).cpu().numpy()

    classify = Udf(top1, dt.DataType.int64(), name="resnet18_top1", batch_size=RESNET_BATCH)
    with dt.execution_config_ctx(default_morsel_size=RESNET_BATCH):
        resized.limit(RESNET_BATCH).with_column("cls", classify(dt.col("img"))).collect()  # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        flash_attention.launch_count = 0
        t0 = time.perf_counter()
        classes = resized.with_column("cls", classify(dt.col("img"))).select(
            "cls").to_pydict()["cls"]
        torch.cuda.synchronize()
        udf_s = time.perf_counter() - t0
        launches = {"flash_attention": flash_attention.launch_count}
        peak = torch.cuda.max_memory_allocated()
    bound_s = 2 * resnet_macs(cfg, IMAGE) * NUM_ENCODED / PEAK_OPS_PER_S["bfloat16"]
    print(f"[{name}] {params} parameters; the UDF over {NUM_ENCODED} resized rows in "
          f"{udf_s:.3f} s = {NUM_ENCODED / udf_s:.1f} rows/s (bound at the bf16 peak "
          f"{bound_s * 1e3:.2f} ms); bytes to classes, the sum of the decode, resize and UDF "
          f"times: {NUM_ENCODED / (decode_s + resize_s + udf_s):.1f} rows/s; peak device memory {peak / 1e9:.3f} GB; "
          f"launches {launches}; {len(set(c for c in classes if c is not None))} distinct "
          f"class(es) [{card}]", flush=True)
    check(len(classes) == NUM_ENCODED and all(isinstance(c, int) and 0 <= c < cfg.num_classes
                                              for c in classes),
          f"{name}: classes out of range or missing")
    check(launches["flash_attention"] == 0,
          f"{name}: flash_attention launched {launches['flash_attention']} times")
    head = resized.limit(RESNET_BATCH)
    with dt.execution_config_ctx(default_morsel_size=RESNET_BATCH):
        trace_window(card, f"trace {name}", f"one batch of {RESNET_BATCH} images",
                     lambda: head.with_column("cls", classify(dt.col("img"))).collect())
    sample = torch.tensor(pixels[8:8 + RESNET_CPU_ROWS])
    cpu = ResNet18(cfg, device="cpu")
    cpu.load_state_dict(model.state_dict())
    with torch.no_grad():
        card_logits = model(sample.cuda()).float().cpu().numpy()
        cpu_logits = cpu(sample).float().numpy()
    cos = cosines(card_logits, cpu_logits)
    print(f"[{name}] card vs CPU logits on {RESNET_CPU_ROWS} images: cosine {cos.min():.6f} "
          f"(min {CPU_COSINE_MIN}), max_abs_err {np.abs(card_logits - cpu_logits).max():.3e} "
          f"of |logit| <= {np.abs(cpu_logits).max():.1f}; top-1 {card_logits.argmax(1).tolist()} "
          f"vs {cpu_logits.argmax(1).tolist()} [{card}]", flush=True)
    check(bool(cos.min() >= CPU_COSINE_MIN), f"{name}: card and CPU logits disagree: {cos}")
    check(np.array_equal(card_logits.argmax(1), cpu_logits.argmax(1)),
          f"{name}: card and CPU top-1 differ")
    check(classes[8:8 + RESNET_CPU_ROWS] == card_logits.argmax(1).tolist(),
          f"{name}: the engine's classes differ from a direct forward")
    by_path[name] = launches
    del model, cpu, classify
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the card's fixed-shape resize: 1024 RGB rows of 256x256 -> 224x224.
    name = "image resize"
    rng = np.random.default_rng(22)
    vals = rng.integers(0, 256, (NUM_ENCODED, RESIZE_SIDE * RESIZE_SIDE * 3), dtype=np.uint8)
    series = dt.Series.from_numpy(vals, "img", dt.DataType.image("RGB", RESIZE_SIDE, RESIZE_SIDE))
    rdf = dt.from_pydict({"img": series})
    devices, batch_resize = [], image_ops._batch_resize

    def spy(batch, h, w):
        res = batch_resize(batch, h, w)
        devices.append(res.device.type)
        return res

    image_ops._batch_resize = spy
    try:
        with dt.execution_config_ctx(default_morsel_size=NUM_ENCODED):
            image_column(rdf.with_column("r", dt.col("img").image.resize(IMAGE, IMAGE)), "r")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = image_column(rdf.with_column("r", dt.col("img").image.resize(IMAGE, IMAGE)),
                               "r")
            engine_s = time.perf_counter() - t0
    finally:
        image_ops._batch_resize = batch_resize
    card_out = got.to_numpy()
    check(devices == ["cuda", "cuda"], f"{name}: the resize ran on {devices}")
    x = torch.from_numpy(vals.reshape(-1, RESIZE_SIDE, RESIZE_SIDE, 3)).cuda()
    check(np.array_equal(image_ops._resize_nhwc(x, IMAGE, IMAGE).cpu().numpy(), card_out),
          f"{name}: the engine's rows differ from a direct resize on the card")
    ms = time_ms(lambda: image_ops._resize_nhwc(x, IMAGE, IMAGE), iters=10)
    stage_ms = time_ms(lambda: torch.from_numpy(vals).cuda(), iters=5)
    bytes_moved = x.numel() + card_out.size
    bound_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    n, c = NUM_ENCODED, 3
    ops = 2 * n * c * (RESIZE_SIDE * RESIZE_SIDE * IMAGE + RESIZE_SIDE * IMAGE * IMAGE)
    with dt.execution_config_ctx(device="cpu"):
        cpu_out = get_kernel("image_resize")([series.slice(0, RESIZE_CPU_ROWS)],
                                             w=IMAGE, h=IMAGE).to_numpy()
    off, share = uint8_close(cpu_out, card_out[:RESIZE_CPU_ROWS])
    print(f"[{name}] {NUM_ENCODED} rows {RESIZE_SIDE}x{RESIZE_SIDE} -> {IMAGE}x{IMAGE} RGB on "
          f"{devices[-1]}: engine {engine_s:.3f} s; on the card {ms:.4f} ms (CUDA events, the "
          f"batch resident), host->device of the batch {stage_ms:.3f} ms; byte bound "
          f"{bound_ms:.4f} ms ({bytes_moved / 1e6:.1f} MB at {HBM_BYTES_PER_S / 1e12:.2f} TB/s), "
          f"the dense contraction's {ops / 1e9:.1f} GFLOP take "
          f"{ops / PEAK_OPS_PER_S['float32'] * 1e3:.3f} ms at the f32 peak; "
          f"{RESIZE_CPU_ROWS} rows vs the CPU route: {off} level(s) on {share:.2e} of values "
          f"(tol {RESIZE_MAX_OFF} on < {RESIZE_OFF_SHARE}) [{card}]", flush=True)
    check(off <= RESIZE_MAX_OFF and share < RESIZE_OFF_SHARE,
          f"{name}: card and CPU routes differ by {off} levels on {share:.2%} of values")
    trace_window(card, f"trace {name}", f"{NUM_ENCODED} rows resized by the engine",
                 lambda: image_column(rdf.with_column(
                     "r", dt.col("img").image.resize(IMAGE, IMAGE)), "r"))
    print(f"[image] phase 9 took {time.perf_counter() - phase_start:.1f} s [{card}]", flush=True)
    return by_path


def resnet_macs(cfg, size: int) -> int:
    """Multiply-adds of one ``size``-square image through ResNet-18's
    convolutions and head (BatchNorm, pooling and the adds left out)."""
    def conv(s_in, c_in, c_out, k, stride):
        s_out = (s_in + 2 * (k // 2) - k) // stride + 1
        return s_out, s_out * s_out * c_out * c_in * k * k

    s, macs = conv(size, 3, cfg.width, 7, 2)
    s, c_in = (s + 2 - 3) // 2 + 1, cfg.width
    for i, n_blocks in enumerate(cfg.stage_sizes):
        filters = cfg.width * 2 ** i
        for j in range(n_blocks):
            stride = 2 if (i > 0 and j == 0) else 1
            s_out, m0 = conv(s, c_in, filters, 3, stride)
            _, m1 = conv(s_out, filters, filters, 3, 1)
            macs += m0 + m1
            if stride != 1 or c_in != filters:
                macs += conv(s, c_in, filters, 1, stride)[1]
            s, c_in = s_out, filters
    return macs + c_in * cfg.num_classes


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    start = time.perf_counter()
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
        by_path.update(phase_relational(card))
        by_path.update(phase_hf(card))
        by_path.update(phase_image(card))
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
    print(f"[run] every phase passed in {time.perf_counter() - start:.1f} s [{card}]", flush=True)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
