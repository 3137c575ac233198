"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

After each phase it prints the lines of this script where the main thread
spent the phase's wall (sampled every 50 ms). Run from the root of a
checkout on a machine with an NVIDIA GPU, nvcc and PyTorch built for CUDA.
Phases, each of which fails the run on any error:

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
   agrees with the same tower on the CPU (cosine >= 0.99; 16 seeded non-empty
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
   after the scan, held to one set per worker (a set: one buffer per staged
   column of the largest padded chunk), and must fall to 0 after
   ``reset_programs``; a column of f32 subnormals
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
10. relational joins, sort and TopN (``daft_tpu_torch/tools/tpch.py``): SF1's
   customer (150,000 rows), orders (1,500,000) and lineitem (about
   6,000,000; the draw's count is printed) generated from a seed by clause
   4.2.3's distributions; TPC-H q03 (two inner joins through the build-once
   join index, a grouped sum, ``sort().limit(10)`` as a TopN) and q04 (a
   semi join, a grouped count, a sort), each warm and then timed with the
   counts set to 0 just before: rows/s and wall s, the rows on each side of
   each join, its route (the index's dense or sorted form, or Acero), the
   device counters (both date filters and q03's revenue chain on the card,
   the ``c_mktsegment`` string filter on the host) and the chains' staging /
   host→device / device / fetch split. It checks q03's top ten keys, dates
   and priorities exactly and each revenue within 1e-6 of an f64 numpy
   reference (adjacent revenues within that tolerance may come in either
   order, and the check says so), q04's counts exactly, the routes the
   index's rule gives the build keys, the counters, identical warm and
   timed results and no flash launch. Then a sort of the orders by
   (``o_custkey``, ``o_orderdate`` desc) held against ``np.lexsort``, and
   over SF1's tables a cProfile host split of q03 (filters, index build,
   probe, aggregate, TopN) and a ``torch.profiler`` trace of it (idle
   share, "not measured" where the profiler records no device activity);
11. the pipelined engine (``phase_pipelined``): print ``os.cpu_count()`` and
   the compute pool's resolved workers, then run each path at
   ``num_compute_threads=1`` and at the default (one worker per core): q06
   and q01 over half of SF10's lineitem (phase 7's seed; wall s at each,
   the same bytes at both, the card's idle share over a traced run at N, the
   pinned staging after each run held to the workers so far times one set of
   the largest chunk's columns); the partitioned query over SF1's rows
   (equal to ``np.bincount`` at both, one bucket per worker); q03 over
   ``TPCH_SF``'s tables (the same rows and ``join_counters`` at both); phase 9's photos
   decoded, resized and embedded with ViT-L/14 in morsels of 128 (the decoded
   bytes equal, decode and whole-path rows/s at both, 24 flash launches per
   chunk); phase 3's main path with ``max_concurrency=2`` beside 1 (two UDF
   workers on two streams sharing one instance, 24 launches per chunk, the
   embeddings the same bits or, where not, cosine >= 0.99999); the card's
   fixed-shape resize in morsels of 128 at N threads under a caller's
   ``allow_tf32=True``, bit-equal to the serial run with TF32 off and the
   flag restored; and q01 at N threads under ``collect(timeout=0.5)``, which
   must raise ``DaftTimeoutError`` within 0.5 s plus one morsel, leave no
   pool, feeder or prefetch thread alive, and leave the next q06 exact.
   Phases 7 and 10 run their cProfile host splits serially (cProfile sees
   one thread) and hold the pinned staging to one set per worker;
12. scan and local files (``phase_scan``): C.30's f32 sqrt on CUDA against
   ``np.sqrt`` on 1,000,000 values, bit for bit; the free bytes of the temp
   directory's disk (at least 3x the table, or the run fails); the first
   ``SCAN_ROWS`` rows of SF10's lineitem (a quarter of it; phase 7's seed, all
   nine columns) written with the port's
   ``write_parquet`` (files, bytes on disk, write s); q06 (f32-typed rate
   bounds, so the scan's host filter decides the rows the device would;
   ROADMAP C.31) and q01 through ``read_parquet``, each warm and then timed
   at 1 thread and at the default, with the columns the parquet reader
   decoded in each batch (``io_stats``, 4 and 7 of 9), the counters, the pinned staging (at most one set per
   worker), the scan's own wall and the idle share over a traced run: both
   within 1e-5 of the f64 references, bit-equal at 1 and N threads, and
   printed as bit-equal to the in-memory run or not; q06 with Python-float
   bounds against its host-semantics reference (C.31); q01 over the parquet
   files under ``collect(timeout=0.5)``, raised within 0.5 s plus one
   morsel with no scan or stage thread left and the next q06 exact; SF1's
   q01 columns written hive-partitioned by ``l_returnflag`` and read back
   with ``where(l_returnflag == 'R')`` (the in-memory filter's multiset,
   the other files pruned in ``io_stats``), then q01 over the whole
   dataset; phase 9's photos as files (``from_glob_path`` →
   ``image_file`` → ``decode_image_file``) and as parquet shards of 128 rows
   (``read_parquet`` → ``.image.decode``), resized and embedded with
   ViT-L/14 beside the in-memory column: rows/s, the decode / rest split, 24
   flash launches per chunk, and the embeddings equal to the in-memory
   column's or, where not, cosine >= 0.99999;
13. the expression library (``phase_expressions``): TPC-H q05, q07-q10,
   q12-q14 and q19 in DataFrame form (``daft_tpu_torch/tools/tpch.py``; the
   strings, ``is_in``, ``.dt.year()``, ``if_else`` over strings, the
   two-key and left outer joins they need) over SF1's tables (generated and
   timed), each against its numpy reference, which also warms the device
   programs; q19 and q12 there with ``device_eval=False`` must give the
   same rows as with it on. Then SF10's tables (generation timed, the
   numpy references timed), each query once at 8 workers with the counts
   set to 0 just before: wall s, rows in, the device chains' rows, host
   rows by reason and the joins' sides and routes, keys exact and sums
   within 1e-6 of the f64 reference, no flash launch; q14 under
   ``torch.profiler`` for the idle share; the process's peak RSS. The
   tables are SF1's for both parts (phase 14 runs the nine at SF10);
14. TPC-H q01-q22 in SQL (``phase_sql``) through ``daft_tpu_torch.sql``
   (``daft_tpu_torch/tools/tpch_sql.py``: the spec's validation parameters)
   over one seeded database with every column the 22 read, the dates as
   ``date32``: first SF1's, each of the 21 against its numpy reference (keys
   exact, floats within 1e-6; q06's predicate as the route that ran it
   decides) with the join order ``ReorderJoins`` chose (q05, q08, q09) and
   no flash launch; then SF10's (generation and references timed) for the
   three phase 15 runs under a limit, q01, q18 and q21 (the other 18 cut
   from SF10 to keep the run inside its limit), each once at 8 workers with
   the counts set to 0 just before: wall s, the plan's parse and
   ``Optimizer.optimize`` s apart from it, rows per route and per join,
   against the reference, no flash launch (q16's ``count(DISTINCT ...)``
   among the 22 over SF1); the DataFrame forms of q03-q05,
   q07-q10, q12-q14 and q19 over SF1's tables (timed, their join order
   before and after the optimizer) equal to the SQL forms there; q18 under
   ``torch.profiler``; the process's peak RSS;
15. out of core (``phase_out_of_core``) on phase 14's SF10 tables and
   answers, under ``memory_limit`` at 1/8 of the tables' in-memory bytes
   (printed with the spill root's free bytes, which must be at least twice
   the tables'): TPC-H q01, q18 and q21 in SQL, the sort of the 15M orders
   by (``o_custkey``, ``o_orderdate`` desc) and ``SELECT DISTINCT
   l_orderkey, l_suppkey FROM lineitem`` over the first half of lineitem's
   rows, each at 8 workers with the counts set to 0 just before. Each query
   equals phase 14's answer (keys exact, floats within 1e-6); the sort's
   keys come in numpy's order, every row keeps its keys; the distinct
   equals numpy's ``unique``; q18, q21, the sort and the distinct spill.
   After each: the ledger holds 0 bytes, every permit is back, no spill
   directory remains. Printed beside the unlimited run: wall
   s, spills, files and bytes, the best-effort permit waits, the ledger's
   peak, charged bytes by operator and kind and stall seconds, RSS growth
   (``RssSampler``), the device counters, the join routes and the pinned
   staging. Last, q21 under the limit and a 2 s deadline must raise
   ``DaftTimeoutError`` and leave the same three at zero;
16. windows and the remaining operators (``phase_windows``,
   ``daft_tpu_torch/tools/windows.py``) on phase 14's tables, each at 8
   workers with the counts set to 0 just before (wall s, the window
   evaluation's host s, rows per route, no flash launch): over SF10's orders
   with ``o_orderdate`` as int32 days behind a filter that runs as a device
   chain (its ``chain_rows`` must be non-zero), the running
   ``sum(o_totalprice)`` per ``o_custkey`` by date, ``lag(o_orderdate, 1)``
   and ``rank()`` per ``o_orderpriority`` by ``o_totalprice`` desc against a
   numpy reference (keys, lags and ranks exact, sums within 1e-6); over
   SF1's lineitem, TPC-DS q98's whole-partition ratio over 200,000
   partitions (1e-5), ``row_number()`` per order, ``repartition(8,
   l_orderkey)`` (each row in the bucket its hash names, the input's rows),
   ``explode`` of ``agg_list`` per order (the input's multiset),
   ``monotonically_increasing_id`` (0..n-1), the ``pivot`` of q01's groups
   and ``INTERSECT ALL`` / ``EXCEPT ALL`` on ``l_suppkey``, each exact
   against numpy; TPC-H q16 in SQL over SF1 against its reference; then
   under 1/8 of SF1 lineitem's bytes the grace window and the grace hash
   repartition, each spilling and equal to its in-memory answer, the ledger,
   permits and spill directory at zero after each;
17. the DataFrame surface (``phase_surface``) on phase 14's tables, each path
   with the counts set to 0 just before (no flash launch): the first
   1,048,576 rows of SF10 lineitem's ``l_quantity``, ``l_extendedprice``,
   ``l_discount`` and ``l_tax`` through ``to_torch_dataloader(batch_size=4096,
   pin_memory=True)``, each pinned batch copied to the card with
   ``non_blocking=True`` (rows/s; the concatenated CUDA tensors equal the
   columns bit for bit); ``from_arrow(orders.to_arrow())`` over SF10's orders
   equal to ``orders.to_arrow()`` (``pa.Table.equals``); TPC-H q01 in SQL over
   SF1 through ``to_pylist``, ``to_arrow`` and ``to_pandas``, each equal to its
   ``to_pydict``, which equals the numpy reference (floats within 1e-6), with
   ``show()`` of the answer and ``explain()`` of the query printed; and
   ``summarize()`` over SF1's orders on the card's route, equal row for row to
   the host route (``device_eval=False, compiled_eval_enabled=False``), with
   both walls and the device layer's counters; SF1's orders stay for phase 18;
18. the UDF decorators, the UDAFs and the media functions and sources
   (``phase_udfs_media``), each path with the counts set to 0 just before: a
   stateful ``@cls(max_concurrency=2, gpus=1)`` UDF whose ``__init__`` builds
   the CLIP ViT-L/14 image tower on the card from a seeded generator and
   whose ``@method.batch`` embeds phase 3's 512 images in chunks of 128, at
   ``max_concurrency`` 2 and 1 (rows/s; built once; finite unit-norm rows;
   the same bytes at both; equal to a direct embed of the same tower within
   the chunk tolerance; 24 flash launches per chunk); a row-wise ``@func``
   ``x * 3 + 1`` over 1,000,000 int64 rows (rows/s, equal to numpy); 8
   seeded MP4s (mp4v, 64 frames of 320x240 at 10 fps) through
   ``from_files`` -> ``video_file(verify=True)`` -> ``video_frames(224,
   224)`` -> ``explode`` -> the frame's image -> ``into_batches(128)`` ->
   ``embed_image`` (ViT-L/14) and through ``read_video_frames`` ->
   ``into_batches(128)`` -> ``embed_image``: 512 frames on each route, each
   frame's ``is_key_frame`` against its file's ``stss``, the two routes'
   frames equal bit for bit, each route's embeddings equal to a direct
   forward of the same frames in four full chunks of 128, 96 launches,
   decode and embed rows/s; ``run_process`` over 64 rows and one
   ``shell=True`` row cast to int64; ``read_mcap`` of a seeded MCAP (two
   topics, one zstd chunk) filtered by topic and time; ``audio_metadata``
   and ``resample`` on seeded WAVs at 8 kHz mono and 22.05 kHz stereo
   against numpy; a UDAF class with ``merge`` (the geometric mean of
   ``o_totalprice`` per ``o_orderpriority``) over SF1's 1,500,000 orders,
   within 1e-9 of numpy, with at least one merge per group;
19. the observability plane (``phase_observability``): phase 3's 512 images
   through ViT-L/14 ``embed_image`` with ``collect(profile=True)`` and
   without (the same bytes, 96 flash launches each, two paths of the kernels
   line, both walls printed), the profile's ``UDFProject`` row at 512 rows and
   its Chrome trace (``write_chrome_trace``) read back by ``json.load`` with
   one span per plan node; ``explain(analyze=True)`` of TPC-H q01 in its
   DataFrame form over phase 14's SF10 lineitem with the ship dates cast to
   int32 days (so its filter runs as a device chain) at the default pool,
   printed on ``[obs]`` lines: its ``rows`` the collected rows (equal to
   phase 14's SQL answer within 1e-5), its ``device eval`` fused rows and
   ``compiled chains`` morsels the device layer's counters (both non-zero),
   each operator's rows ``metrics()``'s ``rows_out``; the sort of
   SF1's 1,500,000 orders (phase 15's keys) under 1/8 of their bytes while a
   second holder keeps every permit until the sort's reservation has waited
   0.5 s, analyzed: ``spill``
   equal to ``spill_metrics``, a ``memory permits`` wait of at least 0.45 s,
   ``memory`` equal to the ledger's block, the rows in order, every permit
   back; then the two planes' overheads as the JAX package's ``bench.py``
   measures them, each printed in % beside its 2 % budget: ``bench.py``'s
   loop (filter, join, groupby, sort) at n = 400,000 with the registry on and
   off (best of 21 each, alternating in one process) and at n = 6,000,000
   profiled and unprofiled (the median of 10 paired ABBA deltas in one
   process, doubled once when it reads over 2 %, as ``bench.py`` does);
20. the rest of the AI surface and pipeline-progress checkpoints
   (``phase_ai_surface``), each path with the counts set to 0 just before:
   (a) a ``ThreadingHTTPServer`` on 127.0.0.1 that speaks the OpenAI wire
   format (``/v1/embeddings``, ``/v1/chat/completions``) and the Gemini one
   (``:batchEmbedContents``, ``:generateContent``), answering with the port's
   towers on the card behind one lock (MiniLM-L6 embeddings, ``default-lm``
   at temperature 0) and with 429 and ``Retry-After: 0`` to its first two
   POSTs: ``embed_text(provider="vllm")`` over phase 5's 4096 strings must
   give the bytes of ``embed_text(provider="cuda")`` (rows/s through HTTP
   beside the direct route), ``prompt(provider="lm_studio",
   max_completion_tokens=16)`` over 16 prompts and ``prompt(provider=
   "google")`` over 4 must equal the prompter answering them one at a time,
   ``embed_text(provider="google")`` over 256 strings must agree with the
   direct rows within the chunk tolerance, the registry must count two
   retries, and ``token_metrics()`` must equal the usage the server
   reported; (b) the ``transformers`` provider on phase 8's MiniLM directory
   over the 4096 strings on the card, against the ``cuda`` provider over the
   same directory (the first 1024, cosine >= 0.99) and against itself on the
   CPU (32 rows, cosine >= 0.999), or, where ``transformers`` does not import, the
   ``ImportError`` its ``instantiate()`` raises; (c) the MiniLM-L6 tower's
   weights as a flax-layout ``.msgpack`` (bf16 block leaves, written with
   ``msgpack``) beside an ``.npz``: ``embed_text(weights_path=...)`` from both
   over the 4096 strings must give the same bytes, which equal the tower's
   own; where ``tensorstore`` does not import, the ``ImportError`` the orbax
   reader raises naming it (the CPU tests hold orbax directories); (d) 512 images keyed by id
   through ViT-L/14 ``embed_image`` into ``write_parquet(checkpoint=)``, the
   same run again under ``with_checkpoint`` (no row reaches the UDF), then 128
   more ids (one chunk): 96 / 0 / 24 flash launches, each key once in the
   files, the first run's embeddings unchanged and the new ones equal to a
   direct forward;
21. multi-device and the engine's overhead (``phase_multi_device``), each
   path with the counts set to 0 just before: (a) the watchdog: 2048 images
   (16 chunks of 128) through ViT-L/14 standalone
   (``CUDACLIPImageEmbedder.embed_image``) and through ``read ->
   UDFProject(embed_image) -> collect`` with ``default_morsel_size=2048``,
   the same seeded weights, in 3 ABBA blocks in this process (9 if the median
   of the per-block ratios is over 1.15): each side's img/s, the verdict, the
   two sides' rows equal within the chunk tolerance, and ``gap_breakdown`` of a
   profiled engine pass; over 1.15 after the 9 blocks the phase fails; (b)
   replica slots over phase 3's 512 images: ``chips_per_replica=1`` over the
   card's own ``visible_devices()`` (one slot) and over two entries that both
   name ``cuda:0`` (two slots, labelled so; morsels of 128), each the bytes of
   phase 3's route with 96 launches, the second with two instances, one per
   slot; (c) the mesh over the same two entries: ``mesh_axes={"dp": 2}`` (two
   towers, chunks split in halves of 64: bit equality is not asked, the max
   abs error and cosine against (b) are printed and the cosine held to
   0.999) and ``{"tp": 2}`` (ViT-L/14's qkv, out, fc1, fc2 and proj split in
   two, cosine >= 0.999 against (b), 24 launches a chunk, the weight bytes
   each shard holds); (d) ring attention at B=4, T=16384, D=64 in f32: one
   NCCL rank on ``cuda:0`` in this process, and two gloo ranks spawned with a
   ``FileStore`` rendezvous, both on ``cuda:0`` (their blocks staged through
   pinned host buffers; run beside (b) and (c) on the same card), each
   against the flash kernel over the whole sequence laid out (B, T, 1, D) and
   against ``flash_attention_plain`` (3e-5), with their walls and no flash
   launch; (e) C.45: ``flash_attention`` on CUDA tensors that require grad
   raises, and under ``torch.no_grad()`` the same call launches;
22. print the whole run's time and one JSON line of per-kernel numbers (with
   the launches on each path), then, last, the device line.

Exits non-zero, printing no result, when no CUDA device is visible.
"""

from __future__ import annotations

import functools
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
CPU_TEXT_SAMPLE = 16  # non-empty strings per text tower held against its CPU tower
CPU_CLASSIFY_IMAGES = 2  # images whose label similarities are held against the CPU towers
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

# Phase 10: TPC-H q03 and q04 over SF1's customer, orders and lineitem
# (daft_tpu_torch/tools/tpch.py, clause 4.2.3's distributions), and a sort of
# the orders; q03's host split and trace over SF1's tables. Cut from SF10 (also
# for phase 11's q03) to keep the run inside its limit: phase 14 runs q03 and
# q04 in SQL over SF10, and phase 15 sorts SF10's orders.
TPCH_SF = 1
TPCH_PROFILE_SF = 1
Q03_RTOL = 1e-6  # f32 line revenues summed in f64, rounded to f32, vs an f64 reference

# Phase 11: the pipelined engine, over half of SF10's lineitem. Phase 12:
# scan and local files, over a quarter of it. Both cut from all of it to keep
# the run inside its limit; q01 still outlasts the 0.5 s deadline in both.
PIPELINED_ROWS = 29_993_026
SCAN_ROWS = 14_996_513
SQRT_VALUES = 1_000_000  # C.30's sqrt check on the card
SCAN_FREE_FACTOR = 3     # free disk the scan phase needs, in multiples of the table
SHARD_ROWS = 128         # rows per parquet shard of the photos
PHOTO_COSINE_MIN = 0.99999  # photos from files vs the in-memory column, where not the same bits
CANCEL_TIMEOUT_S = 0.5   # q01's deadline in the cancellation check
THREAD_EXIT_S = 10.0     # how long the stage threads may take to end after it
MC_COSINE_MIN = 0.99999  # max_concurrency=2 vs 1 embeddings, where not the same bits
STAGE_THREAD_NAMES = ("daft-compute", "daft-feed", "daft-udf", "daft-probe-side")

# Phase 13: TPC-H q05, q07-q10, q12-q14 and q19 over SF10's tables
# (tools/tpch.py with expressions=True), warmed over SF1's.
EXPR_SF = 1         # cut from 10: phase 14 runs the nine at SF10, beside their SQL forms
EXPR_CHECK_SF = 1   # the warm runs, and q19 / q12 with device_eval off
EXPR_WORKERS = 8
EXPR_RTOL = 1e-6    # f32 line revenues summed in f64, rounded to f32, vs an f64 reference
EXPR_TRACED = "q14"
# Phase 14: TPC-H q01-q22 in SQL over SF1, each against its reference; over
# SF10 the three queries phase 15 runs under a limit (the other 18 cut from
# SF10 to keep the run inside its limit).
SQL_SF = 10
SQL_CHECK_SF = 1    # every query against its reference
SQL_WORKERS = 8
SQL_RTOL = 1e-6
SQL_TRACED = "q18"
SQL_JOIN_ORDERS = ("q05", "q08", "q09")
SQL_FRAME_FORMS = ("q03", "q04", "q05", "q07", "q08", "q09", "q10", "q12", "q13", "q14", "q19")
# Phase 16.
WINDOW_RTOL = 1e-6  # f32 window sums (sequential f64 rounded to f32) vs f64 numpy
RATIO_RTOL = 1e-5   # an f32 price over its f32 partition sum vs the f64 quotient
REPARTITIONS = 8
# Phase 17.
SURFACE_ROWS = 1 << 20  # lineitem rows through the torch loader (the JAX package's is per row)
SURFACE_BATCH = 4096
SURFACE_COLUMNS = ("l_quantity", "l_extendedprice", "l_discount", "l_tax")
# Phase 18: the UDF decorators, the UDAFs and the media functions and sources.
ROWWISE_ROWS = 1_000_000  # rows through a row-wise @func (one Python call per row)
VIDEO_FILES, VIDEO_FRAMES, VIDEO_FPS = 8, 64, 10
VIDEO_WIDTH, VIDEO_HEIGHT = 320, 240
PROCESS_ROWS = 64
MCAP_MESSAGES = 4096
WAV_RATES = ((8000, 1), (22050, 2))  # (sample rate, channels), one second each
RESAMPLE_RATE = 16000
UDAF_RTOL = 1e-9  # the geometric mean's merged log sums vs numpy's, in f64

# Phase 19 (observability).
OBS_HOLD_S = 0.5               # how long a second holder keeps the limit's permits
OVERHEAD_METRICS_ROWS = 400_000   # bench.py's metrics_overhead_check n
OVERHEAD_METRICS_REPS = 7         # its reps per round
OVERHEAD_ROUNDS = 3               # its rounds (3 x 7 reps, alternating, in one process)
OVERHEAD_PROFILE_ROWS = 6_000_000  # bench.py's profile_overhead_check n
OVERHEAD_PROFILE_BLOCKS = 6       # ABBA pairs in one process (bench.py: 3 children x 10)
OVERHEAD_BUDGET_PCT = 2.0         # the JAX package's budget for each plane
PLANE_COST_MORSELS = 20_000       # morsels through each timed chain (tools/plane_cost.py)
PLANE_COST_REPS = 7               # its reps, variants interleaved
# Phase 20: the rest of the AI surface and pipeline-progress checkpoints.
API_EMBED_MODEL = "all-MiniLM-L6-v2"  # the vllm and google routes' model, served by the cuda tower
API_PROMPTS = 16          # prompts through lm_studio's chat completions
API_PROMPT_TOKENS = 16    # their max_completion_tokens
API_RATE_LIMITED = 2      # the server's first POSTs, answered 429 with Retry-After: 0
GOOGLE_TEXTS = 256        # strings through Gemini's batchEmbedContents
GOOGLE_PROMPTS = 4        # prompts through Gemini's generateContent
TRANSFORMERS_CPU_ROWS = 32           # the transformers model on the card against it on the CPU
HF_COMPARE_ROWS = 1024               # its rows held against the cuda provider's
TRANSFORMERS_CPU_COSINE_MIN = 0.999  # f32 on both, summed in another order
CKPT_NEW = 128            # ids added after the first checkpointed write: one chunk
Q01_COLUMNS = ("l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice", "l_discount",
               "l_tax", "l_shipdate")

# Phase 21: multi-device and the engine's overhead.
WATCHDOG_IMAGES = 2048    # 16 chunks of 128 through ViT-L/14 on each side
WATCHDOG_BLOCKS, WATCHDOG_ESCALATED = 3, 9  # ABBA blocks, and once more if over the limit
OVERHEAD_LIMIT = 1.15     # engine wall / standalone wall (tests/benchmarks/test_engine_overhead.py)
SLOT_MORSEL = 128         # one chunk per morsel, so that two slots both take some
MESH_COSINE_MIN = 0.999   # a dp2 or tp2 tower against the unsharded one, in bf16
RING_B, RING_T, RING_D = 4, 16384, 64  # f32; two ranks of 8192
RING_RANKS = 2
RING_TOL = 3e-5           # f32 ring vs the f32 kernel and the plain version (the JAX test's)
RING_PLAIN_BLOCK = 4096   # the plain version's query and key blocks over the whole sequence
RING_TIMEOUT_S = 120

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


class PhaseSampler:
    """The main thread's innermost line of this script, sampled every
    ``period`` s, so that each phase's wall splits by line; the top lines are
    printed at the phase's end."""

    def __init__(self, period: float = 0.05):
        import collections
        import threading

        self.period, self.counts = period, collections.Counter()
        self.main = threading.get_ident()
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._run, name="smoke-sampler", daemon=True)
        self.thread.start()

    def _run(self) -> None:
        while not self.stop.wait(self.period):
            f = sys._current_frames().get(self.main)
            while f is not None and f.f_code.co_filename != __file__:
                f = f.f_back
            if f is not None:
                self.counts[(f.f_code.co_name, f.f_lineno)] += 1

    def close(self) -> None:
        """Stop the sampling thread and wait for it: a daemon thread still
        running at interpreter exit can abort the process there."""
        self.stop.set()
        self.thread.join(timeout=10)

    def report(self, number: int, top: int = 10) -> None:
        lines = ", ".join(f"{name}:{line} {n * self.period:.1f} s"
                          for (name, line), n in self.counts.most_common(top))
        print(f"[sample] phase {number}, the main thread's top lines: {lines}", flush=True)
        self.counts.clear()


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


def trace_window(card: str, tag: str, what: str, run, warm: bool = True):
    """``run()`` once warm (unless ``warm`` is False), then once under
    torch.profiler: device time by kernel and by kind, and the share of the
    window in which no device work ran ("not measured" where the profiler
    records no device activity). Returns the µs in which device work ran and
    the window's µs, or None where not measured."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if warm:
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
    return busy_us, window_us


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
    """A shallow copy of an embedder whose tower is a copy of its tower, same
    weights, on the CPU (where attention is the plain version). The tower is
    copied, not built anew: a fresh ViT-L/14's initialisation took 2.8-5.0 s
    on the H100's host."""
    import copy

    import torch

    cpu = copy.copy(inst)
    cpu.device = torch.device("cpu")
    cpu.encoder = copy.deepcopy(inst.encoder).to("cpu")
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
                expr._expr.udf._instances[0] = inst
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

    n = CPU_CLASSIFY_IMAGES
    ref_img = check_image_tower("classify_image", tower, imgs[:n], direct_emb[:n])
    ref_lab, _ = check_text_tower("classify_image prompts", inst.text_embedder, prompts, lab)
    cpu_sims = ref_img @ ref_lab.T
    cpu_err = float(np.abs(cpu_sims - sims[:n]).max())
    print(f"[classify_image] similarities of {n} images, GPU vs CPU towers: max_abs_err "
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
    import copy

    import numpy as np
    import torch

    from daft_tpu_torch.models.lm import init_caches

    t0 = time.perf_counter()
    # A copy of the card's model, not a fresh one: initialising a new LM
    # took 7.5 s on the H100's host.
    cpu = copy.deepcopy(model).to("cpu")
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
    traced = trace_window(card, "trace prompt default-lm",
                          f"{TRACE_STEPS} decode steps of 8 slots",
                          lambda: [batcher._decode() for _ in range(TRACE_STEPS)])
    busy_us = None if traced is None else traced[0]
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

    # Pinned staging: a set per chunk in flight (at most one per worker), one
    # buffer per staged column in a set, of the largest chunk it staged.
    workers = compute_workers()
    pinned_q06 = de.pinned_bytes()
    q06_bound = 4 * max(shapes) * 4  # four 4-byte columns
    print(f"[relational] pinned staging held after q06: {pinned_q06 / 1e6:.3f} MB (four columns "
          f"of the largest chunk: {q06_bound / 1e6:.3f} MB a set, at most {workers} sets)",
          flush=True)
    check(q06_bound <= pinned_q06 <= workers * q06_bound,
          f"q06 holds {pinned_q06} pinned bytes, not between {q06_bound} and {workers} x that")

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
          f"{scan_bound / 1e9:.3f} GB a set, at most {workers} sets); after reset_programs: "
          f"{pinned_reset} bytes", flush=True)
    check(pinned_scan <= workers * scan_bound,
          f"the scan holds {pinned_scan} pinned bytes > {workers} x {scan_bound}")
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


def host_split(card: str, what: str, run, parts, tag: str = "relational") -> None:
    """``run()`` once under cProfile at ``num_compute_threads=1`` (cProfile
    sees the calling thread only): the host seconds inside each of ``parts``
    ((label, file suffix, function name)), beside the profiled wall time.
    cProfile's own cost falls on the Python calls, not on the native work
    inside them."""
    import cProfile
    import pstats

    import daft_tpu_torch as dt

    prof = cProfile.Profile()
    # cProfile sees the calling thread only: the split is of a serial run.
    with dt.execution_config_ctx(num_compute_threads=1):
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
    print(f"[{tag}] host split of {what} (cProfile, serial, {wall:.3f} s wall): "
          + "; ".join(rows)
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
                # Arrow columns, not to_pydict's 5.7 M Python ints a run.
                out = (df.where(c("l_shipdate") <= lineitem.Q01_SHIPDATE_MAX).groupby("l_partkey")
                       .agg(c("l_quantity").sum().alias("sum_qty"),
                            c("l_quantity").count().alias("n")).to_arrow())
                elapsed = time.perf_counter() - t0
                launches = flash_attention.launch_count
                snap = de.device_eval_counters.snapshot()
        finally:
            Executor._partitioned_agg = real
        col = {k: out.column(k).to_numpy() for k in ("l_partkey", "sum_qty", "n")}
        order = np.argsort(col["l_partkey"])
        got_keys = col["l_partkey"][order]
        check(np.array_equal(got_keys, present), f"partitioned query, {label}: {len(got_keys)} "
              f"groups, want {len(present)}")
        check(np.array_equal(col["sum_qty"][order], want_sum[present].astype(np.int64))
              and np.array_equal(col["n"][order], want_n[present]),
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
    largest gap in f32 roundings is printed for Python literals. The rows are
    compared as Arrow columns: as Python lists they took 26.5 of this check's
    27.1 s on the H100's host."""
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
                    df.where(c("l_quantity") < 48).with_columns(proj(one)).to_arrow(),
                    df.with_columns(proj(one)).select("disc_price", "charge").to_arrow())
            out[route] += (de.device_eval_counters.snapshot(),)
        return out

    f32_one = dt.lit(1.0, dt.DataType.float32())
    exact = routes(f32_one)
    n = len(cols["l_quantity"])
    check(exact["chain"][2]["chain_rows"] == {"filter_project": 2 * n},
          f"q01 chain: not every row ran in the device chain: {exact['chain'][2]}")
    kept = exact["chain"][0].num_rows
    check(exact["device_eval"][2]["fused_rows"] == 2 * (kept + n) and
          not exact["device_eval"][2]["chain_rows"],
          f"q01 projection: device_eval did not take it: {exact['device_eval'][2]}")
    for route in ("chain", "device_eval"):
        for got, want in zip(exact[route][:2], exact["host"][:2]):
            for k in got.column_names:
                check(got.column(k).to_numpy().tobytes() == want.column(k).to_numpy().tobytes(),
                      f"q01 {route}: column {k} differs from the host route")
    weak = routes(1)
    gap = 0
    for route in ("chain", "device_eval"):
        for got, want in zip(weak[route][:2], weak["host"][:2]):
            for k in ("disc_price", "charge"):
                a = np.asarray(got.column(k).to_numpy(), dtype=np.float32)
                b = np.asarray(want.column(k).to_numpy(), dtype=np.float32)
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

    # Drawn on the card from a seeded generator (numpy's took 15 s on the
    # host for the 768 M values).
    gen = torch.Generator(device="cuda").manual_seed(8)
    emb = torch.randn((EMBED_ROWS, EMBED_DIM), generator=gen, device="cuda").cpu().numpy()
    query = torch.randn(EMBED_DIM, generator=gen, device="cuda").cpu().numpy()
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
    # fetch), which only device_eval takes. PushDownFilter moves the where
    # below the with_column, substituting the distance (as in the JAX
    # package): the filter's chain refuses the f64 predicate and evaluates
    # it on the host over every row, and the projection above it computes
    # the kept rows' distances on the card. Before the rule the where
    # compared the card's distances: 2 x EMBED_ROWS fused rows.
    kept_n = len(kept_gpu["id"])
    print(f"[relational] cosine scan counters: fused_rows {snap['fused_rows']} (select: "
          f"{EMBED_ROWS}; with_column after the pushed-down where: {kept_n}; before "
          f"PushDownFilter {2 * EMBED_ROWS}), host_rows {snap['host_rows']}", flush=True)
    check(snap["fused_rows"] == EMBED_ROWS + kept_n and not snap["chain_rows"],
          f"cosine scan: the distances did not run where the plan puts them: {snap}")
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
    """A fresh list of :func:`encoded_photos` (phases 9, 11 and 12 share one
    encoding)."""
    return list(encoded_photos(n, seed))


@functools.lru_cache(maxsize=1)
def encoded_photos(n: int, seed: int) -> tuple:
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
        return tuple(pool.map(encode, range(n)))


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
    fwd_expr._expr.udf._instances[0] = inst
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

    classify = Udf(top1, dt.DataType.int64(), batch=True, name="resnet18_top1",
                   batch_size=RESNET_BATCH)
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


def index_form(keys) -> str:
    """The form of ``JoinIndex`` that build keys ``keys`` (int, no nulls)
    take: ``dense`` where their span fits the offset table, else ``sorted``."""
    from daft_tpu_torch.execution.join_index import JoinIndex

    span = int(keys.max()) - int(keys.min()) + 1
    cap = min(max(JoinIndex.DENSE_SPAN_FACTOR * len(keys), 1 << 16), JoinIndex.DENSE_SPAN_MAX)
    return "dense" if span <= cap else "sorted"


def phase_relational_joins(card: str) -> dict:
    """TPC-H q03 and q04 through the port on the card over ``TPCH_SF``'s tables,
    each warm and then timed with the counts set to 0 just before: rows/s,
    the rows on each side of each join and its route, the device counters
    and the chains' split; the results against the numpy references. Then
    q03's host split (cProfile) and a trace over SF1's tables, and a sort of
    the orders held against ``np.lexsort``. Returns the launch counts of
    q03 and q04."""
    import gc

    import numpy as np
    import pyarrow as pa
    import pyarrow.compute  # noqa: F401  (pa.compute)
    import torch

    import daft_tpu_torch as dt
    from daft_tpu_torch.execution.join_index import join_counters
    from daft_tpu_torch.ops import device_eval as de
    from daft_tpu_torch.ops.flash_attention import flash_attention
    from daft_tpu_torch.tools import tpch

    phase_start = t0 = time.perf_counter()
    tables = tpch.tpch_tables(TPCH_SF, seed=0)
    gen_s = time.perf_counter() - t0
    sizes = {t: len(next(iter(cols.values()))) for t, cols in tables.items()}
    t0 = time.perf_counter()
    ref3, ref4 = tpch.q03_reference(tables), tpch.q04_reference(tables)
    # The index form each join's build keys must take (JoinIndex's rule).
    cu, o, li = tables["customer"], tables["orders"], tables["lineitem"]
    segment = cu["c_custkey"][pa.compute.equal(cu["c_mktsegment"], tpch.Q03_SEGMENT)
                              .to_numpy(zero_copy_only=False)]
    orders_build = o["o_orderkey"][(o["o_orderdate"] < tpch.Q03_DATE)
                                   & np.isin(o["o_custkey"], segment)]
    want_routes = {"q03": [index_form(segment), index_form(orders_build)],
                   "q04": [index_form(li["l_orderkey"][li["l_commitdate"] < li["l_receiptdate"]])]}
    del cu, o, li, segment, orders_build
    print(f"[joins] TPC-H SF{TPCH_SF} from seed 0: customer {sizes['customer']} rows, orders "
          f"{sizes['orders']}, lineitem {sizes['lineitem']} (this draw's count), generated in "
          f"{gen_s:.1f} s; numpy references in {time.perf_counter() - t0:.1f} s "
          f"({len(ref3['l_orderkey'])} q03 groups)", flush=True)

    def frames(tabs, columns):
        return {t: dt.from_pydict({c: tabs[t][c] for c in cs}) for t, cs in columns.items()}

    queries = {"q03": (tpch.Q03_COLUMNS,
                       lambda f: tpch.q03(dt, f["customer"], f["orders"], f["lineitem"])),
               "q04": (tpch.Q04_COLUMNS, lambda f: tpch.q04(dt, f["orders"], f["lineitem"]))}
    by_path = {}
    for name, (columns, query) in queries.items():
        f = frames(tables, columns)
        rows_in = sum(sizes[t] for t in columns)
        results = []
        for run in ("warm", "timed"):
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            de.device_eval_counters.reset()
            de.phase_timer.reset()
            de.phase_timer.enabled = run == "timed"
            join_counters.reset()
            flash_attention.launch_count = 0
            t0 = time.perf_counter()
            out = query(f).to_pydict()
            elapsed = time.perf_counter() - t0
            de.phase_timer.enabled = False
            launches = flash_attention.launch_count
            results.append((out, elapsed, de.device_eval_counters.snapshot(),
                            join_counters.snapshot()))
            check(launches == 0, f"{name} {run}: flash_attention launched {launches} times")
        (warm, warm_s, _, _), (out, elapsed, snap, joins) = results
        by_path[name] = {"flash_attention": launches}
        peak = torch.cuda.max_memory_allocated()
        check(out == warm, f"{name}: the warm and the timed run differ")
        check(all(len(j["routes"]) == 1 for j in joins),
              f"{name}: a join's probe morsels took more than one route: {joins}")
        routes = [next(iter(j["routes"])) for j in joins]
        check(routes == want_routes[name], f"{name}: join routes {routes}, want "
              f"{want_routes[name]} (the index's rule over the build keys)")
        sides = "; ".join(
            f"{j['how']} on {j['on']}: build {j['build_rows']} rows, probe {r['rows_in']} rows in "
            f"{r['morsels']} morsels, {r['rows_out']} out, route {route}"
            for j, route in zip(joins, routes) for r in [j["routes"][route]])
        host = snap["host_rows"]
        chain = snap["chain_rows"].get("filter_project", 0)
        if name == "q03":
            problems, notes = tpch.q03_compare(out, ref3, Q03_RTOL)
            check(not problems, f"q03 vs the numpy reference: {problems}")
            err = max(abs(r - w) / w for r, w in zip(out["revenue"], ref3["revenue"]))
            verdict = (f"the top {len(out['l_orderkey'])} order keys, dates and priorities exact, "
                       f"revenue within {err:.2e} of the f64 reference (tol {Q03_RTOL})"
                       + ("; " + "; ".join(notes) if notes else "; no near-tie"))
            # Both date filters and the revenue chain on the card; the tail
            # morsel of the revenue chain may fall below device_eval_min_rows.
            joined = joins[1]["routes"][routes[1]]["rows_out"]
            tail = host.get("chain_below_min_rows", 0)
            want_card = sizes["lineitem"] + sizes["orders"] + joined
            check(chain + tail == want_card and tail < 1024,
                  f"q03: {chain} rows in device chains and {tail} below the minimum, want "
                  f"{want_card} (lineitem, orders, the {joined} joined rows)")
            check(host.get("chain_not_fusable") == sizes["customer"],
                  f"q03: the c_mktsegment filter's host rows {host}")
        else:
            check(out == ref4, f"q04 {out} vs the numpy reference {ref4}")
            verdict = f"the {len(out['o_orderpriority'])} priorities and counts exact"
            check(chain == sizes["lineitem"] + sizes["orders"] and not any(
                k.startswith("chain_") for k in host), f"q04: device chains {snap}")
        split = de.phase_timer.totals
        print(f"[joins] {name} over {rows_in} rows: warm run {warm_s:.3f} s, timed run "
              f"{elapsed:.3f} s = {rows_in / elapsed:.4e} rows/s; {verdict}; peak device memory "
              f"{peak / 1e9:.3f} GB; flash launches 0 [{card}]", flush=True)
        print(f"[joins] {name} joins (timed run): {sides}", flush=True)
        print(f"[joins] {name} counters (timed run): chain_rows {snap['chain_rows']}, fused_rows "
              f"{snap['fused_rows']}, host_rows {host}, program cache {snap['program_hits']} hits "
              f"/ {snap['program_misses']} misses", flush=True)
        print(f"[joins] {name} chains' split: staging {split['stage_s']:.3f} s, host->device "
              f"{split['h2d_ms']:.3f} ms, device {split['device_ms']:.3f} ms, fetch "
              f"{split['d2h_ms']:.3f} ms (stream time, CUDA events, summed over "
              f"{sum(snap['chain_morsels'].values())} morsels); the rest of the {elapsed:.3f} s "
              f"is host work [{card}]", flush=True)
        del f
        gc.collect()

    # The sort: the orders by (o_custkey, o_orderdate desc); Arrow's sort
    # and np.lexsort are both stable, so ties keep the input order in both.
    o = tables["orders"]
    odf = dt.from_pydict(o)
    t0 = time.perf_counter()
    parts = list(odf.sort(["o_custkey", "o_orderdate"], desc=[False, True]).iter_partitions())
    sort_s = time.perf_counter() - t0
    out = pa.concat_tables([p.to_arrow_table() for p in parts])
    t0 = time.perf_counter()
    order = np.lexsort((-o["o_orderdate"], o["o_custkey"]))
    lexsort_s = time.perf_counter() - t0
    check(np.array_equal(out["o_orderkey"].to_numpy(), o["o_orderkey"][order]),
          "the orders' sort differs from np.lexsort")
    check(out["o_orderpriority"].combine_chunks().equals(o["o_orderpriority"].take(order)),
          "the sort moved o_orderpriority apart from its rows")
    print(f"[joins] sort of {sizes['orders']} orders (5 columns) by (o_custkey, o_orderdate "
          f"desc): {sort_s:.3f} s = {sizes['orders'] / sort_s:.4e} rows/s through the engine; "
          f"equal to np.lexsort ({lexsort_s:.3f} s for the permutation alone) [{card}]",
          flush=True)
    del tables, odf, parts, out, order
    gc.collect()

    small = tpch.tpch_tables(TPCH_PROFILE_SF, seed=0)
    f = frames(small, tpch.Q03_COLUMNS)

    def q03_small():
        return tpch.q03(dt, f["customer"], f["orders"], f["lineitem"]).to_pydict()

    host_split(card, f"q03 over SF{TPCH_PROFILE_SF}'s tables", q03_small,
               (("filters and the revenue chain (device programs with staging and fetch)",
                 "ops/compiled_eval.py", "run_morsel"),
                ("the c_mktsegment filter on the host", "daft_tpu_torch/micropartition.py",
                 "filter"),
                ("index build", "execution/join_index.py", "try_build"),
                ("probe", "execution/join_index.py", "probe"),
                ("aggregate (Acero partials)", "execution/executor.py", "_grouped_partial"),
                ("merge and finalize", "execution/aggregation.py", "finalize"),
                ("TopN", "execution/executor.py", "_topk"),
                ("concatenating morsels", "daft_tpu_torch/recordbatch.py", "concat")),
               tag="joins")
    trace_window(card, "trace joins", f"q03 over SF{TPCH_PROFILE_SF}'s tables", q03_small)
    print(f"[joins] phase 10 took {time.perf_counter() - phase_start:.1f} s [{card}]", flush=True)
    return by_path


def compute_workers() -> int:
    """The compute pool's workers under the current config (0 resolves to
    one per core), as the executor sizes it."""
    import daft_tpu_torch as dt
    from daft_tpu_torch.execution.executor import Executor

    return Executor(dt.get_context().execution_config).compute_threads


def stage_threads() -> list:
    """The live threads of a query's stages: the compute pool, the feeders,
    a UDF's own pool and a join's probe-side prefetch."""
    import threading

    return [t.name for t in threading.enumerate()
            if t.is_alive() and t.name.startswith(STAGE_THREAD_NAMES)]


def timed_at(threads: int, run, **cfg) -> tuple:
    """``run()`` at ``num_compute_threads=threads`` (and ``cfg``), after a
    synchronisation: its result and wall seconds."""
    import torch

    import daft_tpu_torch as dt

    with dt.execution_config_ctx(num_compute_threads=threads, **cfg):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0


def phase_pipelined(card: str) -> dict:
    """The pipelined engine on the card: each path at num_compute_threads=1
    and at the default (one worker per core), results equal between the two;
    a UDF with max_concurrency=2 on the main path; the resize under a caller's
    TF32 flag on overlapping threads; a query cut by its deadline. Returns the
    launch counts of its paths."""
    import contextlib
    import gc
    import os
    import threading

    import numpy as np
    import torch

    import daft_tpu_torch as dt
    from daft_tpu_torch.errors import DaftTimeoutError
    from daft_tpu_torch.execution.executor import Executor
    from daft_tpu_torch.execution.join_index import join_counters
    from daft_tpu_torch.execution.pipeline import chunk_morsels
    from daft_tpu_torch.functions.ai import embed_image
    from daft_tpu_torch.kernels import image_ops
    from daft_tpu_torch.ops import device_eval as de
    from daft_tpu_torch.ops.flash_attention import flash_attention
    from daft_tpu_torch.tools import lineitem, tpch

    phase_start = time.perf_counter()
    workers = compute_workers()
    counts = (1, workers)
    print(f"[pipelined] os.cpu_count() {os.cpu_count()}; num_compute_threads "
          f"{dt.get_context().execution_config.num_compute_threads} resolves to {workers} "
          f"workers [{card}]", flush=True)
    check(workers > 1, f"the default config runs {workers} worker(s): no pool to test")
    by_path = {}

    # q06 and q01 over half of SF10's lineitem, at 1 and N threads.
    rows = PIPELINED_ROWS
    t0 = time.perf_counter()
    cols = lineitem.lineitem_columns(rows, seed=0)
    q01_cols = ("l_quantity", "l_extendedprice", "l_discount", "l_tax", "l_shipdate",
                "l_returnflag", "l_linestatus")
    df06 = dt.from_pydict({k: cols[k] for k in NUMERIC_COLS})
    df01 = dt.from_pydict({k: cols[k] for k in q01_cols})
    cfg = dt.get_context().execution_config
    morsel = cfg.default_morsel_size
    morsels = [range(min(morsel, rows - s)) for s in range(0, rows, morsel)]
    chunk_rows = [sum(map(len, c)) for c in chunk_morsels(morsels, Executor.AGG_CHUNK_ROWS)]
    max_pad = max(de._bucket(n, cfg.device_batch_buckets) for n in chunk_rows + [morsel])
    set_bytes = 4 * max_pad * 4  # q06's four 4-byte columns; q01 stages l_shipdate alone
    print(f"[pipelined] lineitem columns: {rows} rows in {time.perf_counter() - t0:.1f} s; "
          f"{len(morsels)} morsels, {len(chunk_rows)} aggregation chunks", flush=True)
    de.reset_programs()
    results, most = {}, 1  # the most workers any run so far had
    for name, run in (("q06", lambda: lineitem.q06(dt, df06).to_pydict()),
                      ("q01", lambda: lineitem.sorted_groups(lineitem.q01(dt, df01).to_pydict()))):
        for n in counts:
            if name == "q06":
                timed_at(n, run)  # warm: at N, each worker's first chunk pins its set
            out, wall = timed_at(n, run)
            results[(name, n)] = (out, wall)
            most = max(most, n)
            pinned = de.pinned_bytes()
            print(f"[pipelined] {name} over {rows} rows at {n} thread(s): {wall:.3f} s = "
                  f"{rows / wall:.4e} rows/s; pinned staging {pinned / 1e6:.3f} MB (bound: "
                  f"{most} worker(s) x {set_bytes / 1e6:.3f} MB) [{card}]", flush=True)
            check(pinned <= most * set_bytes,
                  f"{name} at {n} thread(s): {pinned} pinned bytes > {most} x {set_bytes}")
        (serial, serial_s), (pooled, pooled_s) = results[(name, 1)], results[(name, workers)]
        if name == "q06":
            check(np.float32(serial["revenue"][0]).tobytes()
                  == np.float32(pooled["revenue"][0]).tobytes(),
                  f"q06: {serial['revenue'][0]!r} at 1 thread, {pooled['revenue'][0]!r} at "
                  f"{workers}")
        else:
            check(serial == pooled, f"q01: the {workers}-thread groups differ from the serial ones")
        with dt.execution_config_ctx(num_compute_threads=workers):
            traced = trace_window(card, "trace pipelined", f"{name} over {rows} rows at {workers} "
                                  "threads", run, warm=False)
        idle = "not measured" if traced is None else f"{1 - traced[0] / traced[1]:.4f}"
        print(f"[pipelined] {name}: 1 thread {serial_s:.3f} s, {workers} threads {pooled_s:.3f} s "
              f"({serial_s / pooled_s:.2f}x); results the same bytes; idle share over the "
              f"traced {workers}-thread run {idle} [{card}]", flush=True)
    q06_ref = results[("q06", 1)][0]["revenue"][0]
    q01_pooled_s = results[("q01", workers)][1]
    del df06
    gc.collect()

    # Cancellation: q01 at N threads under a 0.5 s deadline. One morsel is
    # the mean time a worker held one chunk in the timed N-thread run.
    morsel_s = q01_pooled_s * workers / len(chunk_rows)
    t0 = time.perf_counter()
    while stage_threads() and time.perf_counter() - t0 < THREAD_EXIT_S:
        time.sleep(0.01)  # the idle workers of the earlier queries' pools
    before = stage_threads()
    t0 = time.perf_counter()
    try:
        lineitem.q01(dt, df01).collect(timeout=CANCEL_TIMEOUT_S)
        raised = None
    except DaftTimeoutError as e:
        raised = e
    cancel_s = time.perf_counter() - t0
    check(raised is not None, "q01 under a 0.5 s deadline ran to its end")
    left, t0 = stage_threads(), time.perf_counter()
    while left and time.perf_counter() - t0 < THREAD_EXIT_S:
        time.sleep(0.01)
        left = stage_threads()
    exit_s = time.perf_counter() - t0
    print(f"[pipelined] q01 at {workers} threads with collect(timeout={CANCEL_TIMEOUT_S}): "
          f"DaftTimeoutError after {cancel_s:.3f} s (bound {CANCEL_TIMEOUT_S} s + one morsel, "
          f"{morsel_s:.3f} s); stage threads alive: {len(before)} before the query, {len(left)} "
          f"{exit_s:.3f} s after the raise {left} [{card}]", flush=True)
    check(cancel_s <= CANCEL_TIMEOUT_S + morsel_s,
          f"the timeout took {cancel_s:.3f} s > {CANCEL_TIMEOUT_S} + {morsel_s:.3f}")
    check(not left, f"stage threads left after the cancelled query: {left}")
    del raised, df01
    gc.collect()
    df06 = dt.from_pydict({k: cols[k] for k in NUMERIC_COLS})
    after = lineitem.q06(dt, df06).to_pydict()["revenue"][0]
    check(np.float32(after).tobytes() == np.float32(q06_ref).tobytes(),
          f"q06 after the cancelled query: {after!r}, before {q06_ref!r}")
    print(f"[pipelined] the next q06 at {workers} threads equals the earlier ones: {after!r}",
          flush=True)

    # The partitioned query over SF1's rows: one bucket per worker.
    sf1 = {k: cols[k][:lineitem.SF1_LINEITEM_ROWS] for k in ("l_shipdate", "l_partkey",
                                                             "l_quantity")}
    del cols, df06
    gc.collect()
    keep = sf1["l_shipdate"] <= lineitem.Q01_SHIPDATE_MAX
    want_n = np.bincount(sf1["l_partkey"][keep])
    want_sum = np.bincount(sf1["l_partkey"][keep],
                           weights=sf1["l_quantity"][keep].astype(np.float64))
    present = np.flatnonzero(want_n)
    pdf = dt.from_pydict(sf1)
    c = dt.col
    real = Executor._partitioned_agg
    outs = {}
    for n in counts:
        buckets = []

        def spy(self, *args, **kwargs):
            buckets.append(self.compute_threads)
            return real(self, *args, **kwargs)

        Executor._partitioned_agg = spy
        try:
            out, wall = timed_at(n, lambda: (
                pdf.where(c("l_shipdate") <= lineitem.Q01_SHIPDATE_MAX).groupby("l_partkey")
                .agg(c("l_quantity").sum().alias("sum_qty"), c("l_quantity").count().alias("n"))
                .to_pydict()))
        finally:
            Executor._partitioned_agg = real
        order = np.argsort(np.asarray(out["l_partkey"]))
        got = {k: np.asarray(v)[order] for k, v in out.items()}
        check(buckets == [n], f"partitioned query at {n} thread(s): routes {buckets}")
        check(np.array_equal(got["l_partkey"], present)
              and np.array_equal(got["sum_qty"], want_sum[present].astype(np.int64))
              and np.array_equal(got["n"], want_n[present]),
              f"partitioned query at {n} thread(s): a group differs from np.bincount")
        outs[n] = got
        print(f"[pipelined] partitioned query over {len(keep)} rows at {n} thread(s): "
              f"{len(present)} groups in {buckets[0]} bucket(s), {wall:.3f} s; every group "
              f"equals np.bincount [{card}]", flush=True)
    check(all(np.array_equal(outs[1][k], outs[workers][k]) for k in outs[1]),
          "partitioned query: 1 and N threads differ")
    del pdf, sf1, outs
    gc.collect()

    # q03 over TPCH_SF's tables.
    tables = tpch.tpch_tables(TPCH_SF, seed=0)
    f = {t: dt.from_pydict({k: tables[t][k] for k in cs}) for t, cs in tpch.Q03_COLUMNS.items()}
    rows_in = sum(len(tables[t][next(iter(cs))]) for t, cs in tpch.Q03_COLUMNS.items())
    del tables
    q03 = {}
    for n in counts:
        join_counters.reset()
        out, wall = timed_at(n, lambda: tpch.q03(dt, f["customer"], f["orders"],
                                                f["lineitem"]).to_pydict())
        q03[n] = (out, wall, join_counters.snapshot())
        print(f"[pipelined] q03 over {rows_in} rows at {n} thread(s): {wall:.3f} s = "
              f"{rows_in / wall:.4e} rows/s; joins {q03[n][2]} [{card}]", flush=True)
    check(q03[1][0] == q03[workers][0], "q03: the rows at 1 and N threads differ")
    check(q03[1][2] == q03[workers][2],
          f"q03: join routes or rows differ: {q03[1][2]} vs {q03[workers][2]}")
    print(f"[pipelined] q03: 1 thread {q03[1][1]:.3f} s, {workers} threads {q03[workers][1]:.3f} s "
          f"({q03[1][1] / q03[workers][1]:.2f}x); rows and join counters equal [{card}]",
          flush=True)
    del f, q03
    gc.collect()

    # The image path: phase 9's photos -> decode -> resize -> ViT-L/14.
    raw = make_encoded(NUM_ENCODED, seed=20)
    bdf = dt.from_pydict({"b": raw})
    decode = dt.col("b").image.decode(mode="RGB", on_error="null")
    expr = embed_image(dt.col("img"), provider="cuda_random", model="ViT-L/14", batch_size=BATCH)
    with dt.execution_config_ctx(default_morsel_size=BATCH):
        bdf.limit(BATCH).with_column("img", decode.image.resize(IMAGE, IMAGE)).with_column(
            "emb", expr).collect()  # the weights and a warm forward
    decoded, embs = {}, {}
    for n in counts:
        col, dec_s = timed_at(n, lambda: image_column(
            bdf.with_column("img", decode).select("img"), "img"), default_morsel_size=BATCH)
        decoded[n] = col.to_arrow()
        flash_attention.launch_count = 0
        emb, path_s = timed_at(n, lambda: image_column(
            bdf.with_column("img", decode.image.resize(IMAGE, IMAGE))
            .with_column("emb", expr).select("emb"), "emb"), default_morsel_size=BATCH)
        launches = flash_attention.launch_count
        embs[n] = emb.to_numpy()
        chunks = math.ceil(NUM_ENCODED / BATCH)
        check(launches == VIT_L_LAYERS * chunks,
              f"image path at {n}: {launches} flash launches, want {VIT_L_LAYERS} x {chunks}")
        by_path[f"pipelined image path, {n} thread(s)"] = {"flash_attention": launches}
        print(f"[pipelined] image path at {n} thread(s), morsels of {BATCH}: decode "
              f"{NUM_ENCODED / dec_s:.1f} rows/s ({dec_s:.3f} s); bytes -> ViT-L/14 embeddings "
              f"{NUM_ENCODED / path_s:.1f} rows/s ({path_s:.3f} s); flash launches {launches} "
              f"[{card}]", flush=True)
    check(decoded[1].equals(decoded[workers]), "the decoded images at 1 and N threads differ")
    err = float(np.abs(embs[1] - embs[workers]).max())
    print(f"[pipelined] decoded bytes equal at 1 and {workers} threads; embeddings max_abs_err "
          f"{err:.3e} (tol {CHUNK_TOL}) [{card}]", flush=True)
    check(err <= CHUNK_TOL, f"image path embeddings differ by {err} between thread counts")
    del raw, bdf, decoded, embs, expr
    gc.collect()
    torch.cuda.empty_cache()

    # The main path with max_concurrency=2: two UDF workers, two streams,
    # one instance.
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (NUM_IMAGES, IMAGE * IMAGE * 3), dtype=np.uint8)
    idf = dt.from_pydict({"img": dt.Series.from_numpy(
        imgs, "img", dt.DataType.image("RGB", IMAGE, IMAGE))})
    udf = embed_image(dt.col("img"), provider="cuda_random", model="ViT-L/14",
                      batch_size=BATCH)._expr.udf
    inst = udf._get_instance()
    callers, real_embed = set(), inst.embed_image

    def traced_embed(images):
        callers.add(threading.current_thread().name)
        return real_embed(images)

    inst.embed_image = traced_embed
    mc = {}
    try:
        for conc in (1, 2):
            e = udf.with_concurrency(conc)(dt.col("img"))
            with dt.execution_config_ctx(default_morsel_size=2 * BATCH):
                idf.limit(BATCH).with_column("emb", e).collect()  # warm
                callers.clear()
                torch.cuda.synchronize()
                flash_attention.launch_count = 0
                t0 = time.perf_counter()
                parts = list(idf.with_column("emb", e).select("emb").iter_partitions())
                wall = time.perf_counter() - t0
                launches = flash_attention.launch_count
            out = np.concatenate([np.asarray(p.to_pydict()["emb"], np.float32) for p in parts])
            chunks = math.ceil(NUM_IMAGES / BATCH)
            check(launches == VIT_L_LAYERS * chunks,
                  f"max_concurrency={conc}: {launches} flash launches, want {VIT_L_LAYERS} x "
                  f"{chunks}")
            mc[conc] = out
            by_path[f"embed_image max_concurrency={conc}"] = {"flash_attention": launches}
            print(f"[pipelined] main path, max_concurrency={conc}: {NUM_IMAGES} images in "
                  f"{wall:.3f} s = {NUM_IMAGES / wall:.1f} img/s; UDF calls on {sorted(callers)}; "
                  f"flash launches {launches} for {chunks} chunks [{card}]", flush=True)
            if conc == 2:
                check(len(callers) == 2 and all(c.startswith("daft-udf") for c in callers),
                      f"max_concurrency=2 ran its morsels on {callers}, not two UDF workers")
    finally:
        inst.embed_image = real_embed
    same = np.array_equal(mc[1], mc[2])
    if same:
        print(f"[pipelined] max_concurrency=2 embeddings equal max_concurrency=1 bit for bit "
              f"[{card}]", flush=True)
    else:
        cos = cosines(mc[1], mc[2])
        print(f"[pipelined] max_concurrency=2 vs 1: max_abs_err {np.abs(mc[1] - mc[2]).max():.3e}, "
              f"cosine min {cos.min():.8f} (min {MC_COSINE_MIN}) [{card}]", flush=True)
        check(bool(cos.min() >= MC_COSINE_MIN), f"max_concurrency=2 embeddings: cosine {cos.min()}")
    del inst, udf, idf, imgs, mc
    gc.collect()
    torch.cuda.empty_cache()

    # The card's resize on overlapping threads under a caller's TF32 flag.
    vals = np.random.default_rng(22).integers(
        0, 256, (NUM_ENCODED, RESIZE_SIDE * RESIZE_SIDE * 3), dtype=np.uint8)
    rdf = dt.from_pydict({"img": dt.Series.from_numpy(
        vals, "img", dt.DataType.image("RGB", RESIZE_SIDE, RESIZE_SIDE))})
    depth = {"now": 0, "max": 0}
    lock, real_guard = threading.Lock(), image_ops._tf32_off

    @contextlib.contextmanager
    def counted_guard():
        with lock:
            depth["now"] += 1
            depth["max"] = max(depth["max"], depth["now"])
        try:
            with real_guard():
                yield
        finally:
            with lock:
                depth["now"] -= 1

    def resize():
        return image_column(rdf.with_column("r", dt.col("img").image.resize(IMAGE, IMAGE)),
                            "r").to_numpy()

    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on before the serial resize")
    serial, serial_s = timed_at(1, resize, default_morsel_size=BATCH)
    prev = torch.backends.cuda.matmul.allow_tf32
    image_ops._tf32_off = counted_guard
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        pooled, pooled_s = timed_at(workers, resize, default_morsel_size=BATCH)
        flag_after = torch.backends.cuda.matmul.allow_tf32
    finally:
        image_ops._tf32_off = real_guard
        torch.backends.cuda.matmul.allow_tf32 = prev
    print(f"[pipelined] resize of {NUM_ENCODED} x {RESIZE_SIDE}^2 -> {IMAGE}^2 in morsels of "
          f"{BATCH}: serial with TF32 off {serial_s:.3f} s; {workers} threads with the caller's "
          f"allow_tf32=True {pooled_s:.3f} s, up to {depth['max']} resizes inside the guard at "
          f"once; equal bit for bit: {np.array_equal(serial, pooled)}; the caller's flag after: "
          f"{flag_after} [{card}]", flush=True)
    check(np.array_equal(serial, pooled), "the TF32-on pooled resize differs from the serial one")
    check(flag_after is True, "the caller's allow_tf32=True was not restored")
    print(f"[pipelined] phase 11 took {time.perf_counter() - phase_start:.1f} s [{card}]",
          flush=True)
    return by_path


def check_sqrt_on_card(card: str) -> None:
    """C.30 on the card: torch's f32 sqrt on CUDA against the host's np.sqrt
    on the same values, bit for bit."""
    import numpy as np
    import torch

    from daft_tpu_torch.kernels.registry import get_kernel

    x = np.abs(np.random.default_rng(2).standard_normal(SQRT_VALUES) * 4).astype(np.float32)
    want = np.sqrt(x)
    bare = torch.sqrt(torch.from_numpy(x).cuda()).cpu().numpy()
    lowered = get_kernel("sqrt").torch_fn([torch.from_numpy(x).cuda()]).cpu().numpy()
    cpu = torch.sqrt(torch.from_numpy(x)).numpy()
    print(f"[scan] C.30: f32 sqrt of {SQRT_VALUES} values of |N(0, 4^2)| (seed 2): torch.sqrt on "
          f"CUDA differs from np.sqrt on {int((bare != want).sum())}, the port's lowering on "
          f"CUDA on {int((lowered != want).sum())}, a bare torch.sqrt on the CPU on "
          f"{int((cpu != want).sum())} [{card}]", flush=True)
    check(np.array_equal(lowered, want), "C.30: the card's f32 sqrt differs from np.sqrt")


def scan_chunks(file_rows, morsel: int) -> int:
    """The aggregation chunks a scan of files of ``file_rows`` rows gives:
    each file read in batches of ``morsel`` rows (its last one short), packed
    as the executor packs them."""
    from daft_tpu_torch.execution.executor import Executor
    from daft_tpu_torch.execution.pipeline import chunk_morsels

    batches = [range(min(morsel, n - s)) for n in file_rows for s in range(0, n, morsel)]
    return len(list(chunk_morsels(batches, Executor.AGG_CHUNK_ROWS)))


def arrow_sorted(table):
    """``table`` with large strings widened and its rows sorted by every
    column: a multiset's canonical form."""
    import pyarrow as pa

    table = table.cast(pa.schema([pa.field(f.name, pa.large_string())
                                  if pa.types.is_string(f.type) else f for f in table.schema]))
    return table.sort_by([(n, "ascending") for n in table.column_names])


def phase_scan(card: str, rows: int = 0) -> dict:
    """Scan and local files on the card: SF10's lineitem written to parquet
    and read back into q06 and q01 at 1 and N threads; hive pruning over
    SF1's q01 columns; phase 9's photos read from files and from parquet
    shards into ViT-L/14; C.30's sqrt on the card; a deadline over a parquet
    scan. ``rows`` cuts the table (0: SF10's). Returns the launch counts of
    its paths."""
    import gc
    import os
    import shutil
    import tempfile

    import numpy as np
    import pyarrow as pa
    import torch

    import daft_tpu_torch as dt
    from daft_tpu_torch.errors import DaftTimeoutError
    from daft_tpu_torch.execution.executor import Executor
    from daft_tpu_torch.functions.ai import embed_image
    from daft_tpu_torch.functions.media import decode_image_file, image_file
    from daft_tpu_torch.ops import device_eval as de
    from daft_tpu_torch.ops.flash_attention import flash_attention
    from daft_tpu_torch.tools import lineitem

    phase_start = time.perf_counter()
    rows = rows or lineitem.SF10_LINEITEM_ROWS
    sf1_rows = lineitem.SF1_LINEITEM_ROWS if rows == lineitem.SF10_LINEITEM_ROWS else rows // 10
    workers = compute_workers()
    counts = (1, workers)
    f32 = dt.DataType.float32()
    by_path = {}
    check_sqrt_on_card(card)
    print(f"[scan] IO pool {Executor.NUM_IO_THREADS} threads, "
          f"compute pool {workers} workers, pyarrow.cpu_count() {pa.cpu_count()}, "
          f"os.cpu_count() {os.cpu_count()}", flush=True)

    t0 = time.perf_counter()
    cols = lineitem.lineitem_columns(rows, seed=0)
    names = list(cols)
    table_bytes = sum(v.nbytes for v in cols.values())
    print(f"[scan] lineitem: {rows} rows of {len(names)} columns, {table_bytes / 1e9:.3f} GB in "
          f"memory, generated in {time.perf_counter() - t0:.1f} s", flush=True)
    q01_names = ("l_quantity", "l_extendedprice", "l_discount", "l_tax", "l_shipdate",
                 "l_returnflag", "l_linestatus")
    with tempfile.TemporaryDirectory() as tmp:
        free = shutil.disk_usage(tmp).free
        print(f"[scan] {tmp}: {free / 1e9:.3f} GB free on its disk (need {SCAN_FREE_FACTOR}x "
              f"the table's {table_bytes / 1e9:.3f} GB)", flush=True)
        check(free >= SCAN_FREE_FACTOR * table_bytes,
              f"{tmp} has {free} bytes free, fewer than {SCAN_FREE_FACTOR} x the table's "
              f"{table_bytes}: the scan phase needs that disk")

        # In memory first: phase 7's queries over the same rows.
        mem = dt.from_pydict({k: cols[k] for k in NUMERIC_COLS})
        mem06 = lineitem.q06(dt, mem).to_pydict()["revenue"][0]
        mem06_f32 = lineitem.q06(dt, mem, rate_dtype=f32).to_pydict()["revenue"][0]
        del mem
        mem = dt.from_pydict({k: cols[k] for k in q01_names})
        mem01 = lineitem.sorted_groups(lineitem.q01(dt, mem).to_pydict())
        del mem
        ref06 = lineitem.q06_reference(cols)
        ref06_host = lineitem.q06_reference(cols, host_literals=True)
        ref01 = lineitem.q01_reference(cols)
        check(np.float32(mem06).tobytes() == np.float32(mem06_f32).tobytes(),
              f"in memory, q06 with f32 rate bounds gave {mem06_f32!r}, with Python floats "
              f"{mem06!r}")

        # (1) Write the lineitem with the port's writer. The select's stage
        # hands the writer morsels, so it rolls files at its target size.
        li_dir = os.path.join(tmp, "lineitem")
        dt.reset_io_stats()
        t0 = time.perf_counter()
        res = dt.from_pydict(cols).select(*names).write_parquet(li_dir).to_pydict()
        write_s = time.perf_counter() - t0
        disk = sum(os.path.getsize(p) for p in res["path"])
        print(f"[scan] write_parquet: {len(res['path'])} files, {disk / 1e9:.3f} GB on disk "
              f"({table_bytes / disk:.2f}x smaller than in memory), {write_s:.3f} s = "
              f"{rows / write_s:.4e} rows/s; io_stats {dt.io_stats()} [{card}]", flush=True)
        check(sum(res["num_rows"]) == rows, f"the writer wrote {sum(res['num_rows'])} rows")
        morsel = dt.get_context().execution_config.default_morsel_size
        chunks = scan_chunks(res["num_rows"], morsel)

        # (2)-(4) q06 and q01 through read_parquet, each warm then timed at 1
        # and N threads. The page cache is warm after the write.
        queries = {
            "q06": (lambda: lineitem.q06(dt, dt.read_parquet(li_dir), rate_dtype=f32),
                    lambda out: out, NUMERIC_COLS[:3] + NUMERIC_COLS[4:]),
            "q01": (lambda: lineitem.q01(dt, dt.read_parquet(li_dir)), lineitem.sorted_groups,
                    q01_names),
        }

        def pq06():
            return queries["q06"][0]().to_pydict()

        # A pinned set per chunk in flight: at most one per worker, four 4-byte
        # columns of the largest padded chunk a set (the bound phase 11 uses).
        cfg = dt.get_context().execution_config
        set_bytes = 4 * de._bucket(Executor.AGG_CHUNK_ROWS + morsel, cfg.device_batch_buckets) * 4
        de.reset_programs()
        results = {}
        for name, (build, shape, used) in queries.items():
            def run(build=build, shape=shape):
                return shape(build().to_pydict())

            for n in counts:
                timed_at(n, run)  # warm
                de.device_eval_counters.reset()
                dt.reset_io_stats()
                flash_attention.launch_count = 0
                out, wall = timed_at(n, run)
                snap, io = de.device_eval_counters.snapshot(), dt.io_stats()
                check(flash_attention.launch_count == 0,
                      f"parquet {name}: {flash_attention.launch_count} flash launches")
                # The columns the parquet reader decoded in every batch: the
                # scan's projection and its pushed-down filter's.
                per_batch = io.parquet_columns / max(io.parquet_batches, 1)
                check(io.parquet_batches > 0 and per_batch == len(used),
                      f"parquet {name}: {io.parquet_columns} columns decoded over "
                      f"{io.parquet_batches} batches, not {len(used)} a batch")
                results[(name, n)] = (out, wall)
                check(de.pinned_bytes() <= workers * set_bytes,
                      f"parquet {name}: {de.pinned_bytes()} pinned bytes > {workers} x {set_bytes}")
                print(f"[scan] parquet {name} at {n} thread(s): {wall:.3f} s = "
                      f"{rows / wall:.4e} rows/s (page cache warm); the reader decoded "
                      f"{per_batch:g} of {len(names)} columns in each of {io.parquet_batches} "
                      f"batches; io_stats "
                      f"{io}; counters chain_rows {snap['chain_rows']} host_rows "
                      f"{snap['host_rows']} fused_rows {snap['fused_rows']}; pinned staging "
                      f"{de.pinned_bytes() / 1e6:.3f} MB [{card}]", flush=True)
            (serial, serial_s), (pooled, pooled_s) = results[(name, 1)], results[(name, workers)]
            _, scan_s = timed_at(workers, lambda: dt.read_parquet(li_dir).select(*used).collect())
            with dt.execution_config_ctx(num_compute_threads=workers):
                traced = trace_window(card, "trace scan", f"parquet {name} at {workers} threads",
                                      run, warm=False)
            idle = "not measured" if traced is None else f"{1 - traced[0] / traced[1]:.4f}"
            if name == "q06":
                rev = pooled["revenue"][0]
                check(np.float32(serial["revenue"][0]).tobytes() == np.float32(rev).tobytes(),
                      f"parquet q06: {serial['revenue'][0]!r} at 1 thread, {rev!r} at {workers}")
                err = abs(rev - ref06) / abs(ref06)
                check(err <= Q06_RTOL, f"parquet q06 {rev} vs the f64 reference {ref06}: {err}")
                same = np.float32(rev).tobytes() == np.float32(mem06).tobytes()
                print(f"[scan] parquet q06 revenue {rev!r}: rel err {err:.2e} vs the f64 "
                      f"reference (tol {Q06_RTOL}); equal at 1 and {workers} threads; equal to "
                      f"the in-memory run bit for bit: {same} (in memory {mem06!r})", flush=True)
            else:
                check(serial == pooled, f"parquet q01: the {workers}-thread groups differ")
                check(pooled["count_order"] == ref01["count_order"]
                      and pooled["sum_qty"] == ref01["sum_qty"],
                      "parquet q01: counts or sum_qty differ from the reference")
                errs = max(max(abs(a - b) / abs(b) for a, b in zip(pooled[k], ref01[k]))
                           for k in ("sum_base_price", "sum_disc_price", "sum_charge",
                                     "avg_qty", "avg_price", "avg_disc"))
                check(errs <= Q06_RTOL, f"parquet q01 vs the f64 reference: {errs}")
                print(f"[scan] parquet q01: largest rel err {errs:.2e} vs the f64 reference (tol "
                      f"{Q06_RTOL}), counts exact; equal at 1 and {workers} threads; equal to the "
                      f"in-memory run bit for bit: {pooled == mem01}", flush=True)
            print(f"[scan] parquet {name}: 1 thread {serial_s:.3f} s, {workers} threads "
                  f"{pooled_s:.3f} s; the scan alone (read_parquet.select({len(used)} columns)."
                  f"collect() at {workers} threads) {scan_s:.3f} s = {scan_s / pooled_s:.1%} of "
                  f"the pooled query; idle share over the traced {workers}-thread run {idle} "
                  f"[{card}]", flush=True)
            by_path[f"scan parquet {name}"] = {"flash_attention": 0}
        # C.31: Python-float rate bounds, decided on the host by the scan's
        # pushed-down filter.
        weak = lineitem.q06(dt, dt.read_parquet(li_dir)).to_pydict()["revenue"][0]
        err = abs(weak - ref06_host) / abs(ref06_host)
        print(f"[scan] C.31: parquet q06 with Python-float rate bounds (the filter in the scan, "
              f"on the host) {weak!r} against its host-semantics f64 reference {ref06_host:.6f} "
              f"(rel err {err:.2e}); in memory, on the device, {mem06!r} [{card}]", flush=True)
        check(err <= Q06_RTOL, f"parquet q06 with Python floats {weak} vs {ref06_host}")

        # Cancellation over the parquet files.
        morsel_s = results[("q01", workers)][1] * workers / chunks
        live = STAGE_THREAD_NAMES + ("daft-scan",)

        def scan_threads():
            import threading

            return [t.name for t in threading.enumerate()
                    if t.is_alive() and t.name.startswith(live)]

        t0 = time.perf_counter()
        while scan_threads() and time.perf_counter() - t0 < THREAD_EXIT_S:
            time.sleep(0.01)
        t0 = time.perf_counter()
        try:
            queries["q01"][0]().collect(timeout=CANCEL_TIMEOUT_S)
            raised = None
        except DaftTimeoutError as e:
            raised = e
        cancel_s = time.perf_counter() - t0
        check(raised is not None, "parquet q01 under a 0.5 s deadline ran to its end")
        left, t0 = scan_threads(), time.perf_counter()
        while left and time.perf_counter() - t0 < THREAD_EXIT_S:
            time.sleep(0.01)
            left = scan_threads()
        print(f"[scan] parquet q01 with collect(timeout={CANCEL_TIMEOUT_S}): DaftTimeoutError "
              f"after {cancel_s:.3f} s (bound {CANCEL_TIMEOUT_S} s + one morsel, {morsel_s:.3f} "
              f"s); scan and stage threads alive {time.perf_counter() - t0:.3f} s after the "
              f"raise: {left} [{card}]", flush=True)
        check(cancel_s <= CANCEL_TIMEOUT_S + morsel_s,
              f"the timeout took {cancel_s:.3f} s > {CANCEL_TIMEOUT_S} + {morsel_s:.3f}")
        check(not left, f"threads left after the cancelled scan: {left}")
        del raised
        after = pq06()["revenue"][0]
        check(np.float32(after).tobytes() == np.float32(results[("q06", workers)][0]["revenue"][0])
              .tobytes(), f"parquet q06 after the cancelled query: {after!r}")
        print(f"[scan] the next parquet q06 equals the earlier ones: {after!r}", flush=True)
        shutil.rmtree(li_dir)

        # Hive pruning over SF1's q01 columns, partitioned by l_returnflag.
        sf1 = {k: cols[k][:sf1_rows] for k in q01_names}
        del cols
        gc.collect()
        hive_dir = os.path.join(tmp, "hive")
        t0 = time.perf_counter()
        res = dt.from_pydict(sf1).select(*q01_names).write_parquet(
            hive_dir, partition_cols=["l_returnflag"]).to_pydict()
        hive_write_s = time.perf_counter() - t0
        c = dt.col
        dt.reset_io_stats()
        t0 = time.perf_counter()
        got = result_table(dt.read_parquet(hive_dir, hive_partitioning=True)
                                 .where(c("l_returnflag") == "R"))
        read_s = time.perf_counter() - t0
        io = dt.io_stats()
        want = result_table(dt.from_pydict(sf1).where(c("l_returnflag") == "R"))
        same = arrow_sorted(got.select(q01_names)).equals(arrow_sorted(want.select(q01_names)))
        print(f"[scan] hive: {sf1_rows} rows written in {len(res['path'])} files under "
              f"l_returnflag=... in {hive_write_s:.3f} s; where l_returnflag == 'R': {len(got)} "
              f"rows in {read_s:.3f} s, the same multiset as the in-memory filter: {same}; "
              f"files opened {io.files_opened}, pruned {io.files_pruned} [{card}]", flush=True)
        check(same and len(got) == len(want), "hive: the pruned read differs from the filter")
        check(io.files_pruned == len(res["path"]) - io.files_opened and io.files_pruned > 0,
              f"hive: {io.files_pruned} files pruned, {io.files_opened} opened of "
              f"{len(res['path'])}")
        ref_sf1 = lineitem.q01_reference(sf1)
        hq01, hq01_s = timed_at(workers, lambda: lineitem.sorted_groups(lineitem.q01(
            dt, dt.read_parquet(hive_dir, hive_partitioning=True)).to_pydict()))
        check(hq01["count_order"] == ref_sf1["count_order"]
              and hq01["sum_qty"] == ref_sf1["sum_qty"], "hive q01: counts differ")
        errs = max(max(abs(a - b) / abs(b) for a, b in zip(hq01[k], ref_sf1[k]))
                   for k in ("sum_base_price", "sum_disc_price", "sum_charge", "avg_qty",
                             "avg_price", "avg_disc"))
        check(errs <= Q06_RTOL, f"hive q01 vs the f64 reference: {errs}")
        print(f"[scan] hive q01 over the {sf1_rows} rows: {hq01_s:.3f} s, largest rel err "
              f"{errs:.2e} vs the f64 reference, counts exact [{card}]", flush=True)
        del sf1, got, want
        gc.collect()

        # Photos from files and from parquet shards into ViT-L/14.
        raw = make_encoded(NUM_ENCODED, seed=20)
        photo_dir, shard_dir = os.path.join(tmp, "photos"), os.path.join(tmp, "shards")
        os.makedirs(photo_dir)
        for i, b in enumerate(raw):
            if b is not None:  # the null row has no file
                with open(os.path.join(photo_dir, f"{i:04d}.img"), "wb") as fh:
                    fh.write(b)
        with dt.execution_config_ctx(default_morsel_size=SHARD_ROWS, parquet_target_filesize=1):
            shards = dt.from_pydict({"image": raw}).select("image").write_parquet(
                shard_dir).to_pydict()
        check(shards["num_rows"] == [SHARD_ROWS] * (NUM_ENCODED // SHARD_ROWS),
              f"shards of {shards['num_rows']} rows")
        expr = embed_image(dt.col("img"), provider="cuda_random", model="ViT-L/14",
                           batch_size=BATCH)
        sized = lambda e: e.image.resize(IMAGE, IMAGE)  # noqa: E731
        paths = {
            "in memory": (dt.from_pydict({"b": raw}), sized(dt.col("b").image.decode(
                mode="RGB", on_error="null"))),
            "files": (dt.from_glob_path(photo_dir), sized(decode_image_file(
                image_file(dt.col("path")), mode="RGB", on_error="null"))),
            "parquet shards": (dt.read_parquet(shard_dir), sized(dt.col("image").image.decode(
                mode="RGB", on_error="null"))),
        }
        with dt.execution_config_ctx(default_morsel_size=BATCH):
            src, img = paths["in memory"]
            src.limit(BATCH).with_column("img", img).with_column("emb", expr).collect()  # warm
        # Morsels of BATCH rows, as phase 11's image path: the decode spreads
        # over the pool (the default 256 K rows would make one morsel).
        embs = {}
        for name, (src, img) in paths.items():
            n_rows = NUM_ENCODED - (name == "files")
            _, dec_s = timed_at(workers, lambda: src.with_column("img", img).select("img")
                                .collect(), default_morsel_size=BATCH)
            flash_attention.launch_count = 0
            emb, path_s = timed_at(workers, lambda: image_column(
                src.with_column("img", img).with_column("emb", expr).select("emb"), "emb"),
                default_morsel_size=BATCH)
            launches = flash_attention.launch_count
            embs[name] = emb.to_numpy()
            want = VIT_L_LAYERS * math.ceil(n_rows / BATCH)
            check(launches == want, f"photos from {name}: {launches} flash launches, want {want}")
            check(embs[name].shape == (n_rows, 768) and bool(np.isfinite(embs[name]).all()),
                  f"photos from {name}: embeddings {embs[name].shape}, or not finite")
            by_path[f"scan photos from {name}"] = {"flash_attention": launches}
            print(f"[scan] photos from {name}: {n_rows} rows, {n_rows / path_s:.1f} rows/s end to "
                  f"end ({path_s:.3f} s); decode + resize alone {dec_s:.3f} s, the rest "
                  f"(forward and the engine) {path_s - dec_s:.3f} s; flash launches {launches} "
                  f"[{card}]", flush=True)
        keep = [i for i, b in enumerate(raw) if b is not None]
        for name, ref in (("files", embs["in memory"][keep]), ("parquet shards",
                                                               embs["in memory"])):
            got = embs[name]
            if np.array_equal(got, ref):
                print(f"[scan] photos from {name}: the embeddings equal the in-memory column's "
                      f"bit for bit [{card}]", flush=True)
                continue
            cos = cosines(got, ref)
            print(f"[scan] photos from {name}: max_abs_err {np.abs(got - ref).max():.3e} against "
                  f"the in-memory column, cosine min {cos.min():.8f} (min {PHOTO_COSINE_MIN}) "
                  f"[{card}]", flush=True)
            check(bool(cos.min() >= PHOTO_COSINE_MIN), f"photos from {name}: cosine {cos.min()}")
        del raw, embs, expr, paths
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[scan] phase 12 took {time.perf_counter() - phase_start:.1f} s [{card}]", flush=True)
    return by_path


def phase_expressions(card: str) -> dict:
    """Phase 13: TPC-H q05, q07-q10, q12-q14 and q19 through the port over
    SF1's and then SF10's tables, each against its numpy reference; q19 and
    q12 with ``device_eval`` off over SF1's; q14 traced. Returns each
    query's flash launches (0)."""
    import gc
    import resource

    import torch

    import daft_tpu_torch as dt
    from daft_tpu_torch.execution.join_index import join_counters
    from daft_tpu_torch.ops import device_eval as de
    from daft_tpu_torch.ops.flash_attention import flash_attention
    from daft_tpu_torch.tools import tpch

    phase_start = time.perf_counter()
    names = list(tpch.EXPR_QUERIES)

    def run(tables, name, **cfg):
        frames = tpch.expr_frames(dt, tables, name)
        with dt.execution_config_ctx(num_compute_threads=EXPR_WORKERS, **cfg):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = tpch.EXPR_QUERIES[name](dt, frames).to_pydict()
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0

    # SF1: every query against its reference (this warms the device programs
    # at the morsels' padded lengths), then q19 and q12 on the host route.
    t0 = time.perf_counter()
    small = tpch.tpch_tables(EXPR_CHECK_SF, seed=0, expressions=True)
    gen_s = time.perf_counter() - t0
    walls = {}
    for name in names:
        out, walls[name] = run(small, name)
        problems = tpch.expr_compare(name, out, tpch.EXPR_REFERENCES[name](small), EXPR_RTOL)
        check(not problems, f"{name} over SF{EXPR_CHECK_SF} vs the numpy reference: {problems}")
    print(f"[expr] SF{EXPR_CHECK_SF}'s tables generated in {gen_s:.1f} s; the nine queries "
          f"equal their references (warm runs): " + ", ".join(
              f"{n} {s:.3f} s" for n, s in walls.items()) + f" [{card}]", flush=True)
    for name in ("q19", "q12"):
        on, on_s = run(small, name)
        off, off_s = run(small, name, device_eval=False)
        problems = tpch.expr_compare(name, off, on, EXPR_RTOL)
        keys = [k for k, v in on.items() if v and not isinstance(v[0], float)]
        check(not problems and all(on[k] == off[k] for k in keys),
              f"{name} over SF{EXPR_CHECK_SF}: device_eval off {off} vs on {on}: {problems}")
        print(f"[expr] {name} over SF{EXPR_CHECK_SF}: device_eval on {on_s:.3f} s, off "
              f"{off_s:.3f} s, the same rows {on if name == 'q19' else on['l_shipmode']} "
              f"[{card}]", flush=True)
    del small
    gc.collect()

    t0 = time.perf_counter()
    tables = tpch.tpch_tables(EXPR_SF, seed=0, expressions=True)
    gen_s = time.perf_counter() - t0
    sizes = {t: len(next(iter(cols.values()))) for t, cols in tables.items()}
    t0 = time.perf_counter()
    refs = {name: tpch.EXPR_REFERENCES[name](tables) for name in names}
    print(f"[expr] TPC-H SF{EXPR_SF} from seed 0 with the expression columns: "
          + ", ".join(f"{t} {n}" for t, n in sizes.items())
          + f" rows, generated in {gen_s:.1f} s; numpy references in "
          f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    by_path = {}
    chain_total = 0
    for name in names:
        rows_in = sum(sizes[t] for t in tpch.EXPR_COLUMNS[name])
        gc.collect()
        de.device_eval_counters.reset()
        join_counters.reset()
        flash_attention.launch_count = 0
        out, wall = run(tables, name)
        launches = flash_attention.launch_count
        snap, joins = de.device_eval_counters.snapshot(), join_counters.snapshot()
        by_path[f"expr {name}"] = {"flash_attention": launches}
        check(launches == 0, f"{name}: flash_attention launched {launches} times")
        problems = tpch.expr_compare(name, out, refs[name], EXPR_RTOL)
        check(not problems, f"{name} over SF{EXPR_SF} vs the numpy reference: {problems}")
        floats = [k for k, v in out.items() if v and isinstance(v[0], float)]
        err = max((abs(g - w) / abs(w) for k in floats for g, w in
                   zip(out[k], refs[name][k][:len(out[k])]) if w), default=0.0)
        chain_total += sum(snap["chain_rows"].values())
        shown = {k: (v if len(v) <= 8 else v[:4] + ["..."]) for k, v in out.items()}
        print(f"[expr] {name} over {rows_in} rows at {EXPR_WORKERS} workers: {wall:.3f} s = "
              f"{rows_in / wall:.4e} rows/s; keys exact, largest relative error "
              f"{err:.2e} against the f64 reference (tol {EXPR_RTOL}); {shown}; flash "
              f"launches 0 [{card}]", flush=True)
        print(f"[expr] {name} counters: chain_rows {snap['chain_rows']}, fused_rows "
              f"{snap['fused_rows']}, host_rows {snap['host_rows']}; joins: " + "; ".join(
                  f"{j['how']} on {j['on']}: build {j['build_rows']}, " + ", ".join(
                      f"{route} {r['rows_in']} in / {r['rows_out']} out"
                      for route, r in j["routes"].items()) for j in joins), flush=True)
        if name == "q19":
            check(not snap["chain_rows"].get("filter_project")
                  and snap["host_rows"].get("chain_not_fusable", 0) >= sizes["lineitem"],
                  f"q19: its filters must be refused whole and run on the host: {snap}")
    check(chain_total > 0, "no device chain ran in the nine queries")
    frames = tpch.expr_frames(dt, tables, EXPR_TRACED)
    with dt.execution_config_ctx(num_compute_threads=EXPR_WORKERS):
        trace_window(card, "expr", f"{EXPR_TRACED} over SF{EXPR_SF}'s tables",
                     lambda: tpch.EXPR_QUERIES[EXPR_TRACED](dt, frames).to_pydict(), warm=False)
    del tables, refs, frames
    gc.collect()
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    print(f"[expr] the process's peak RSS so far {peak:.2f} GB; phase 13 took "
          f"{time.perf_counter() - phase_start:.1f} s [{card}]", flush=True)
    return by_path


_TABLE_OF_PREFIX = {"l_": "lineitem", "o_": "orders", "c_": "customer", "ps": "partsupp",
                    "p_": "part", "s_": "supplier", "n_": "nation", "r_": "region"}


def join_order(plan) -> str:
    """The join tree of a logical plan as text: ``(probe ⋈ build)`` per inner
    join, other kinds by their type, a relation by its table."""
    from daft_tpu_torch.logical import plan as lp

    if isinstance(plan, lp.Join):
        left, right = (join_order(c) for c in plan.children())
        mark = "⋈" if plan.how == "inner" else f"⋈[{plan.how}]"
        return f"({left} {mark} {right})"
    kids = plan.children()
    if isinstance(plan, lp.Aggregate):
        return f"agg({join_order(kids[0])})"
    if not kids:
        first = plan.schema.column_names()[0]
        return next((t for pre, t in _TABLE_OF_PREFIX.items() if first.startswith(pre)), first)
    return join_order(kids[0]) if len(kids) == 1 else \
        f"{plan.name()}({', '.join(join_order(k) for k in kids)})"


def phase_sql(card: str) -> dict:
    """Phase 14: TPC-H q01-q22 in SQL over SF1's seeded tables and q01, q18
    and q21 over SF10's, each against its numpy reference, the DataFrame
    forms against the SQL forms, q18 traced. Returns each query's flash
    launches (0) and, for phases 15 and 16, SF10's tables and frames, the
    answers, q01's, q18's and q21's wall s, counters, joins and RSS growth,
    and SF1's tables and frames."""
    import gc
    import resource

    import torch

    import daft_tpu_torch as dt
    from daft_tpu_torch.execution.join_index import join_counters
    from daft_tpu_torch.execution.memledger import get_ledger, read_rss_bytes
    from daft_tpu_torch.logical.optimizer import Optimizer
    from daft_tpu_torch.ops import device_eval as de
    from daft_tpu_torch.ops.flash_attention import flash_attention
    from daft_tpu_torch.tools import out_of_core, tpch, tpch_sql

    phase_start = time.perf_counter()
    names = list(tpch_sql.RUNNABLE)

    last = {}

    def run_sql(frames, name, sf):
        """(rows, wall s, plan s, optimize s, the optimized plan); the
        query's RSS growth (its ledger block's sampled high-water less the
        RSS before it) in ``last``."""
        with dt.execution_config_ctx(num_compute_threads=SQL_WORKERS):
            rss0 = read_rss_bytes()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            df = dt.sql(tpch_sql.sql_text(name, sf), **frames)
            t1 = time.perf_counter()
            plan = Optimizer().optimize(df._builder.plan)
            t2 = time.perf_counter()
            out = df.to_pydict()
            torch.cuda.synchronize()
            t3 = time.perf_counter()
        peak = (get_ledger().profile_for(df.query_id) or {}).get("rss_peak_bytes")
        last["rss_growth"] = peak - rss0 if peak else None
        return out, t3 - t0, t1 - t0, t2 - t1, plan

    def host_literals(tables) -> bool:
        # A Python-float bound decides rows as the route that ran the
        # filter does (C.31): a device filter chain compares in f32.
        return tpch.filter_on_host(de.device_eval_counters.snapshot()["chain_rows"],
                                   len(tables["lineitem"]["l_orderkey"]))

    # SF1: each query against its reference (warms the device programs).
    t0 = time.perf_counter()
    small = tpch.tpch_tables(SQL_CHECK_SF, seed=0, sql=True)
    frames = tpch.sql_frames(dt, small)
    gen_s = time.perf_counter() - t0
    walls, small_outs, chain_total, by_path = {}, {}, 0, {}
    for name in names:
        de.device_eval_counters.reset()
        flash_attention.launch_count = 0
        out, walls[name], _, _, plan = run_sql(frames, name, SQL_CHECK_SF)
        launches = flash_attention.launch_count
        by_path[f"sql {name}"] = {"flash_attention": launches}
        check(launches == 0, f"{name} over SF{SQL_CHECK_SF}: flash_attention launched "
              f"{launches} times")
        small_outs[name] = out
        chain_total += sum(de.device_eval_counters.snapshot()["chain_rows"].values())
        ref = tpch.SQL_REFERENCES[name](small, SQL_CHECK_SF, host_literals(small))
        problems = tpch.sql_compare(name, out, ref, SQL_RTOL)
        check(not problems, f"{name} over SF{SQL_CHECK_SF} vs the numpy reference: {problems}")
        if name in SQL_JOIN_ORDERS:
            print(f"[sql] {name} join order over SF{SQL_CHECK_SF} (ReorderJoins): "
                  f"{join_order(plan)} [{card}]", flush=True)
    print(f"[sql] SF{SQL_CHECK_SF}'s tables generated in {gen_s:.1f} s; the 22 queries equal "
          f"their references (warm runs): " + ", ".join(f"{n} {s:.3f} s" for n, s in walls.items())
          + f" [{card}]", flush=True)
    check("q16" in walls, "q16 must run in SQL (count(DISTINCT ...))")
    print(f"[sql] q16 over SF{SQL_CHECK_SF} ({len(small_outs['q16']['supplier_cnt'])} groups, "
          f"count(DISTINCT ps_suppkey) through the list partials) equals its reference in "
          f"{walls['q16']:.3f} s [{card}]", flush=True)
    # The DataFrame forms over SF1's tables (cut from SF10 to keep the run
    # inside its limit; phase 15 runs on SF10's).
    for name in SQL_FRAME_FORMS:
        gc.collect()
        join_counters.reset()
        df = tpch.frame_query(dt, small, name)
        written = join_order(df._builder.plan)
        chosen = join_order(Optimizer().optimize(df._builder.plan))
        with dt.execution_config_ctx(num_compute_threads=SQL_WORKERS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            frame = df.to_pydict()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        problems = tpch.frame_compare(name, small_outs[name], frame, SQL_RTOL)
        check(not problems, f"{name}: the SQL form vs the DataFrame form: {problems}")
        builds = [j["build_rows"] for j in join_counters.snapshot()]
        print(f"[sql] {name} DataFrame form over SF{SQL_CHECK_SF}: {wall:.3f} s at "
              f"{SQL_WORKERS} workers, equal to the SQL form; build rows {builds}; join order "
              f"as written {written}, after the optimizer "
              f"{chosen}{'' if chosen == written else ' (reordered)'} [{card}]", flush=True)
    # Phase 16 runs on SF1's tables and frames too.
    small_frames = frames
    del small_outs
    gc.collect()

    t0 = time.perf_counter()
    tables = tpch.tpch_tables(SQL_SF, seed=0, sql=True)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    frames = tpch.sql_frames(dt, tables)
    frames_s = time.perf_counter() - t0
    sizes = {t: len(next(iter(cols.values()))) for t, cols in tables.items()}
    print(f"[sql] TPC-H SF{SQL_SF} from seed 0 with every column q01-q22 read: "
          + ", ".join(f"{t} {n}" for t, n in sizes.items())
          + f" rows, generated in {gen_s:.1f} s, date32 frames in {frames_s:.1f} s "
          f"[{card}]", flush=True)
    outs, device_rows, unlimited = {}, {}, {}
    ref_s = 0.0
    for name in out_of_core.QUERIES:
        gc.collect()
        de.device_eval_counters.reset()
        join_counters.reset()
        flash_attention.launch_count = 0
        out, wall, plan_s, opt_s, _ = run_sql(frames, name, SQL_SF)
        launches = flash_attention.launch_count
        snap, joins = de.device_eval_counters.snapshot(), join_counters.snapshot()
        by_path[f"sql {name}"] = {"flash_attention": launches}
        check(launches == 0, f"{name}: flash_attention launched {launches} times")
        host = host_literals(tables)
        t0 = time.perf_counter()
        ref = tpch.SQL_REFERENCES[name](tables, SQL_SF, host)
        ref_s += time.perf_counter() - t0
        problems = tpch.sql_compare(name, out, ref, SQL_RTOL)
        check(not problems, f"{name} over SF{SQL_SF} vs the numpy reference: {problems}")
        check(all(len(v) for v in out.values()), f"{name} over SF{SQL_SF}: an empty result")
        outs[name] = out
        # Phase 15 reads these beside its own.
        unlimited[name] = {"wall_s": wall, "counters": snap, "joins": joins,
                           "rss_growth": last["rss_growth"]}
        chain_total += sum(snap["chain_rows"].values())
        device_rows[name] = snap["fused_rows"] + sum(snap["chain_rows"].values())
        rows = len(next(iter(out.values())))
        shown = {k: (v if len(v) <= 4 else v[:3] + ["..."]) for k, v in out.items()}
        print(f"[sql] {name} over SF{SQL_SF} at {SQL_WORKERS} workers: {wall:.3f} s wall, of it "
              f"the plan {plan_s:.3f} s and Optimizer.optimize {opt_s:.3f} s timed alone (run "
              f"again inside the wall); {rows} rows equal to the reference (tol {SQL_RTOL}); "
              f"{shown}; flash launches 0 [{card}]", flush=True)
        print(f"[sql] {name} counters: chain_rows {snap['chain_rows']}, fused_rows "
              f"{snap['fused_rows']}, host_rows {snap['host_rows']}; joins: " + "; ".join(
                  f"{j['how']} on {j['on']}: build {j['build_rows']}, " + ", ".join(
                      f"{route} {r['rows_in']} in / {r['rows_out']} out"
                      for route, r in j["routes"].items()) for j in joins), flush=True)
    check(chain_total > 0, "no device chain ran in the 22 queries over SF1 and the three "
          "over SF10")
    print(f"[sql] the numpy references over SF{SQL_SF} took {ref_s:.1f} s [{card}]",
          flush=True)
    with dt.execution_config_ctx(num_compute_threads=SQL_WORKERS):
        text = tpch_sql.sql_text(SQL_TRACED, SQL_SF)
        traced = trace_window(card, "sql", f"{SQL_TRACED} over SF{SQL_SF}'s tables",
                              lambda: dt.sql(text, **frames).to_pydict(), warm=False)
    if traced is None and not device_rows[SQL_TRACED]:
        # The counters saw no row on the device and the profiler no device
        # event: every microsecond of the window was idle.
        print(f"[sql] {SQL_TRACED}'s idle share 1.0000: no device work in the window (the "
              f"profiler recorded no device event; the counters no device row) [{card}]",
              flush=True)
    gc.collect()
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    print(f"[sql] the process's peak RSS so far {peak:.2f} GB; phase 14 took "
          f"{time.perf_counter() - phase_start:.1f} s [{card}]", flush=True)
    return by_path, {"tables": tables, "frames": frames, "outs": outs, "unlimited": unlimited,
                     "small": small, "small_frames": small_frames}


def rows_equal(a: dict, b: dict, rtol: float) -> list:
    """The columns of two pydicts that differ: everything exactly but
    floats, which must agree within ``rtol``."""
    if list(a) != list(b):
        return [f"columns {list(a)} vs {list(b)}"]
    bad = []
    for c in a:
        x, y = a[c], b[c]
        if len(x) != len(y):
            bad.append(f"{c}: {len(x)} vs {len(y)} rows")
        elif any(isinstance(v, float) for v in x):
            if not all((u is None and v is None) or (u is not None and v is not None and
                                                     math.isclose(u, v, rel_tol=rtol))
                       for u, v in zip(x, y)):
                bad.append(c)
        elif x != y:
            bad.append(c)
    return bad


def report_out_of_core(card: str, tag: str, held: dict, free: dict = None) -> None:
    """Phase 15's lines for one run under the limit, beside the unlimited
    run's numbers where there is one."""
    mem, sp, snap = held["mem"], held["spill"], held["counters"]

    def gb(n):
        return "not sampled" if n is None else f"{n / 1e9:.3f} GB"

    beside = "" if free is None else f" (unlimited: {free['wall_s']:.3f} s)"
    print(f"[ooc] {tag}: {held['wall_s']:.3f} s wall under the limit{beside}; spills "
          f"{sp['spills']}, files {sp['files']}, {sp['bytes_spilled'] / 1e9:.3f} GB spilled; "
          f"best-effort reservations {sp['best_effort_reservations']} and permit gates off "
          f"{sp['permit_gates_off']} (each after a 5 s wait); ledger peak "
          f"{mem['peak_held_bytes'] / 1e9:.3f} GB, charged {mem['charged_bytes'] / 1e9:.3f} GB, "
          f"stall {mem['stall_s']:.3f} s; RSS growth over the phase's start "
          f"{gb(held['rss_growth'])}"
          + ("" if free is None else f" (unlimited, over its own start: {gb(free['rss_growth'])})")
          + f"; pinned staging {held['pinned_bytes'] / 1e6:.3f} MB (not charged) [{card}]",
          flush=True)
    ops = "; ".join(f"{op}: " + ", ".join(f"{kind} peak {k['peak'] / 1e6:.1f} MB charged "
                                          f"{k['charged'] / 1e6:.1f} MB"
                                          for kind, k in row["kinds"].items())
                    for op, row in mem["by_operator"].items())
    stalls = ", ".join(f"{op} {s:.3f} s" for op, s in held["stall_s_by_op"].items()) or "none"
    print(f"[ooc] {tag} ledger by operator: {ops}; stalls by operator: {stalls}", flush=True)
    routes = "; ".join(f"{j['how']} on {j['on']}: build {j['build_rows']}, " + ", ".join(
        f"{route} {r['rows_in']} in / {r['rows_out']} out" for route, r in j["routes"].items())
        for j in held["joins"]) or "none"
    line = (f"[ooc] {tag} counters: chain_rows {snap['chain_rows']}, fused_rows "
            f"{snap['fused_rows']}, host_rows {snap['host_rows']}")
    if free is not None:
        fs = free["counters"]
        line += (f" (unlimited: chain_rows {fs['chain_rows']}, fused_rows {fs['fused_rows']}, "
                 f"host_rows {fs['host_rows']})")
    print(f"{line}; joins: {routes}", flush=True)


def check_audit(tag: str, run: dict) -> None:
    """After a query: the ledger holds nothing, every permit is back and no
    spill directory remains."""
    a = run["audit"]
    check(a["held"] == 0, f"{tag}: the ledger still holds {a['held']} bytes")
    check(a["permits_out"] == 0, f"{tag}: {a['permits_out']} bytes of permits not returned")
    check(not a["spill_dirs"], f"{tag}: spill directories left: {a['spill_dirs']}")


def phase_out_of_core(card: str, state: dict) -> dict:
    """Phase 15: phase 14's SF10 database under a memory limit of 1/8 of its
    in-memory bytes: TPC-H q01, q18 and q21 in SQL against phase 14's
    answers, the sort of the orders and a distinct over lineitem against
    numpy, with the spill, the ledger and the audit after each; q21 under a
    2 s deadline.
    Returns each path's flash launches (0)."""
    import gc
    import shutil
    import tempfile

    import numpy as np
    import torch

    import daft_tpu_torch as dt
    from daft_tpu_torch.errors import DaftTimeoutError
    from daft_tpu_torch.execution.memledger import read_rss_bytes
    from daft_tpu_torch.execution.spill import sink_budget
    from daft_tpu_torch.ops.flash_attention import flash_attention
    from daft_tpu_torch.tools import out_of_core, tpch

    phase_start = time.perf_counter()
    frames, tables, outs = state["frames"], state["tables"], state["outs"]
    total = out_of_core.tables_bytes(frames)
    limit = out_of_core.limit_for(frames)
    root = tempfile.gettempdir()
    free_bytes = shutil.disk_usage(root).free
    print(f"[ooc] SF{SQL_SF}'s tables {total / 1e9:.3f} GB in memory; the limit 1/8 = "
          f"{limit / 1e9:.3f} GB (a sink's budget {sink_budget(limit) / 1e9:.3f} GB); the spill "
          f"root {root} has {free_bytes / 1e9:.1f} GB free [{card}]", flush=True)
    check(free_bytes >= 2 * total, f"the spill root {root} has {free_bytes} bytes free, fewer "
          f"than twice the tables' {total} bytes")
    rss0 = read_rss_bytes()
    by_path = {}

    def run(tag, df_fn, lim, arrow=False):
        flash_attention.launch_count = 0
        t0 = time.perf_counter()
        gc.collect()
        gc_s = time.perf_counter() - t0
        with dt.execution_config_ctx(num_compute_threads=SQL_WORKERS):
            torch.cuda.synchronize()
            r = out_of_core.run(df_fn, lim, arrow=arrow)
            torch.cuda.synchronize()
        print(f"[ooc] {tag}: {time.perf_counter() - t0:.3f} s for the call (gc {gc_s:.3f} s, "
              f"the query's wall {r['wall_s']:.3f} s); {time.perf_counter() - phase_start:.1f} s "
              f"into the phase", flush=True)
        check(flash_attention.launch_count == 0,
              f"{tag}: flash_attention launched {flash_attention.launch_count} times")
        if lim is not None:
            by_path[f"ooc {tag}"] = {"flash_attention": 0}
        check_audit(tag, r)
        if lim is not None and r["mem"].get("rss_peak_bytes"):
            r["rss_growth"] = r["mem"]["rss_peak_bytes"] - rss0
        return r

    for name in out_of_core.QUERIES:
        text = tpch_sql_text(name)
        held = run(name, lambda: dt.sql(text, **frames), limit)
        problems = rows_equal(held["rows"], outs[name], SQL_RTOL)
        check(not problems, f"{name} under the limit vs phase 14's answer: {problems}")
        if name != "q01":
            check(held["spill"]["spills"] > 0, f"{name} did not spill at {limit} bytes")
        report_out_of_core(card, name, held, state["unlimited"][name])

    # The orders' sort (phase 10's keys) under the limit: ties keep no fixed
    # order across runs, so the keys must come in numpy's order and every row
    # must carry its own keys. The keys' reference is one numpy sort of the
    # packed (o_custkey, -o_orderdate): an unlimited engine sort of the same
    # keys took 9.3-10.8 s on the H100's host.
    keys, desc = ["o_custkey", "o_orderdate"], [False, True]
    held = run("sort", lambda: frames["orders"].sort(keys, desc=desc), limit, True)
    check(held["spill"]["spills"] > 0, f"the sort did not spill at {limit} bytes")
    o = tables["orders"]
    packed = np.sort((o["o_custkey"].astype(np.int64) << 32)
                     | (np.int64(0x7FFFFFFF) - o["o_orderdate"].astype(np.int64)))
    ship_days = held["rows"]["o_orderdate"].cast("int32").to_numpy() - np.int64(tpch.DAYS_TO_EPOCH)
    check(np.array_equal(held["rows"]["o_custkey"].to_numpy(), packed >> 32),
          "the sort's o_custkey differs from numpy's order")
    check(np.array_equal(ship_days, np.int64(0x7FFFFFFF) - (packed & 0xFFFFFFFF)),
          "the sort's o_orderdate differs from numpy's order")
    del packed, ship_days
    # Each sorted row's order by its key, through a dense map of the sparse
    # keys (a binary search per row costs seconds more at 15 M rows).
    got_keys = held["rows"]["o_orderkey"].to_numpy()
    pos = np.full(int(o["o_orderkey"].max()) + 1, -1, dtype=np.int64)
    pos[o["o_orderkey"]] = np.arange(len(o["o_orderkey"]))
    check(len(got_keys) == 0 or (got_keys.min() >= 0 and got_keys.max() < len(pos)),
          "the external sort returned an order key outside the table's")
    at = pos[got_keys]
    check(bool((at >= 0).all()), "the external sort returned an order key the table lacks")
    check(np.array_equal(o["o_custkey"][at], held["rows"]["o_custkey"].to_numpy()),
          "the external sort moved o_custkey apart from its rows")
    check(len(at) == len(o["o_orderkey"])
          and int(np.bincount(at, minlength=len(at)).max(initial=0)) <= 1,
          "the external sort lost or repeated rows")
    del pos
    report_out_of_core(card, f"sort of {len(at)} orders", held)
    print(f"[ooc] the sort checked; {time.perf_counter() - phase_start:.1f} s into the phase",
          flush=True)

    # A grace distinct of (l_orderkey, l_suppkey) against numpy's unique,
    # over the first half of lineitem's rows (cut from all of them, 40.4 s,
    # to keep the run inside its limit); under the same limit it must spill.
    text = "SELECT DISTINCT l_orderkey, l_suppkey FROM lineitem"
    li = tables["lineitem"]
    half = len(li["l_orderkey"]) // 2
    pairs = dt.from_pydict({k: li[k][:half] for k in ("l_orderkey", "l_suppkey")})
    held = run("distinct", lambda: dt.sql(text, lineitem=pairs), limit, True)
    check(held["spill"]["spills"] > 0, f"the distinct did not spill at {limit} bytes")
    # numpy's unique through a stable sort: np.unique's default sort took
    # 64 s on these pairs (nearly sorted, lineitem's order) on the H100's host.
    want = np.sort((li["l_orderkey"][:half].astype(np.int64) << 20)
                   | li["l_suppkey"][:half].astype(np.int64), kind="stable")
    want = want[np.concatenate(([True], want[1:] != want[:-1]))]
    got = np.sort((held["rows"]["l_orderkey"].to_numpy().astype(np.int64) << 20)
                  | held["rows"]["l_suppkey"].to_numpy().astype(np.int64))
    check(len(got) == len(want) and np.array_equal(got, want),
          f"the distinct's {len(got)} pairs differ from numpy's {len(want)}")
    report_out_of_core(card, f"distinct ({len(got)} pairs of {half} rows)", held)
    print(f"[ooc] the distinct checked; {time.perf_counter() - phase_start:.1f} s into the phase",
          flush=True)
    del held, want, got, pairs

    # q21 again under the limit with a deadline of 2 s.
    text = tpch_sql_text("q21")
    flash_attention.launch_count = 0
    t0 = time.perf_counter()
    try:
        with dt.execution_config_ctx(num_compute_threads=SQL_WORKERS):
            out_of_core.run(lambda: dt.sql(text, **frames), limit, timeout=2.0)
        check(False, "q21 under a 2 s deadline did not raise DaftTimeoutError")
    except DaftTimeoutError as e:
        raised = time.perf_counter() - t0
        a = wait_for_audit(limit)
        check(a == {"held": 0, "permits_out": 0, "spill_dirs": []},
              f"q21 after its deadline left {a}")
        print(f"[ooc] q21 under the limit and a 2 s deadline raised DaftTimeoutError after "
              f"{raised:.3f} s ({e}); then the ledger held 0 bytes, every permit was back "
              f"and no spill directory remained; {time.perf_counter() - phase_start:.1f} s into "
              f"the phase [{card}]", flush=True)
    gc.collect()
    print(f"[ooc] phase 15 took {time.perf_counter() - phase_start:.1f} s [{card}]", flush=True)
    return by_path


def phase_windows(card: str, state: dict) -> dict:
    """Phase 16: windows over SF10's orders and the remaining operators over
    SF1's lineitem (``daft_tpu_torch/tools/windows.py``), TPC-H q16 in SQL
    over SF1, and the grace window and grace repartition under 1/8 of SF1
    lineitem's bytes, each against its numpy reference or its in-memory
    answer. Returns each path's flash launches (0)."""
    import gc

    import numpy as np
    import torch

    import daft_tpu_torch as dt
    from daft_tpu_torch.execution import window_eval
    from daft_tpu_torch.kernels.hashing import hash_series
    from daft_tpu_torch.ops import device_eval as de
    from daft_tpu_torch.ops.flash_attention import flash_attention
    from daft_tpu_torch.series import Series
    from daft_tpu_torch.tools import out_of_core, tpch, tpch_sql
    from daft_tpu_torch.tools import windows as W

    phase_start = time.perf_counter()
    tables, small, small_frames = state["tables"], state["small"], state["small_frames"]
    by_path = {}
    host = [0.0]
    eval_windows = window_eval.eval_windows

    def timed_eval(*args, **kwargs):
        # The window's own host time: the executor looks eval_windows up on
        # the module at each call.
        t0 = time.perf_counter()
        try:
            return eval_windows(*args, **kwargs)
        finally:
            host[0] += time.perf_counter() - t0

    def run(tag, build, rows_in):
        """One query at SQL_WORKERS with the counts set to 0 just before:
        (its rows as one Arrow table, the device counters)."""
        gc.collect()
        de.device_eval_counters.reset()
        flash_attention.launch_count = 0
        host[0] = 0.0
        with dt.execution_config_ctx(num_compute_threads=SQL_WORKERS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            table = result_table(build())
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = flash_attention.launch_count
        by_path[f"windows {tag}"] = {"flash_attention": launches}
        check(launches == 0, f"{tag}: flash_attention launched {launches} times")
        snap = de.device_eval_counters.snapshot()
        print(f"[win] {tag}: {wall:.3f} s wall at {SQL_WORKERS} workers over {rows_in} rows, of "
              f"it the window evaluation's host s {host[0]:.3f}; {table.num_rows} rows out; "
              f"chain_rows {snap['chain_rows']}, fused_rows {snap['fused_rows']}, host_rows "
              f"{snap['host_rows']}; flash launches 0 [{card}]", flush=True)
        return table, snap

    window_eval.eval_windows = timed_eval
    try:
        # SF10's orders, o_orderdate as int32 days: the filter is a device chain.
        o = tables["orders"]
        since = int(np.percentile(o["o_orderdate"], 20))
        frame = W.orders_frame(dt, tables)
        table, snap = run(f"orders SF{SQL_SF}", lambda: W.orders_windows(dt, frame, since),
                          len(o["o_orderkey"]))
        check(sum(snap["chain_rows"].values()) > 0,
              f"the orders' filter ran no device chain: {snap['chain_rows']}")
        t0 = time.perf_counter()
        ref = W.orders_windows_reference(tables, since)
        ref_s = time.perf_counter() - t0
        problems = W.orders_windows_compare(table, ref, WINDOW_RTOL)
        check(not problems, f"the orders' windows vs the numpy reference: {problems}")
        print(f"[win] the orders' windows (running sum(o_totalprice) per o_custkey by "
              f"o_orderdate, lag(o_orderdate, 1), rank() per o_orderpriority by o_totalprice "
              f"desc) over the {table.num_rows} orders since day {since} equal the numpy "
              f"reference (keys, lags and ranks exact, sums within {WINDOW_RTOL}; reference "
              f"{ref_s:.1f} s) [{card}]", flush=True)
        del frame, table, ref

        # SF1's lineitem.
        li = small["lineitem"]
        n = len(li["l_orderkey"])
        lf = W.lineitem_frame(dt, small)
        table, _ = run(f"ratio SF{SQL_CHECK_SF}", lambda: dt.sql(
            W.RATIO_SQL, lineitem=small_frames["lineitem"]), n)
        ratio, want = table.column("ratio").to_numpy(), W.ratio_reference(small)
        err = float(np.max(np.abs(ratio - want) / want))
        check(err <= RATIO_RTOL, f"q98's ratio: max rel err {err:.3e} > {RATIO_RTOL}")
        print(f"[win] q98's ratio over {len(np.unique(li['l_partkey']))} partitions equals numpy "
              f"(max rel err {err:.3e}) [{card}]", flush=True)
        table, _ = run("row_number", lambda: W.lineitem_row_number(dt, lf), n)
        check(np.array_equal(table.column("rn").to_numpy(), W.row_number_reference(small)),
              "row_number() per l_orderkey differs from numpy")
        gc.collect()
        parts = []
        with dt.execution_config_ctx(num_compute_threads=SQL_WORKERS):
            t0 = time.perf_counter()
            flash_attention.launch_count = 0
            for mp in lf.select("l_orderkey", "l_partkey").repartition(
                    REPARTITIONS, "l_orderkey").iter_partitions():
                parts.append(mp.to_arrow_table())
            wall = time.perf_counter() - t0
        by_path["windows repartition"] = {"flash_attention": flash_attention.launch_count}
        check(flash_attention.launch_count == 0, "the repartition launched flash_attention")
        check(len(parts) == REPARTITIONS, f"repartition gave {len(parts)} partitions")
        for i, part in enumerate(parts):
            keys = Series.from_arrow(part.column("l_orderkey").combine_chunks(), "k")
            at = hash_series(keys).to_numpy() % np.uint64(REPARTITIONS)
            check(bool((at == i).all()), f"partition {i} holds rows whose hash names another")
        got = W.pairs(np.concatenate([p.column("l_orderkey").to_numpy() for p in parts]),
                      np.concatenate([p.column("l_partkey").to_numpy() for p in parts]))
        check(np.array_equal(got, W.pairs(li["l_orderkey"], li["l_partkey"])),
              "the repartition's rows differ from the input's")
        print(f"[win] repartition({REPARTITIONS}, l_orderkey): {wall:.3f} s, partitions of "
              f"{[p.num_rows for p in parts]} rows, each row in the bucket its hash names, the "
              f"input's rows [{card}]", flush=True)
        del parts, got
        table, _ = run("explode of agg_list", lambda: W.exploded_lists(dt, lf), n)
        check(np.array_equal(W.pairs(table.column("l_orderkey").to_numpy(),
                                     table.column("l_partkey").to_numpy()),
                             W.pairs(li["l_orderkey"], li["l_partkey"])),
              "explode(agg_list) does not round-trip to lineitem's (order, part) multiset")
        table, _ = run("monotonically_increasing_id", lambda: W.with_ids(dt, lf), n)
        check(np.array_equal(table.column("id").to_numpy(), np.arange(n, dtype=np.uint64))
              and np.array_equal(table.column("l_orderkey").to_numpy(), li["l_orderkey"]),
              "monotonically_increasing_id is not 0..n-1 in the input's order")
        table, _ = run("pivot", lambda: W.q01_pivot(dt, lf), n)
        pivot = table.to_pydict()
        check(pivot == W.q01_pivot_reference(small), f"q01's pivot {pivot} differs from numpy")
        print(f"[win] pivot of q01's groups by l_linestatus: {pivot} [{card}]", flush=True)
        want_i, want_e = W.suppkey_sets_reference(small)
        for tag, k, want in (("intersect_all", 0, want_i), ("except_all", 1, want_e)):
            table, _ = run(tag, lambda k=k: W.suppkey_sets(dt, lf)[k], n)
            got = np.sort(table.column("l_suppkey").to_numpy())
            check(np.array_equal(got, want), f"{tag} on l_suppkey: {len(got)} rows vs numpy's "
                  f"{len(want)}")
        q16 = tpch_sql.sql_text("q16", SQL_CHECK_SF)
        table, _ = run(f"q16 SF{SQL_CHECK_SF}", lambda: dt.sql(q16, **small_frames),
                       len(small["partsupp"]["ps_partkey"]))
        problems = tpch.sql_compare("q16", table.to_pydict(), tpch.SQL_REFERENCES["q16"](
            small, SQL_CHECK_SF, True), SQL_RTOL)
        check(not problems, f"q16 vs the numpy reference: {problems}")

        # The grace window and the grace hash repartition at 1/8 of lineitem.
        limit = max(out_of_core.tables_bytes({"lineitem": lf}) // 8, out_of_core.MIN_LIMIT_BYTES)
        for tag, build, kw in (
                ("grace window", lambda: W.order_window(dt, lf), {"arrow": True}),
                ("grace repartition", lambda: lf.select("l_orderkey", "l_partkey").repartition(
                    REPARTITIONS, "l_orderkey"), {"parts": True})):
            with dt.execution_config_ctx(num_compute_threads=SQL_WORKERS):
                free = out_of_core.run(build, None, **kw)
                flash_attention.launch_count = 0
                held = out_of_core.run(build, limit, **kw)
            by_path[f"windows {tag}"] = {"flash_attention": flash_attention.launch_count}
            check(flash_attention.launch_count == 0, f"{tag}: flash_attention launched")
            check_audit(tag, held)
            check(held["spill"]["spills"] > 0, f"the {tag} did not spill at {limit} bytes")
            if kw.get("parts"):
                same = len(held["rows"]) == len(free["rows"]) == REPARTITIONS and all(
                    W.sorted_by(a, ["l_orderkey", "l_partkey"]).equals(
                        W.sorted_by(b, ["l_orderkey", "l_partkey"]))
                    for a, b in zip(held["rows"], free["rows"]))
            else:
                keys = ["l_orderkey", "rn"]
                same = W.sorted_by(held["rows"], keys).equals(W.sorted_by(free["rows"], keys))
            check(same, f"the {tag} under the limit differs from its in-memory answer")
            report_out_of_core(card, f"{tag} at 1/8 of SF{SQL_CHECK_SF} lineitem "
                               f"({limit / 1e9:.3f} GB)", held, free)
            del free, held
    finally:
        window_eval.eval_windows = eval_windows
    gc.collect()
    print(f"[win] phase 16 took {time.perf_counter() - phase_start:.1f} s [{card}]", flush=True)
    return by_path


def phase_surface(card: str, state: dict) -> dict:
    """Phase 17: the DataFrame surface on phase 14's tables: the torch
    loader into CUDA tensors over SF10's lineitem, ``from_arrow`` /
    ``to_arrow`` of SF10's orders, q01's answer over SF1 through ``to_pylist``
    / ``to_arrow`` / ``to_pandas``, ``show`` and ``explain``, and ``summarize``
    of SF1's orders on the card's route against the host route. Returns each
    path's flash launches (0)."""
    import gc

    import numpy as np
    import torch

    import daft_tpu_torch as dt
    from daft_tpu_torch.ops import device_eval as de
    from daft_tpu_torch.ops.flash_attention import flash_attention
    from daft_tpu_torch.tools import tpch, tpch_sql

    phase_start = time.perf_counter()
    by_path = {}

    def run(tag, build, main=True):
        """``build()`` with the counts set to 0 just before: (its value, wall
        s, the device counters). A ``main`` path's flash launches go into the
        kernels line."""
        gc.collect()
        de.device_eval_counters.reset()
        flash_attention.launch_count = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = build()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = flash_attention.launch_count
        if main:
            by_path[f"surface {tag}"] = {"flash_attention": launches}
        check(launches == 0, f"{tag}: flash_attention launched {launches} times")
        return out, wall, de.device_eval_counters.snapshot()

    # SF10 lineitem's numeric columns through the torch loader onto the card.
    li = state["tables"]["lineitem"]
    cols = {c: np.asarray(li[c][:SURFACE_ROWS]) for c in SURFACE_COLUMNS}
    frame = dt.from_pydict(cols)
    pinned = []

    def load():
        got = {c: [] for c in SURFACE_COLUMNS}
        for batch in frame.to_torch_dataloader(batch_size=SURFACE_BATCH, pin_memory=True):
            pinned.append(all(batch[c].is_pinned() for c in SURFACE_COLUMNS))
            for c in SURFACE_COLUMNS:
                got[c].append(batch[c].to("cuda", non_blocking=True))
        return {c: torch.cat(parts) for c, parts in got.items()}

    loaded, wall, _ = run("to_torch_dataloader", load)
    check(all(pinned), f"{pinned.count(False)} of {len(pinned)} loader batches not pinned")
    for c in SURFACE_COLUMNS:
        t = loaded[c]
        host, want = t.cpu().numpy(), cols[c]
        wide = want.astype(host.dtype)
        check(t.is_cuda and host.shape == want.shape and np.array_equal(
            host.view(np.uint64 if host.itemsize == 8 else np.uint32),
            wide.view(np.uint64 if host.itemsize == 8 else np.uint32)),
              f"the loader's {c} on the card differs from the column (bit for bit)")
    nbytes = sum(t.numel() * t.element_size() for t in loaded.values())
    print(f"[surface] to_torch_dataloader(batch_size={SURFACE_BATCH}, pin_memory=True) over "
          f"{SURFACE_ROWS} rows of SF{SQL_SF} lineitem's {', '.join(SURFACE_COLUMNS)} into "
          f"CUDA tensors (non_blocking copies): {wall:.3f} s, {SURFACE_ROWS / wall:.0f} rows/s, "
          f"{len(pinned)} pinned batches, {nbytes / 1e6:.1f} MB on the card as "
          f"{sorted({str(t.dtype) for t in loaded.values()})}; equal to the columns bit for bit "
          f"[{card}]", flush=True)
    del loaded, frame, cols

    # from_arrow(orders.to_arrow()) over SF10's orders.
    sf10_orders = state["frames"]["orders"]
    (table, back), wall, _ = run("from_arrow", lambda: (
        lambda t: (t, dt.from_arrow(t).to_arrow()))(sf10_orders.to_arrow()))
    check(back.equals(table), "from_arrow(orders.to_arrow()).to_arrow() differs from the orders")
    print(f"[surface] from_arrow(orders.to_arrow()) over SF{SQL_SF}'s {table.num_rows} orders "
          f"({table.nbytes / 1e9:.3f} GB, {table.num_columns} columns): {wall:.3f} s, equal to "
          f"orders.to_arrow() (pa.Table.equals) [{card}]", flush=True)
    del table, back

    # q01's answer through the exporters, show() and explain(), over SF1's
    # tables (cut from SF10 to keep the phase inside its 20 s: the query
    # alone took 3.8 s there).
    small, frames = state["small"], state["small_frames"]
    text = tpch_sql.sql_text("q01", SQL_CHECK_SF)
    q01, wall, snap = run("q01", lambda: dt.sql(text, **frames).collect())
    answer = q01.to_pydict()
    host = tpch.filter_on_host(snap["chain_rows"], len(small["lineitem"]["l_orderkey"]))
    problems = tpch.sql_compare("q01", answer, tpch.SQL_REFERENCES["q01"](
        small, SQL_CHECK_SF, host), SQL_RTOL)
    check(not problems, f"q01 over SF{SQL_CHECK_SF} vs the numpy reference: {problems}")
    names = list(answer)
    check(q01.to_pylist() == [dict(zip(names, vals)) for vals in zip(*answer.values())],
          "q01's to_pylist differs from its to_pydict")
    check(q01.to_arrow().to_pydict() == answer, "q01's to_arrow differs from its to_pydict")
    pdf = q01.to_pandas()
    check(list(pdf.columns) == names and {c: [v.item() if hasattr(v, "item") else v
                                             for v in pdf[c].tolist()] for c in names} == answer,
          "q01's to_pandas differs from its to_pydict")
    print(f"[surface] q01 over SF{SQL_CHECK_SF}: {wall:.3f} s; to_pylist, to_arrow and "
          f"to_pandas (pandas {__import__('pandas').__version__}) equal its to_pydict, which "
          f"equals the numpy reference (tol {SQL_RTOL}); chain_rows {snap['chain_rows']}, "
          f"host_rows {snap['host_rows']} [{card}]", flush=True)
    print(f"[surface] show() of q01's answer [{card}]:", flush=True)
    dt.from_pydict(answer).show()
    print(f"[surface] explain() of q01 [{card}]:", flush=True)
    dt.sql(text, **frames).explain()

    # summarize() over SF1's orders (cut from SF10: a run over 15,000,000
    # orders would take about 20 s), on the card's route and the host route.
    orders = frames["orders"]
    rows = len(small["orders"]["o_orderkey"])
    card_rows, card_wall, card_snap = run("summarize", lambda: orders.summarize().to_pydict())
    with dt.execution_config_ctx(device_eval=False, compiled_eval_enabled=False):
        host_rows, host_wall, host_snap = run("summarize host", lambda: orders.summarize()
                                              .to_pydict(), main=False)
    check(card_rows == host_rows, "summarize() on the card's route differs from the host route")
    check(card_rows["count"] == [rows] * len(card_rows["column"]),
          f"summarize()'s counts {card_rows['count']} are not the {rows} orders")
    print(f"[surface] summarize() over SF{SQL_CHECK_SF}'s {rows} orders: {card_wall:.3f} s on the "
          f"card's route (device counters: fused_rows {card_snap['fused_rows']}, chain_rows "
          f"{card_snap['chain_rows']}, host_rows {card_snap['host_rows']}, program misses "
          f"{card_snap['program_misses']}), {host_wall:.3f} s on the host route (host_rows "
          f"{host_snap['host_rows']}); equal row for row; approx_count_distinct "
          f"{dict(zip(card_rows['column'], card_rows['approx_count_distinct']))} [{card}]",
          flush=True)
    # SF1's orders stay for phase 18's UDAF and phase 19's sort, SF10's
    # lineitem and q01's answer for phase 19; the rest goes.
    state["udaf_orders"] = (small["orders"], frames["orders"])
    state["obs"] = {"lineitem": state["frames"]["lineitem"], "q01": state["outs"]["q01"]}
    del state["tables"], state["frames"], state["outs"], state["small"], state["small_frames"]
    gc.collect()
    print(f"[surface] phase 17 took {time.perf_counter() - phase_start:.1f} s [{card}]",
          flush=True)
    return by_path


def write_mcap(path, messages, compression: str) -> None:
    """An MCAP file (magic, header, two channels, the messages in one chunk
    compressed with ``compression`` through ``pa.Codec``, data end, footer);
    ``messages`` holds (channel id, sequence, log time, publish time, bytes)."""
    import struct

    import pyarrow as pa

    def rec(op, payload):
        return bytes([op]) + struct.pack("<Q", len(payload)) + payload

    def s(text):
        return struct.pack("<I", len(text.encode())) + text.encode()

    body = b"".join(rec(0x04, struct.pack("<HH", cid, 1) + s(topic) + s("cdr")
                        + struct.pack("<I", 0)) for cid, topic in ((1, "/camera"), (2, "/imu")))
    body += b"".join(rec(0x05, struct.pack("<HIQQ", cid, seq, log_t, pub_t) + data)
                     for cid, seq, log_t, pub_t, data in messages)
    blob = pa.Codec(compression).compress(body, asbytes=True)
    chunk = rec(0x06, struct.pack("<QQQI", messages[0][2], messages[-1][2], len(body), 0)
                + s(compression) + struct.pack("<Q", len(blob)) + blob)
    magic = b"\x89MCAP0\r\n"
    path.write_bytes(magic + rec(0x01, s("") + s("chip_smoke")) + chunk
                     + rec(0x0F, struct.pack("<I", 0)) + rec(0x02, struct.pack("<QQI", 0, 0, 0))
                     + magic)


def write_wav(path, rate: int, channels: int, seed: int):
    """One second of seeded 16-bit PCM at ``rate``; returns the samples."""
    import wave

    import numpy as np

    pcm = np.random.default_rng(seed).integers(-32768, 32767, (rate, channels), dtype=np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())
    return pcm


def phase_udfs_media(card: str, state: dict) -> dict:
    """Phase 18: the UDF decorators, the UDAFs and the media functions and
    sources. A stateful ``@cls`` UDF that holds the CLIP ViT-L/14 image tower
    on the card and embeds 512 images in its ``@method.batch`` at
    ``max_concurrency`` 2 and 1; a row-wise ``@func`` over 1,000,000 rows;
    seeded MP4s through ``from_files`` -> ``video_file`` -> ``video_frames``
    -> ``explode`` -> ``embed_image`` and through ``read_video_frames`` ->
    ``embed_image``; ``run_process``, ``read_mcap`` and the WAV kernels; a
    UDAF with ``merge`` over SF1's orders (kept by phase 17). Returns each
    path's flash launches."""
    import gc
    import glob
    import pathlib
    import shutil
    import tempfile

    import numpy as np
    import pyarrow as pa
    import pyarrow.compute as pc
    import torch

    import daft_tpu_torch as dt
    from daft_tpu_torch import functions as F
    from daft_tpu_torch.functions.ai import embed_image
    from daft_tpu_torch.functions.media import _keyframe_indices
    from daft_tpu_torch.models.clip import CLIPConfig, CLIPImageEncoder, embed, init_random_
    from daft_tpu_torch.ops.flash_attention import flash_attention

    phase_start = time.perf_counter()
    by_path = {}

    def run(tag, build, main=True):
        """``build()`` with the counts set to 0 just before: (its value, wall
        s, flash launches); a ``main`` path's launches go into the kernels line."""
        gc.collect()
        flash_attention.launch_count = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = build()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = flash_attention.launch_count
        if main:
            by_path[f"udf {tag}"] = {"flash_attention": launches}
        return out, wall, launches

    def direct(encoder, frames: np.ndarray) -> np.ndarray:
        """``frames`` through ``encoder`` in full chunks of BATCH rows."""
        return np.concatenate([embed(encoder, torch.from_numpy(frames[i:i + BATCH].copy()).cuda())
                               .float().cpu().numpy() for i in range(0, len(frames), BATCH)])

    # -- a stateful UDF that holds the image tower on the card -----------------
    built = []
    emb_dtype = dt.DataType.embedding(dt.DataType.float32(), 768)

    @dt.cls(max_concurrency=2, gpus=1, batch_size=BATCH)
    class ImageTower:
        def __init__(self, seed: int):
            built.append(seed)
            self.encoder = init_random_(CLIPImageEncoder(CLIPConfig.vit_l_14(), device="cuda"),
                                        torch.Generator("cuda").manual_seed(seed))
            self.encoder.eval().requires_grad_(False)

        @dt.method.batch(return_dtype=emb_dtype)
        def embed_images(self, images):
            px = images.to_numpy_masked()[0].reshape(-1, IMAGE, IMAGE, 3)
            return torch.cat([embed(self.encoder, torch.from_numpy(px[i:i + BATCH].copy()).cuda())
                              .float() for i in range(0, len(px), BATCH)]).cpu().numpy()

    rng = np.random.default_rng(0)  # phase 3's images
    imgs = rng.integers(0, 256, (NUM_IMAGES, IMAGE * IMAGE * 3), dtype=np.uint8)
    frame = dt.from_pydict({"img": dt.Series.from_numpy(
        imgs, "img", dt.DataType.image("RGB", IMAGE, IMAGE))})
    tower = ImageTower(0)
    with dt.execution_config_ctx(default_morsel_size=BATCH):
        t0 = time.perf_counter()
        frame.limit(BATCH).select(tower.embed_images(dt.col("img"))).collect()  # builds it
        print(f"[udf] the class's __init__ (ViT-L/14 on the card) and a first chunk: "
              f"{time.perf_counter() - t0:.3f} s [{card}]", flush=True)
    outs = {}
    for conc in (2, 1):
        udf = tower.embed_images.with_concurrency(conc)
        with dt.execution_config_ctx(default_morsel_size=BATCH):
            (got, wall, launches) = run(f"cls max_concurrency={conc}", lambda: np.asarray(
                frame.select(udf(dt.col("img")).alias("e")).to_pydict()["e"], np.float32))
        outs[conc] = got
        chunks = NUM_IMAGES // BATCH
        norms = np.linalg.norm(got, axis=1)
        check(got.shape == (NUM_IMAGES, 768) and bool(np.isfinite(got).all()),
              f"the stateful UDF's embeddings at max_concurrency={conc}: shape {got.shape}, "
              f"finite {bool(np.isfinite(got).all())}")
        check(bool(np.abs(norms - 1).max() < 1e-3), f"norms off 1 by {np.abs(norms - 1).max()}")
        check(launches == VIT_L_LAYERS * chunks, f"the stateful UDF at max_concurrency={conc}: "
              f"flash_attention launched {launches} times, expected {VIT_L_LAYERS} x {chunks}")
        print(f"[udf] @cls(max_concurrency={conc}, gpus=1) ViT-L/14 tower, @method.batch over "
              f"{NUM_IMAGES} images in morsels of {BATCH}: {wall:.3f} s = "
              f"{NUM_IMAGES / wall:.1f} rows/s; flash launches {launches} for {chunks} chunks "
              f"[{card}]", flush=True)
    check(built == [0], f"the stateful class was built {len(built)} times: {built}")
    check(outs[1].tobytes() == outs[2].tobytes(),
          "the stateful UDF's embeddings differ between max_concurrency 1 and 2")
    inst = tower.embed_images._get_instance()
    want = direct(inst.encoder, imgs.reshape(-1, IMAGE, IMAGE, 3))
    err = float(np.abs(want - outs[1]).max())
    check(err <= CHUNK_TOL, f"the stateful UDF's rows differ from a direct embed by {err}")
    print(f"[udf] the class built once; max_concurrency 1 and 2 the same bytes; against a "
          f"direct embed of the same tower: max_abs_err {err:.3e} (tol {CHUNK_TOL}) [{card}]",
          flush=True)
    del frame, outs, want

    # -- a row-wise UDF, one Python call per row ---------------------------------
    @dt.func(return_dtype=dt.DataType.int64())
    def affine(x):
        return x * 3 + 1

    xs = np.random.default_rng(1).integers(-(1 << 40), 1 << 40, ROWWISE_ROWS)
    rows_df = dt.from_pydict({"x": xs})
    got, wall, launches = run("func rowwise", lambda: rows_df.select(
        affine(dt.col("x"))).to_pydict()["x"])
    check(launches == 0 and np.array_equal(np.asarray(got, np.int64), xs * 3 + 1),
          "the row-wise UDF's rows differ from numpy's x * 3 + 1")
    print(f"[udf] @func x * 3 + 1 over {ROWWISE_ROWS} int64 rows: {wall:.3f} s = "
          f"{ROWWISE_ROWS / wall:.0f} rows/s, equal to numpy [{card}]", flush=True)
    del rows_df, got, xs

    # -- video frames into the main path -------------------------------------------
    import cv2

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="smoke_media_"))
    try:
        t0 = time.perf_counter()
        vrng = np.random.default_rng(2)
        for v in range(VIDEO_FILES):
            vw = cv2.VideoWriter(str(tmp / f"v{v}.mp4"), cv2.VideoWriter_fourcc(*"mp4v"),
                                 VIDEO_FPS, (VIDEO_WIDTH, VIDEO_HEIGHT))
            check(vw.isOpened(), "cv2's MP4 writer did not open")
            base = vrng.integers(0, 256, (VIDEO_HEIGHT, VIDEO_WIDTH, 3), dtype=np.uint8)
            for i in range(VIDEO_FRAMES):
                vw.write(np.roll(base, 5 * i, axis=1))
            vw.release()
        paths = sorted(glob.glob(str(tmp / "*.mp4")))
        keys = {p: _keyframe_indices(pathlib.Path(p).read_bytes()) for p in paths}
        print(f"[video] {VIDEO_FILES} seeded MP4s (mp4v, {VIDEO_FRAMES} frames of "
              f"{VIDEO_WIDTH}x{VIDEO_HEIGHT} at {VIDEO_FPS} fps) written in "
              f"{time.perf_counter() - t0:.3f} s; sync samples of the first: "
              f"{keys[paths[0]]} [{card}]", flush=True)
        n_frames = VIDEO_FILES * VIDEO_FRAMES
        chunks = n_frames // BATCH
        pattern = str(tmp / "*.mp4")

        def engine_embed(tag, df, column):
            """``embed_image`` over ``df``'s ``column``: a warm call builds
            the tower, then the timed run."""
            expr = embed_image(dt.col(column), provider="cuda_random", model="ViT-L/14",
                               batch_size=BATCH)
            df.limit(1).select(expr.alias("e")).collect()
            got, wall, launches = run(tag, lambda: np.asarray(
                df.select(expr.alias("e")).to_pydict()["e"], np.float32))
            return got, wall, launches, expr._expr.udf._get_instance()

        # Route 1: File column -> frames -> explode -> the struct's image, in
        # partitions of BATCH frames (a file's 64 would half-fill each chunk).
        t0 = time.perf_counter()
        frames1 = (dt.from_files(pattern)
                   .select(F.video_frames(F.video_file(dt.col("file"), verify=True),
                                          width=IMAGE, height=IMAGE).alias("fr"))
                   .explode("fr")
                   .select(dt.col("fr").struct.get("frame_index").alias("frame_index"),
                           dt.col("fr").struct.get("is_key_frame").alias("is_key_frame"),
                           dt.col("fr").struct.get("data").alias("data"))
                   .into_batches(BATCH))
        decode1 = time.perf_counter() - t0
        # The pixels through Arrow: to_pydict would make a Python int of each.
        cols1 = frames1.select("frame_index", "is_key_frame").to_pydict()
        images1 = image_column(frames1, "data").to_arrow()
        check(len(images1) == n_frames and images1.null_count == 0,
              f"video_frames gave {len(images1)} frames ({images1.null_count} null), "
              f"expected {n_frames}")
        shapes = {tuple(images1.field(f)[i].as_py() for f in ("height", "width", "channel"))
                  for i in range(len(images1))}
        check(shapes == {(IMAGE, IMAGE, 3)}, f"video_frames' images have shapes {shapes}")
        px1 = np.stack([np.frombuffer(b, np.uint8).reshape(IMAGE, IMAGE, 3)
                        for b in images1.field("data").to_pylist()])
        file_of = np.repeat(np.arange(VIDEO_FILES), VIDEO_FRAMES)
        check(cols1["frame_index"] == list(range(VIDEO_FRAMES)) * VIDEO_FILES,
              "video_frames' frame indices are not 0..63 per file in glob order")
        for i, (idx, is_key) in enumerate(zip(cols1["frame_index"], cols1["is_key_frame"])):
            k = keys[paths[file_of[i]]]
            check(is_key == (k is None or idx in k),
                  f"frame {idx} of {paths[file_of[i]]}: is_key_frame {is_key}, sync samples {k}")
        emb1, wall1, launches1, inst1 = engine_embed("video from_files", frames1, "data")

        # Route 2: read_video_frames -> embed_image, in partitions of BATCH frames.
        t0 = time.perf_counter()
        frames2 = dt.read_video_frames(pattern, image_height=IMAGE,
                                       image_width=IMAGE).into_batches(BATCH)
        decode2 = time.perf_counter() - t0
        cols2 = frames2.select("frame_index", "is_key_frame").to_pydict()
        px2 = image_column(frames2, "data").to_numpy_masked()[0].reshape(-1, IMAGE, IMAGE, 3)
        check(px2.shape == px1.shape and px2.tobytes() == px1.tobytes(),
              "read_video_frames' frames differ from video_frames' (bit for bit)")
        check(cols2["frame_index"] == cols1["frame_index"]
              and cols2["is_key_frame"] == cols1["is_key_frame"],
              "read_video_frames' frame indices or key flags differ from video_frames'")
        emb2, wall2, launches2, inst2 = engine_embed("video read_video_frames", frames2, "data")
        for tag, emb_, launches_, inst_, px in (
                ("from_files", emb1, launches1, inst1, px1),
                ("read_video_frames", emb2, launches2, inst2, px2)):
            check(emb_.shape == (n_frames, 768) and bool(np.isfinite(emb_).all()),
                  f"video {tag}: embeddings of shape {emb_.shape}, finite "
                  f"{bool(np.isfinite(emb_).all())}")
            check(launches_ == VIT_L_LAYERS * chunks, f"video {tag}: flash_attention launched "
                  f"{launches_} times, expected {VIT_L_LAYERS} x {chunks} full chunks")
            err = float(np.abs(direct(inst_.encoder, px) - emb_).max())
            check(err <= CHUNK_TOL, f"video {tag}: the engine's rows differ from a direct "
                  f"forward of the same frames by {err}")
            print(f"[video] {tag}: {chunks} forward chunks of {BATCH} frames, flash launches "
                  f"{launches_}; against a direct forward max_abs_err {err:.3e} "
                  f"(tol {CHUNK_TOL}) [{card}]", flush=True)
        print(f"[video] decode: from_files -> video_file(verify=True) -> video_frames(224, 224) "
              f"-> explode {decode1:.3f} s = {n_frames / decode1:.0f} rows/s; read_video_frames "
              f"{decode2:.3f} s = {n_frames / decode2:.0f} rows/s; the two routes' frames equal "
              f"bit for bit, key flags equal to the files' stss [{card}]", flush=True)
        print(f"[video] embed_image ViT-L/14: {wall1:.3f} s = {n_frames / wall1:.1f} rows/s after "
              f"video_frames, {wall2:.3f} s = {n_frames / wall2:.1f} rows/s after "
              f"read_video_frames [{card}]", flush=True)
        del frames1, frames2, cols1, cols2, px1, px2, emb1, emb2, inst1, inst2

        # -- run_process, read_mcap and the WAV kernels --------------------------
        words = [f"w{i}-{v}" for i, v in enumerate(np.random.default_rng(3).integers(0, 999,
                                                                                     PROCESS_ROWS))]
        (echoed, shell_n), wall, _ = run("run_process", lambda: (
            dt.from_pydict({"w": words}).select(F.run_process(["echo", dt.col("w")])
                                                 .alias("o")).to_pydict()["o"],
            dt.from_pydict({"c": [f"printf '{'x' * 37}' | wc -c"]}).select(F.run_process(
                dt.col("c"), shell=True, return_dtype=dt.DataType.int64()).alias("n"))
            .to_pydict()["n"]), main=False)
        check(echoed == [w + "\n" for w in words], "run_process(echo)'s stdout differs")
        check(shell_n == [37], f"run_process(shell=True) cast to int64 gave {shell_n}")
        print(f"[media] run_process(['echo', col]) over {PROCESS_ROWS} rows and one shell=True "
              f"row cast to int64: {wall:.3f} s, stdout as expected [{card}]", flush=True)

        mrng = np.random.default_rng(4)
        messages = [(1 + (i % 2), i // 2, 1_000 + 10 * i, 995 + 10 * i,
                     mrng.bytes(int(mrng.integers(1, 64)))) for i in range(MCAP_MESSAGES)]
        mcap_path = tmp / "log.mcap"
        write_mcap(mcap_path, messages, "zstd")
        lo, hi = messages[MCAP_MESSAGES // 4][2], messages[3 * MCAP_MESSAGES // 4][2]
        mcap, wall, _ = run("read_mcap", lambda: dt.read_mcap(
            str(mcap_path), topics=["/imu"], start_time=lo, end_time=hi).to_pydict(), main=False)
        want = [m for m in messages if m[0] == 2 and lo <= m[2] <= hi]
        check(mcap["topic"] == ["/imu"] * len(want)
              and mcap["log_time"] == [m[2] for m in want]
              and mcap["publish_time"] == [m[3] for m in want]
              and mcap["sequence"] == [m[1] for m in want]
              and mcap["data"] == [m[4] for m in want],
              "read_mcap's rows differ from the messages written")
        print(f"[media] read_mcap of {MCAP_MESSAGES} messages on two topics in one zstd chunk, "
              f"topic /imu and log time in [{lo}, {hi}]: {len(want)} rows in {wall:.3f} s, "
              f"equal to the messages written [{card}]", flush=True)

        for rate, channels in WAV_RATES:
            wav = tmp / f"a{rate}.wav"
            pcm = write_wav(wav, rate, channels, seed=rate)
            (meta, res), wall, _ = run("wav", lambda: (
                lambda d: (d["m"][0], d["r"][0]))(dt.from_pydict({"p": [str(wav)]}).select(
                    F.audio_metadata(dt.col("p")).alias("m"),
                    F.resample(dt.col("p"), target_rate=RESAMPLE_RATE).alias("r")).to_pydict()),
                main=False)
            check(meta == {"sample_rate": rate, "channels": channels, "frames": rate,
                           "duration_sec": 1.0, "format": "wav"},
                  f"audio_metadata of the {rate} Hz WAV: {meta}")
            mono = pcm.astype(np.float32).mean(1) / 32768.0
            x = np.linspace(0.0, len(mono) - 1, RESAMPLE_RATE)
            ref = np.interp(x, np.arange(len(mono)), mono).astype(np.float32)
            check(np.array_equal(np.asarray(res, np.float32), ref),
                  f"resample of the {rate} Hz WAV differs from numpy's interpolation")
            print(f"[media] {rate} Hz x {channels} WAV: audio_metadata {meta}, resample to "
                  f"{RESAMPLE_RATE} Hz ({len(res)} samples) equal to numpy's, {wall:.3f} s "
                  f"[{card}]", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # -- a UDAF with merge over SF1's orders -----------------------------------------
    orders_cols, orders = state["udaf_orders"]  # phase 19 sorts them

    @dt.udf.udaf(dt.DataType.struct({"gmean": dt.DataType.float64(),
                                     "merges": dt.DataType.int64()}))
    class GeoMean:
        def __init__(self):
            self.log_sum, self.n, self.merges = 0.0, 0, 0

        def accumulate(self, values):
            self.log_sum += float(np.log(np.asarray(values, np.float64)).sum())
            self.n += len(values)

        def merge(self, other):
            self.log_sum += other.log_sum
            self.n += other.n
            self.merges += other.merges + 1

        def finalize(self):
            return {"gmean": math.exp(self.log_sum / self.n) if self.n else None,
                    "merges": self.merges}

    got, wall, launches = run("udaf", lambda: orders.groupby("o_orderpriority").agg(
        GeoMean(dt.col("o_totalprice")).alias("g")).sort("o_orderpriority").to_pydict())
    prio = orders_cols["o_orderpriority"]
    price = np.asarray(orders_cols["o_totalprice"], np.float64)
    names = sorted(set(pc.unique(prio).to_pylist()))
    codes = pc.index_in(prio, value_set=pa.array(names, prio.type)).to_numpy()
    ref = [float(np.exp(np.log(price[codes == i]).mean())) for i in range(len(names))]
    rel = max(abs(g["gmean"] - r) / r for g, r in zip(got["g"], ref))
    check(launches == 0 and got["o_orderpriority"] == names and rel <= UDAF_RTOL,
          f"the geometric mean per o_orderpriority: groups {got['o_orderpriority']}, max rel "
          f"err {rel} (tol {UDAF_RTOL})")
    check(min(g["merges"] for g in got["g"]) >= 1, "the UDAF took no partial merge")
    print(f"[udaf] geometric mean of o_totalprice per o_orderpriority over SF{SQL_CHECK_SF}'s "
          f"{len(price)} orders (class with merge, cloudpickled partial states): {wall:.3f} s = "
          f"{len(price) / wall:.0f} rows/s; merges per group "
          f"{[g['merges'] for g in got['g']]}; max rel err vs numpy {rel:.2e} (tol {UDAF_RTOL}) "
          f"[{card}]", flush=True)
    del orders, orders_cols
    gc.collect()
    print(f"[udf] phase 18 took {time.perf_counter() - phase_start:.1f} s [{card}]", flush=True)
    return by_path


def analyzed_text(df) -> str:
    """``df.explain(analyze=True)``'s analyzed part (from ``== Analyze ==``)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        df.explain(analyze=True)
    text = buf.getvalue()
    check("== Analyze ==" in text, "explain(analyze=True) printed no analyzed plan")
    return text[text.index("== Analyze =="):]


def analyzed_lines(text: str) -> tuple:
    """The analyzed plan as ({kind: {count: value}}, [(operator, rows)]): the
    summary lines' ``name=value`` counts by the line's kind (``rows``,
    ``device eval``, ``spill``, ...) and the operator table's rows."""
    kinds, table = {}, []
    lines = text.splitlines()[1:]
    for i, line in enumerate(lines):
        if line == "operators (by self time):":
            table = [(r.split()[0], int(r.split()[1])) for r in lines[i + 2:] if r.strip()]
            break
        kind, _, rest = line.partition(":")
        counts = {}
        for part in rest.split(","):
            key, eq, value = part.strip().partition("=")
            if eq:
                counts[key] = float(value.rstrip("s")) if value.rstrip("s").replace(
                    ".", "", 1).isdigit() else value
        if kind == "rows":
            counts["rows"] = int(rest.split(",")[0])
        kinds[kind] = counts
    return kinds, table


def overhead_loop(dt, orders, cust):
    """``bench.py``'s TPC-H-style loop (``_TPCH_CHILD``): filter -> join ->
    groupby -> sort."""
    c = dt.col
    return (orders.where(c("o_total") > 0.2)
            .join(cust, left_on="o_cust", right_on="c_key")
            .groupby("c_seg").agg(c("o_total").sum().alias("rev"))
            .sort("rev", desc=True)).to_pydict()


def overhead_tables(dt, n: int) -> tuple:
    """``bench.py``'s two tables at ``n`` orders, seeded as there (int64 and
    float64 columns from numpy: the metrics child's ``tolist`` gives the
    same types at a second's more set-up)."""
    import numpy as np

    rng = np.random.default_rng(0)
    cols = {"o_key": np.arange(n, dtype=np.int64), "o_cust": rng.integers(0, n // 8, n),
            "o_total": rng.random(n)}
    dims = {"c_key": np.arange(n // 8, dtype=np.int64), "c_seg": rng.integers(0, 5, n // 8)}
    return dt.from_pydict(cols), dt.from_pydict(dims)


def observability_state() -> dict:
    """What phase 19 takes from phases 14, 17 and 18, made anew for a run of
    phase 19 alone: SF10's lineitem with q01's answer, and SF1's orders."""
    import daft_tpu_torch as dt
    from daft_tpu_torch.tools import tpch

    t0 = time.perf_counter()
    big = tpch.tpch_tables(SQL_SF, seed=0, sql=True)
    lineitem = tpch.sql_frames(dt, {"lineitem": big.pop("lineitem")})["lineitem"]
    del big
    small = tpch.tpch_tables(SQL_CHECK_SF, seed=0, sql=True)["orders"]
    q01 = dt.sql(tpch_sql_text("q01"), lineitem=lineitem).to_pydict()
    print(f"[obs] phase 19's tables made alone in {time.perf_counter() - t0:.1f} s", flush=True)
    return {"obs": {"lineitem": lineitem, "q01": q01},
            "udaf_orders": (small, tpch.sql_frames(dt, {"orders": small})["orders"])}


def phase_observability(card: str, state: dict = None) -> dict:
    """Phase 19: the observability plane on the card. The main path profiled
    and not; EXPLAIN ANALYZE of TPC-H q01 over phase 14's SF10 lineitem; the
    orders' sort under a memory limit, analyzed; the metrics registry's and
    the profiler's overheads as the JAX package's ``bench.py`` measures them.
    Without ``state`` (run alone, as ``tools/smoke_split.py`` runs a phase) it
    makes its tables first (``observability_state``). Returns each path's
    flash launches."""
    import gc
    import os
    import statistics
    import tempfile
    import threading

    import numpy as np
    import pyarrow as pa
    import torch

    import daft_tpu_torch as dt
    from daft_tpu_torch.execution.memledger import get_ledger
    from daft_tpu_torch.execution.resource_manager import memory_limit
    from daft_tpu_torch.execution.spill import spill_metrics
    from daft_tpu_torch.functions.ai import embed_image
    from daft_tpu_torch.metrics import get_registry
    from daft_tpu_torch.ops.device_eval import device_eval_counters
    from daft_tpu_torch.ops.flash_attention import flash_attention
    from daft_tpu_torch.tools import lineitem, out_of_core, tpch
    from daft_tpu_torch.tools.plane_cost import counter_totals

    if state is None:
        state = observability_state()
    phase_start = time.perf_counter()
    by_path = {}

    # -- the main path, profiled and not ----------------------------------------
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (NUM_IMAGES, IMAGE * IMAGE * 3), dtype=np.uint8)
    images = dt.from_pydict({"img": dt.Series.from_numpy(
        imgs, "img", dt.DataType.image("RGB", IMAGE, IMAGE))})
    expr = embed_image(dt.col("img"), provider="cuda_random", model="ViT-L/14",
                       batch_size=BATCH)
    embs, walls = {}, {}
    with dt.execution_config_ctx(default_morsel_size=NUM_IMAGES):
        images.limit(BATCH).with_column("emb", expr).collect()  # the tower's weights
        for profiled in (True, False):
            q = images.with_column("emb", expr).select("emb")
            flash_attention.launch_count = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            q.collect(profile=profiled)
            walls[profiled] = time.perf_counter() - t0
            by_path["obs embed_image " + ("profiled" if profiled else "unprofiled")] = \
                {"flash_attention": flash_attention.launch_count}
            check(flash_attention.launch_count == VIT_L_LAYERS * NUM_IMAGES // BATCH,
                  f"the {'profiled' if profiled else 'unprofiled'} main path launched "
                  f"flash_attention {flash_attention.launch_count} times, expected "
                  f"{VIT_L_LAYERS * NUM_IMAGES // BATCH}")
            embs[profiled] = np.concatenate([np.asarray(part.to_pydict()["emb"],
                                                        dtype=np.float32)
                                             for part in q.iter_partitions()])
            if profiled:
                prof = q.query_profile
    check(embs[True].shape == (NUM_IMAGES, 768) and np.array_equal(embs[True], embs[False]),
          "the profiled main path's embeddings differ from the unprofiled run's")
    table = prof.operator_table(by="plan_node")
    udf_rows = [r["rows"] for r in table if r["operator"] == "UDFProject"]
    check(udf_rows == [NUM_IMAGES], f"the profile's UDFProject rows {udf_rows}, expected "
          f"[{NUM_IMAGES}]")
    trace_dir = tempfile.mkdtemp(prefix="obs-trace-")
    path = os.path.join(trace_dir, "trace.json")
    prof.write_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    nodes = [e["args"]["plan_node"] for e in trace["traceEvents"]
             if e["ph"] == "X" and "plan_node" in e["args"]]
    check(sorted(nodes) == sorted(r["plan_node"] for r in table) and len(set(nodes)) == len(nodes),
          f"the Chrome trace's operator spans {nodes} are not one per plan node of {table}")
    print(f"[obs] main path: {NUM_IMAGES} images profiled {walls[True]:.3f} s "
          f"({NUM_IMAGES / walls[True]:.1f} img/s), unprofiled {walls[False]:.3f} s "
          f"({NUM_IMAGES / walls[False]:.1f} img/s), profiled/unprofiled "
          f"{walls[True] / walls[False]:.4f}; the same bytes; "
          f"{by_path['obs embed_image profiled']['flash_attention']} flash launches each; "
          f"Chrome trace {os.path.getsize(path)} bytes, {len(trace['traceEvents'])} events, "
          f"one span per plan node {sorted(nodes)}; {time.perf_counter() - phase_start:.1f} s "
          f"into the phase [{card}]", flush=True)
    for r in table:
        print(f"[obs]   {r['plan_node']}: rows {r['rows']}, morsels {r['morsels']}, wall "
              f"{r['wall_ns'] / 1e6:.1f} ms, self {r['self_wall_ns'] / 1e6:.1f} ms, self cpu "
              f"{r['self_cpu_ns'] / 1e6:.1f} ms (host time: the kernels' launches and the "
              f"copies back)", flush=True)
    os.remove(path)
    os.rmdir(trace_dir)
    del embs, images, expr, prof, q

    # -- EXPLAIN ANALYZE of q01 over SF10's lineitem, at the default pool -------
    # The DataFrame form over q01's columns with the ship dates as int32 days,
    # the form the card takes (date32 is refused there in both packages,
    # A.20): its filter runs as a device chain, so the device lines carry
    # counts. The days are made before the query, not by it: a projection
    # below the filter would be pushed into its predicate, off the card.
    obs = state.pop("obs")
    table = obs["lineitem"].select(*Q01_COLUMNS).to_arrow()
    ship = table.column("l_shipdate").combine_chunks()
    days = np.frombuffer(ship.buffers()[1], np.int32, len(ship), ship.offset) - tpch.DAYS_TO_EPOCH
    table = table.set_column(table.schema.get_field_index("l_shipdate"), "l_shipdate",
                             pa.array(days, pa.int32()))
    q = lineitem.q01(dt, dt.from_arrow(table))
    del table, ship, days
    device_eval_counters.reset()
    flash_attention.launch_count = 0
    t0 = time.perf_counter()
    text = analyzed_text(q)
    wall = time.perf_counter() - t0
    by_path["obs q01 analyze"] = {"flash_attention": flash_attention.launch_count}
    check(flash_attention.launch_count == 0, "q01's analysis launched flash_attention")
    snap = device_eval_counters.snapshot()
    ops = q.metrics()
    kinds, rows_table = analyzed_lines(text)
    for line in text.splitlines():
        print(f"[obs] {line}", flush=True)
    rows = sum(len(p) for p in q._result)
    # f32 sums on the card's route against the SQL form's on the host.
    problems = rows_equal(lineitem.sorted_groups(q.to_pydict()), obs["q01"], Q06_RTOL)
    check(not problems, f"the analyzed q01 differs from phase 14's answer: {problems}")
    for kind in ("rows", "device eval", "memory"):
        check(kind in kinds, f"the analyzed q01 has no {kind!r} line: {text}")
    check(rows_table, "the analyzed q01 has no operator table")
    check(kinds["rows"]["rows"] == rows, f"analyzed rows {kinds['rows']['rows']} != {rows}")
    check(kinds["device eval"]["fused_rows"] == snap["fused_rows"],
          f"device eval fused_rows {kinds['device eval']['fused_rows']} != the counters' "
          f"{snap['fused_rows']}")
    chain_morsels = sum(snap["chain_morsels"].values())
    check(chain_morsels > 0 and snap["fused_rows"] > 0,
          f"q01's filter ran no device chain: {snap}")
    check(kinds.get("compiled chains", {}).get("morsels", 0) == chain_morsels,
          f"compiled chains {kinds.get('compiled chains')} != the counters' {chain_morsels} "
          f"morsels")
    by_op = {}
    for op, n in rows_table:
        by_op[op] = by_op.get(op, 0) + n
    # metrics() counts each operator's own stream, as the JAX package's does:
    # a fused chain's members (a Filter under a Project) have spans, no stream.
    check({op: by_op.get(op) for op in ops} == {op: c["rows_out"] for op, c in ops.items()}
          and set(by_op) - set(ops) <= {"Filter", "Project"},
          f"the operator table's rows {by_op} != metrics()'s rows_out {ops}")
    print(f"[obs] q01 (the DataFrame form, int32 days) over SF{SQL_SF}'s lineitem analyzed in "
          f"{wall:.3f} s at the default pool: {rows} rows equal to phase 14's; device eval and compiled chains equal to the "
          f"counters (fused_rows {snap['fused_rows']}, chain morsels {chain_morsels}); each "
          f"operator's rows equal metrics()'s rows_out {by_op}; "
          f"{time.perf_counter() - phase_start:.1f} s into the phase [{card}]", flush=True)
    del q, obs
    gc.collect()

    # -- the orders' sort under a memory limit, analyzed -------------------------
    orders_cols, orders = state.pop("udaf_orders")
    limit = out_of_core.limit_for({"orders": orders})
    keys, desc = ["o_custkey", "o_orderdate"], [False, True]
    spill_metrics.reset()
    with memory_limit(limit) as mm:
        # A second holder (as a concurrent query's sink would) keeps every
        # permit until the sort's reservation has waited OBS_HOLD_S.
        check(mm.acquire(limit, timeout=1.0), "could not take the limit's permits")
        asked, acquire = threading.Event(), mm.acquire

        def first_asks(*args, **kwargs):
            asked.set()
            return acquire(*args, **kwargs)

        def release():
            asked.wait(timeout=60)
            time.sleep(OBS_HOLD_S)
            mm.release(limit)

        mm.acquire = first_asks
        releaser = threading.Thread(target=release, name="obs-holder")
        releaser.start()
        q = orders.sort(keys, desc=desc)
        flash_attention.launch_count = 0
        t0 = time.perf_counter()
        try:
            text = analyzed_text(q)
        finally:
            asked.set()
            releaser.join(timeout=120)
            del mm.acquire
        wall = time.perf_counter() - t0
        available = mm.available_permits()
    by_path["obs sort analyze"] = {"flash_attention": flash_attention.launch_count}
    check(flash_attention.launch_count == 0, "the sort's analysis launched flash_attention")
    kinds, rows_table = analyzed_lines(text)
    for line in text.splitlines():
        print(f"[obs] {line}", flush=True)
    sp = spill_metrics.snapshot()
    mem = get_ledger().profile_for(q.query_id) or {}
    check(available == limit, f"{limit - available} permit bytes still out after the sort")
    check("spill" in kinds and kinds["spill"]["bytes"] > 0, f"the sort did not spill: {text}")
    check((kinds["spill"]["bytes"], kinds["spill"]["files"]) == (sp["bytes_spilled"],
                                                                 sp["files"]),
          f"the spill line {kinds['spill']} != spill_metrics {sp}")
    permits = kinds.get("memory permits", {})
    check(permits.get("waits", 0) >= 1 and permits.get("wait_s", 0) >= 0.9 * OBS_HOLD_S,
          f"the memory permits line {permits} shows no wait of {OBS_HOLD_S} s")
    check({k: kinds["memory"].get(k) for k in ("peak_held", "charged", "spilled")} ==
          {"peak_held": mem.get("peak_held_bytes"), "charged": mem.get("charged_bytes"),
           "spilled": mem.get("spilled_bytes")},
          f"the memory line {kinds['memory']} != the ledger's mem block {mem}")
    out = result_table(q)
    cust = out.column("o_custkey").to_numpy()
    date = out.column("o_orderdate").cast("int32").to_numpy()
    ordered = (cust[1:] > cust[:-1]) | ((cust[1:] == cust[:-1]) & (date[1:] <= date[:-1]))
    check(bool(ordered.all()) and np.array_equal(np.sort(out.column("o_orderkey").to_numpy()),
                                                 np.sort(orders_cols["o_orderkey"])),
          "the analyzed sort's rows are out of order or not the orders'")
    print(f"[obs] the sort of SF{SQL_CHECK_SF}'s {len(cust)} orders under 1/8 of their bytes "
          f"({limit} bytes) analyzed in {wall:.3f} s: spill {kinds['spill']} equal to "
          f"spill_metrics, memory permits {permits} (a holder kept the limit until the sort had "
          f"waited {OBS_HOLD_S} s), "
          f"memory {kinds['memory']} equal to the ledger; every permit back; "
          f"{time.perf_counter() - phase_start:.1f} s into the phase [{card}]", flush=True)
    del q, out, orders, orders_cols
    gc.collect()

    # -- the two planes' overheads, as the JAX package's bench.py measures them --
    # bench.py runs each registry setting in its own processes (it reads
    # DAFT_METRICS once); the port's switch is the registry's flag, so the
    # settings alternate rep by rep in one process and drift hits both.
    reg = get_registry()
    orders, cust = overhead_tables(dt, OVERHEAD_METRICS_ROWS)
    times = {True: [], False: []}

    def loop_counts() -> dict:
        """One rep's registry deltas (the morsels and increments that
        ``plane_report`` prices)."""
        before = counter_totals()
        overhead_loop(dt, orders, cust)
        after = counter_totals()
        return {k: after[k] - before[k] for k in after}

    loops = state.setdefault("obs_loops", {})
    with dt.execution_config_ctx():
        metrics_counts = loop_counts()  # warm
        try:
            for r in range(OVERHEAD_ROUNDS * OVERHEAD_METRICS_REPS):
                for enabled in ((False, True) if r % 2 == 0 else (True, False)):
                    reg.enabled = enabled
                    t0 = time.perf_counter()
                    overhead_loop(dt, orders, cust)
                    times[enabled].append(time.perf_counter() - t0)
        finally:
            reg.enabled = True
    on, off = min(times[True]), min(times[False])
    metrics_pct = (on - off) / off * 100.0
    # The paired estimator beside bench.py's best-of: each rep's on and off
    # ran back to back, so the median of their deltas rejects drift.
    paired = statistics.median(a - b for a, b in zip(times[True], times[False]))
    paired_pct = paired / statistics.median(times[False]) * 100.0
    loops["metrics"] = (metrics_counts, statistics.median(times[False]), metrics_pct, paired_pct)
    print(f"[obs] metrics registry overhead {metrics_pct:.3f} % (on {on:.4f} s, off {off:.4f} s: "
          f"best of {OVERHEAD_ROUNDS * OVERHEAD_METRICS_REPS} each, alternating ABBA in one "
          f"process, as bench.py's estimator); paired {paired_pct:.3f} % (the median of "
          f"{len(times[True])} paired deltas {paired:.4f} s over the median off "
          f"{statistics.median(times[False]):.4f} s); bench.py's loop at "
          f"n={OVERHEAD_METRICS_ROWS}; the JAX package's budget {OVERHEAD_BUDGET_PCT} %; "
          f"{time.perf_counter() - phase_start:.1f} s into the phase [{card}]", flush=True)
    del orders, cust

    orders, cust = overhead_tables(dt, OVERHEAD_PROFILE_ROWS)
    on_s, off_s = [], []
    for profiled in (True, False):  # warm both
        with dt.execution_config_ctx(profile_enabled=profiled):
            profile_counts = loop_counts()

    def pairs(blocks: int) -> None:
        for b in range(blocks):  # ABBA
            ts = {}
            for profiled in ((False, True) if b % 2 == 0 else (True, False)):
                with dt.execution_config_ctx(profile_enabled=profiled):
                    t0 = time.perf_counter()
                    overhead_loop(dt, orders, cust)
                    ts[profiled] = time.perf_counter() - t0
            on_s.append(ts[True])
            off_s.append(ts[False])

    def verdict() -> tuple:
        off = statistics.median(off_s)
        delta = statistics.median(o - f for o, f in zip(on_s, off_s))
        return delta / off * 100.0, off, delta

    pairs(OVERHEAD_PROFILE_BLOCKS)
    profile_pct, off, delta = verdict()
    escalated = profile_pct >= OVERHEAD_BUDGET_PCT
    if escalated:  # as bench.py: a failing verdict doubles the sample once
        pairs(OVERHEAD_PROFILE_BLOCKS)
        profile_pct, off, delta = verdict()
    loops["profile"] = (profile_counts, off, profile_pct, profile_pct)
    print(f"[obs] profiler overhead {profile_pct:.3f} % (median paired delta {delta:.4f} s over "
          f"median unprofiled {off:.4f} s, {len(on_s)} ABBA pairs in one process"
          f"{', escalated once' if escalated else ''}, bench.py's loop at "
          f"n={OVERHEAD_PROFILE_ROWS}; on {[round(t, 4) for t in on_s]}, off "
          f"{[round(t, 4) for t in off_s]}; the JAX package's budget {OVERHEAD_BUDGET_PCT} %) "
          f"[{card}]", flush=True)
    del orders, cust
    gc.collect()
    print(f"[obs] phase 19 took {time.perf_counter() - phase_start:.1f} s [{card}]", flush=True)
    return by_path


class AiServer:
    """A server on 127.0.0.1 (``ThreadingHTTPServer`` on a free port) that
    speaks the OpenAI wire format (``/v1/embeddings``, ``/v1/chat/completions``)
    and the Gemini one (``/v1beta/models/<m>:batchEmbedContents``,
    ``:generateContent``) and answers with the port's towers on the card,
    behind one lock. The first ``rate_limited`` POSTs get 429 with
    ``Retry-After: 0``. ``usage`` tallies what it reported as used, by
    route; ``posts`` counts every POST and ``refused`` the 429s."""

    def __init__(self, embedder, prompter, max_new_tokens: int, rate_limited: int):
        import collections
        import http.server
        import threading

        self.embedder, self.prompter = embedder, prompter
        self.max_new_tokens, self.rate_limited = max_new_tokens, rate_limited
        self.lock = threading.Lock()  # one forward at a time on the card
        self.tally_lock = threading.Lock()
        self.usage = collections.Counter()
        self.posts = self.refused = 0
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
                status, payload, extra = outer.answer(self.path, body)
                data = json.dumps(payload).encode()
                self.send_response(status)
                for k, v in extra.items():
                    self.send_header(k, v)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *args):
                pass

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.httpd.daemon_threads = True
        self.thread = threading.Thread(target=self.httpd.serve_forever, name="smoke-ai-server",
                                       daemon=True)

    @property
    def base(self) -> str:
        return f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=30)
        check(not self.thread.is_alive(), "the AI server's thread did not end")

    def _tally(self, **counts) -> None:
        with self.tally_lock:
            self.usage.update(counts)

    def _embed(self, texts: list):
        with self.lock:
            emb = self.embedder.embed_text(texts)
        _, lengths = self.embedder.tokenizer.encode_batch(texts)
        return emb, int(lengths.sum())

    def _generate(self, prompt: str):
        with self.lock:
            answer = self.prompter.prompt([prompt])[0]
        _, lengths = self.prompter.tokenizer.encode_batch([prompt])
        return answer, max(int(lengths[0]), 1), len(answer.split())

    def answer(self, path: str, body: dict) -> tuple:
        with self.tally_lock:
            self.posts += 1
            if self.posts <= self.rate_limited:
                self.refused += 1
                return 429, {"error": {"message": "rate limited"}}, {"Retry-After": "0"}
        if path == "/v1/embeddings":
            emb, tokens = self._embed(body["input"])
            self._tally(embed_posts=1, embed_tokens=tokens)
            return 200, {"object": "list", "model": body["model"],
                         "data": [{"index": i, "embedding": row.tolist()}
                                  for i, row in enumerate(emb)],
                         "usage": {"prompt_tokens": tokens, "total_tokens": tokens}}, {}
        if path == "/v1/chat/completions":
            if body.get("max_completion_tokens") != self.max_new_tokens:
                return 400, {"error": {"message": "max_completion_tokens must be "
                                                  f"{self.max_new_tokens}"}}, {}
            answer, pt, ct = self._generate(body["messages"][-1]["content"])
            self._tally(chat_posts=1, chat_in=pt, chat_out=ct)
            return 200, {"choices": [{"index": 0, "message": {"role": "assistant",
                                                              "content": answer}}],
                         "usage": {"prompt_tokens": pt, "completion_tokens": ct}}, {}
        if path.endswith(":batchEmbedContents"):
            emb, _ = self._embed([r["content"]["parts"][0]["text"] for r in body["requests"]])
            self._tally(gemini_embed_posts=1)
            return 200, {"embeddings": [{"values": row.tolist()} for row in emb]}, {}
        if path.endswith(":generateContent"):
            answer, pt, ct = self._generate(body["contents"][0]["parts"][0]["text"])
            self._tally(gemini_gen_posts=1, gemini_in=pt, gemini_out=ct)
            return 200, {"candidates": [{"content": {"parts": [{"text": answer}]}}],
                         "usageMetadata": {"promptTokenCount": pt,
                                           "candidatesTokenCount": ct}}, {}
        return 404, {"error": {"message": f"no route {path}"}}, {}


def minilm_flat(encoder) -> dict:
    """The flat flax state dict of a MiniLM tower (``params/`` keys, the
    inverse of ``flax_names``' layouts) as f32 arrays, and the keys whose
    parameter is bf16 on the card."""
    import numpy as np
    import torch

    params = dict(encoder.named_parameters())
    flat, bf16 = {}, set()
    for key, (tname, how) in encoder.flax_names().items():
        p = params[tname].detach()
        a = p.float().cpu().numpy()
        flat["params/" + key] = np.ascontiguousarray(a.T if how == "dense" else a)
        if p.dtype == torch.bfloat16:
            bf16.add("params/" + key)
    return flat, bf16


def write_flax_msgpack(path, flat: dict, bf16: set) -> None:
    """``flat`` in flax.serialization's layout (nested dicts whose leaves are
    msgpack extension 1: ``(shape, dtype name, C-order bytes)``), the keys in
    ``bf16`` stored as bfloat16 (the upper half of each f32, exact for values
    that are bf16 already), written with ``msgpack``."""
    import msgpack
    import numpy as np

    def leaf(key: str, a):
        if key in bf16:
            bits = (np.ascontiguousarray(a, np.float32).view(np.uint32) >> 16).astype(np.uint16)
            data = (list(a.shape), "bfloat16", bits.tobytes())
        else:
            data = (list(a.shape), a.dtype.name, np.ascontiguousarray(a).tobytes())
        return msgpack.ExtType(1, msgpack.packb(data, use_bin_type=True))

    tree: dict = {}
    for key, a in flat.items():
        node = tree
        *parents, last = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf(key, a)
    with open(path, "wb") as f:
        f.write(msgpack.packb(tree, use_bin_type=True))


def phase_ai_surface(card: str) -> dict:
    """Phase 20: the rest of the AI surface and pipeline-progress checkpoints
    at full width through the engine. (a) The API providers against a local
    server answering with the port's towers; (b) the transformers provider on
    the card; (c) MiniLM-L6 weights as a flax ``.msgpack`` beside an ``.npz``
    (the orbax reader's raise where ``tensorstore`` is missing); (d) ViT-L/14
    ``embed_image`` into checkpointed writes, resumed. Returns each path's
    flash launches."""
    import gc
    import importlib
    import pathlib
    import tempfile

    import numpy as np
    import torch

    import daft_tpu_torch as dt
    from daft_tpu_torch import metrics
    from daft_tpu_torch.ai.cuda_provider import DEFAULT_UDF_BATCH
    from daft_tpu_torch.ai.metrics import reset_token_metrics, token_metrics
    from daft_tpu_torch.ai.provider import load_provider
    from daft_tpu_torch.checkpoint import CheckpointConfig, CheckpointStore
    from daft_tpu_torch.functions.ai import embed_image, embed_text, prompt
    from daft_tpu_torch.models.checkpoint import load_flat
    from daft_tpu_torch.ops.flash_attention import flash_attention

    by_path = {}
    texts = make_texts(NUM_TEXTS, seed=2)  # phase 5's strings
    df = dt.from_pydict({"t": texts})
    reg = metrics.get_registry()
    registry_was = reg.enabled
    reg.enabled = True  # the token and retry tallies are registry counters

    def launches_of(run) -> tuple:
        flash_attention.launch_count = 0
        t0 = time.perf_counter()
        out = run()
        elapsed = time.perf_counter() - t0
        return out, {"flash_attention": flash_attention.launch_count}, elapsed

    def column(expr, frame=df, rows=NUM_TEXTS) -> list:
        with dt.execution_config_ctx(default_morsel_size=rows):
            return frame.with_column("out", expr).to_pydict()["out"]

    # -- (a) the API providers against a local server ------------------------------
    direct_expr = embed_text(dt.col("t"), provider="cuda", model=API_EMBED_MODEL)
    direct, launches, direct_s = launches_of(lambda: column(direct_expr))
    direct = np.asarray(direct, np.float32)
    embedder = direct_expr._expr.udf._get_instance()
    prompter = load_provider("cuda").get_prompter(
        "default-lm", max_new_tokens=API_PROMPT_TOKENS).instantiate()
    prompts = make_texts(API_PROMPTS, seed=21)[1:] + ["a photo of a cat"]
    t0 = time.perf_counter()
    answers = [prompter.prompt([p])[0] for p in prompts]  # one request at a time, directly
    direct_prompt_s = time.perf_counter() - t0
    print(f"[api] direct: embed_text {NUM_TEXTS} rows in {direct_s:.3f} s = "
          f"{NUM_TEXTS / direct_s:.1f} rows/s; {len(prompts)} prompts one at a time in "
          f"{direct_prompt_s:.2f} s; launches {launches} [{card}]", flush=True)
    reset_token_metrics()
    sleeps0 = reg.snapshot().hist("daft_io_retry_sleep_seconds")["count"]
    with AiServer(embedder, prompter, API_PROMPT_TOKENS, API_RATE_LIMITED) as server:
        name = "api vllm embed_text"
        expr = embed_text(dt.col("t"), provider="vllm", model=API_EMBED_MODEL,
                          base_url=server.base + "/v1", batch_size=DEFAULT_UDF_BATCH)
        got, launches, http_s = launches_of(lambda: column(expr))
        got = np.asarray(got, np.float32)
        retries = reg.snapshot().hist("daft_io_retry_sleep_seconds")["count"] - sleeps0
        print(f"[{name}] {NUM_TEXTS} rows through HTTP in {http_s:.3f} s = "
              f"{NUM_TEXTS / http_s:.1f} rows/s against {NUM_TEXTS / direct_s:.1f} direct "
              f"({http_s / direct_s:.2f}x the direct wall); {server.posts} POSTs, "
              f"{server.refused} answered 429, {int(retries)} retries; launches {launches} "
              f"[{card}]", flush=True)
        check(got.shape == direct.shape and got.tobytes() == direct.tobytes(),
              f"{name}: the HTTP embeddings differ from embed_text(provider='cuda'): max_abs_err "
              f"{np.abs(got - direct).max() if got.shape == direct.shape else got.shape}")
        check(server.refused == API_RATE_LIMITED and retries == API_RATE_LIMITED,
              f"{name}: {server.refused} 429s answered but {retries} retries counted")
        check(launches["flash_attention"] == 0, f"{name}: flash launched {launches}")
        by_path[name] = launches

        name = "api lm_studio prompt"
        pdf = dt.from_pydict({"q": prompts})
        expr = prompt(dt.col("q"), provider="lm_studio", model="default-lm",
                      base_url=server.base + "/v1", max_completion_tokens=API_PROMPT_TOKENS)
        got, launches, http_s = launches_of(lambda: column(expr, pdf, len(prompts)))
        print(f"[{name}] {len(prompts)} prompts through HTTP in {http_s:.2f} s against "
              f"{direct_prompt_s:.2f} s direct; launches {launches} [{card}]", flush=True)
        check(got == answers, f"{name}: the HTTP answers differ from the direct ones: "
              f"{[i for i, (a, b) in enumerate(zip(got, answers)) if a != b]}")
        check(all(a and len(a.split()) <= API_PROMPT_TOKENS for a in got),
              f"{name}: an answer is empty or longer than {API_PROMPT_TOKENS} tokens")
        check(launches["flash_attention"] == 0, f"{name}: flash launched {launches}")
        by_path[name] = launches

        name = "api google embed_text"
        gdf = df.limit(GOOGLE_TEXTS)
        expr = embed_text(dt.col("t"), provider="google", model=API_EMBED_MODEL, api_key="local",
                          base_url=server.base + "/v1beta")
        got, launches, http_s = launches_of(lambda: column(expr, gdf, GOOGLE_TEXTS))
        got = np.asarray(got, np.float32)
        err = float(np.abs(got - direct[:GOOGLE_TEXTS]).max())
        print(f"[{name}] {GOOGLE_TEXTS} rows through HTTP in {http_s:.3f} s; against the "
              f"direct route (other batch shapes): max_abs_err {err:.3e} (tol {CHUNK_TOL}); "
              f"launches {launches} [{card}]", flush=True)
        check(got.shape == (GOOGLE_TEXTS, direct.shape[1]) and err <= CHUNK_TOL,
              f"{name}: {got.shape}, max_abs_err {err}")
        check(launches["flash_attention"] == 0, f"{name}: flash launched {launches}")
        by_path[name] = launches

        name = "api google prompt"
        gp = dt.from_pydict({"q": prompts[:GOOGLE_PROMPTS]})
        expr = prompt(dt.col("q"), provider="google", model="default-lm", api_key="local",
                      base_url=server.base + "/v1beta")
        got, launches, http_s = launches_of(lambda: column(expr, gp, GOOGLE_PROMPTS))
        check(got == answers[:GOOGLE_PROMPTS], f"{name}: the answers differ from the direct ones")
        check(launches["flash_attention"] == 0, f"{name}: flash launched {launches}")
        by_path[name] = launches
        usage = dict(server.usage)
    tm = token_metrics()
    want = {f"vllm/{API_EMBED_MODEL}": {"input_tokens": usage["embed_tokens"], "output_tokens": 0,
                                       "requests": usage["embed_posts"]},
            "lm_studio/default-lm": {"input_tokens": usage["chat_in"],
                                     "output_tokens": usage["chat_out"],
                                     "requests": usage["chat_posts"]},
            f"google/{API_EMBED_MODEL}": {"input_tokens": 0, "output_tokens": 0,
                                         "requests": usage["gemini_embed_posts"]},
            "google/default-lm": {"input_tokens": usage["gemini_in"],
                                  "output_tokens": usage["gemini_out"],
                                  "requests": usage["gemini_gen_posts"]}}
    print(f"[api] the server reported {usage}; token_metrics() {dict(tm)}", flush=True)
    check(dict(tm) == want, f"token_metrics() {dict(tm)} differs from the server's usage {want}")
    del embedder, prompter, direct_expr
    gc.collect()
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        # -- (b) the transformers provider ----------------------------------------------
        name = "transformers embed_text"
        hf_dir = tmp / "all-MiniLM-L6-v2"
        write_hf_dir(hf_dir, HF_MINILM_CONFIG, seed=10)  # phase 8's MiniLM directory
        try:
            importlib.import_module("transformers")
            have = True
        except ImportError as e:
            have, missing = False, e
        if not have:
            print(f"[{name}] transformers does not import on this host ({missing}); "
                  f"instantiate() must raise the same ImportError", flush=True)
            desc = load_provider("transformers").get_text_embedder(str(hf_dir))
            try:
                desc.instantiate()
                raise SmokeFailure(f"{name}: instantiate() did not raise without transformers")
            except ImportError as e:
                check(type(e) is type(missing) and str(e) == str(missing),
                      f"{name}: raised {e!r}, expected {missing!r}")
            by_path[name] = {"flash_attention": 0}
        else:
            import transformers

            expr = embed_text(dt.col("t"), provider="transformers", model=str(hf_dir),
                              dimensions=HF_MINILM_CONFIG["hidden_size"],
                              batch_size=DEFAULT_UDF_BATCH)
            t0 = time.perf_counter()
            column(expr, df.limit(DEFAULT_UDF_BATCH), DEFAULT_UDF_BATCH)  # load, first forward
            setup_s = time.perf_counter() - t0
            got, launches, tf_s = launches_of(lambda: column(expr))
            got = np.asarray(got, np.float32)
            inst = expr._expr.udf._get_instance()
            cuda_expr = embed_text(dt.col("t"), weights_path=str(hf_dir))
            ours, _, ours_s = launches_of(lambda: column(cuda_expr, df.limit(HF_COMPARE_ROWS),
                                                         HF_COMPARE_ROWS))
            ours = np.asarray(ours, np.float32)
            full = np.array([bool(t) for t in texts[:HF_COMPARE_ROWS]])
            cos = cosines(got[:HF_COMPARE_ROWS][full], ours[full])
            sample = [i for i in range(NUM_TEXTS) if texts[i]][:TRANSFORMERS_CPU_ROWS]
            t0 = time.perf_counter()
            from daft_tpu_torch.ai.torch_provider import TorchTextEmbedder

            cpu = TorchTextEmbedder(str(hf_dir), device="cpu").embed_text(
                [texts[i] for i in sample])
            cpu_s = time.perf_counter() - t0
            cpu_cos = cosines(cpu, got[sample])
            print(f"[{name}] transformers {transformers.__version__} on {inst.device}: set-up "
                  f"{setup_s:.1f} s, then {NUM_TEXTS} rows in {tf_s:.3f} s = "
                  f"{NUM_TEXTS / tf_s:.1f} rows/s (the cuda "
                  f"provider over the same directory, its load included: "
                  f"{HF_COMPARE_ROWS / ours_s:.1f} rows/s on {HF_COMPARE_ROWS}); cosine "
                  f"against the cuda provider {cos.min():.6f} (min {CPU_COSINE_MIN}) over "
                  f"{int(full.sum())} non-empty rows; against itself on the CPU "
                  f"{cpu_cos.min():.7f} (min {TRANSFORMERS_CPU_COSINE_MIN}, {len(sample)} rows, "
                  f"{cpu_s:.1f} s); launches {launches} [{card}]", flush=True)
            check(inst.device.type == "cuda" and next(inst.model.parameters()).is_cuda,
                  f"{name}: the model is not on the card")
            check(got.shape == (NUM_TEXTS, HF_MINILM_CONFIG["hidden_size"])
                  and bool(np.isfinite(got).all())
                  and bool(np.abs(np.linalg.norm(got, axis=1) - 1).max() < 1e-3),
                  f"{name}: embeddings {got.shape}, not finite or not unit-norm")
            check(bool(cos.min() >= CPU_COSINE_MIN), f"{name}: against the cuda provider {cos.min()}")
            check(bool(cpu_cos.min() >= TRANSFORMERS_CPU_COSINE_MIN),
                  f"{name}: against the CPU {cpu_cos.min()}")
            by_path[name] = launches
            del inst, expr, cuda_expr
            gc.collect()
            torch.cuda.empty_cache()

        # -- (c) weight files ----------------------------------------------------------------
        name = "msgpack embed_text"
        inst = load_provider("cuda").get_text_embedder(API_EMBED_MODEL).instantiate()
        flat, bf16 = minilm_flat(inst.encoder)
        del inst
        npz, mp = tmp / "minilm.npz", tmp / "minilm.msgpack"
        t0 = time.perf_counter()
        np.savez(npz, **flat)
        try:
            importlib.import_module("msgpack")
            have_msgpack = True
        except ImportError as e:
            have_msgpack, missing = False, e
        if have_msgpack:
            write_flax_msgpack(mp, flat, bf16)
        print(f"[{name}] wrote {len(flat)} arrays: .npz {npz.stat().st_size / 1e6:.1f} MB"
              + (f", .msgpack {mp.stat().st_size / 1e6:.1f} MB ({len(bf16)} bf16 leaves)"
                 if have_msgpack else "") + f" in {time.perf_counter() - t0:.1f} s", flush=True)
        from_npz, _, npz_s = launches_of(lambda: column(embed_text(
            dt.col("t"), provider="cuda", model=API_EMBED_MODEL, weights_path=str(npz))))
        from_npz = np.asarray(from_npz, np.float32)
        check(from_npz.tobytes() == direct.tobytes(),
              f"{name}: the .npz of the tower's own weights gives other bytes than the tower")
        if have_msgpack:
            read = load_flat(str(mp))
            check(read.keys() == flat.keys() and all(np.array_equal(read[k], flat[k])
                                                    for k in flat),
                  f"{name}: load_flat of the .msgpack differs from the arrays written")
            got, launches, mp_s = launches_of(lambda: column(embed_text(
                dt.col("t"), provider="cuda", model=API_EMBED_MODEL, weights_path=str(mp))))
            got = np.asarray(got, np.float32)
            print(f"[{name}] {NUM_TEXTS} rows from the .msgpack in {mp_s:.3f} s, from the .npz "
                  f"in {npz_s:.3f} s (each with the load); the same bytes: "
                  f"{got.tobytes() == from_npz.tobytes()}; launches {launches} [{card}]",
                  flush=True)
            check(got.tobytes() == from_npz.tobytes(),
                  f"{name}: the .msgpack and .npz routes differ by {np.abs(got - from_npz).max()}")
            check(launches["flash_attention"] == 0, f"{name}: flash launched {launches}")
            by_path[name] = launches
        else:
            print(f"[{name}] msgpack does not import on this host ({missing})", flush=True)
            (tmp / "w.msgpack").write_bytes(b"\x80")
            try:
                load_flat(str(tmp / "w.msgpack"))
                raise SmokeFailure(f"{name}: load_flat read a .msgpack without msgpack")
            except ImportError as e:
                check("msgpack" in str(e), f"{name}: raised {e!r}")
            by_path[name] = {"flash_attention": 0}
        orbax = tmp / "minilm_orbax"
        orbax.mkdir()
        try:
            importlib.import_module("tensorstore")
            have_ts = True
        except ImportError as e:
            have_ts, missing = False, e
        if have_ts:
            print("[orbax] tensorstore imports on this host; orbax directories are held by "
                  "the CPU tests (no orbax here to write one)", flush=True)
        else:
            (orbax / "_METADATA").write_text(json.dumps({"tree_metadata": {}}))
            try:
                load_flat(str(orbax))
                raise SmokeFailure("orbax: load_flat read a directory without tensorstore")
            except ImportError as e:
                check("tensorstore" in str(e), f"orbax: raised {e!r}")
            print(f"[orbax] tensorstore does not import on this host ({missing}): load_flat "
                  f"raises ImportError naming it", flush=True)
        del flat, from_npz
        gc.collect()
        torch.cuda.empty_cache()

        # -- (d) resume ------------------------------------------------------------------
        rng = np.random.default_rng(0)  # phase 3's images, then CKPT_NEW more
        imgs = rng.integers(0, 256, (NUM_IMAGES + CKPT_NEW, IMAGE * IMAGE * 3), dtype=np.uint8)
        image_type = dt.DataType.image("RGB", IMAGE, IMAGE)

        def frame(n: int):
            return dt.from_pydict({"id": list(range(n)), "img": dt.Series.from_numpy(
                imgs[:n], "img", image_type)})

        cfg = CheckpointConfig(CheckpointStore(str(tmp / "ckpt")), on="id")
        out_dir = str(tmp / "embeddings")
        expr = embed_image(dt.col("img"), provider="cuda_random", model="ViT-L/14",
                           batch_size=BATCH)

        def write(n: int, e):
            with dt.execution_config_ctx(default_morsel_size=NUM_IMAGES):
                frame(n).with_checkpoint(cfg).with_column("emb", e).select("id", "emb") \
                    .write_parquet(out_dir, checkpoint=cfg)

        def written() -> dict:
            d = dt.read_parquet(out_dir).to_pydict()
            order = np.argsort(d["id"], kind="stable")
            return {"id": [d["id"][i] for i in order],
                    "emb": np.asarray([d["emb"][i] for i in order], np.float32)}

        steps = {}
        for step, n, e in (("first", NUM_IMAGES, expr), ("resume", NUM_IMAGES, None),
                           ("new", NUM_IMAGES + CKPT_NEW, expr)):
            e = e if e is not None else embed_image(dt.col("img"), provider="cuda_random",
                                                    model="ViT-L/14", batch_size=BATCH)
            _, launches, s = launches_of(lambda: write(n, e))
            steps[step] = (launches, s, e, written())
            by_path[f"ckpt embed_image {step}"] = launches
        first, resume, new = (steps[k][3] for k in ("first", "resume", "new"))
        counts = [steps[k][0]["flash_attention"] for k in ("first", "resume", "new")]
        print(f"[ckpt] embed_image into write_parquet(checkpoint=): first {NUM_IMAGES} rows "
              f"{steps['first'][1]:.2f} s, resume {steps['resume'][1]:.2f} s, {CKPT_NEW} new "
              f"{steps['new'][1]:.2f} s; flash launches {counts} (expected "
              f"{[VIT_L_LAYERS * NUM_IMAGES // BATCH, 0, VIT_L_LAYERS * CKPT_NEW // BATCH]}); "
              f"keys sealed {len(cfg.store.load_keys())} [{card}]", flush=True)
        check(counts == [VIT_L_LAYERS * NUM_IMAGES // BATCH, 0, VIT_L_LAYERS * CKPT_NEW // BATCH],
              f"ckpt: flash launches {counts}")
        check(not steps["resume"][2]._expr.udf._instances,
              "ckpt: rows reached the UDF on the resumed run")
        check(first["id"] == list(range(NUM_IMAGES)) and resume["id"] == first["id"]
              and resume["emb"].tobytes() == first["emb"].tobytes(),
              "ckpt: the resumed run changed the files")
        check(new["id"] == list(range(NUM_IMAGES + CKPT_NEW)),
              "ckpt: the files do not hold each key once")
        check(new["emb"][:NUM_IMAGES].tobytes() == first["emb"].tobytes(),
              "ckpt: the first run's embeddings changed")
        check(cfg.store.load_keys() == set(range(NUM_IMAGES + CKPT_NEW)), "ckpt: sealed keys")
        inst = expr._expr.udf._get_instance()
        direct_new = embed_direct(inst, imgs[NUM_IMAGES:])
        err = float(np.abs(direct_new - new["emb"][NUM_IMAGES:]).max())
        check(err <= CHUNK_TOL, f"ckpt: the new rows differ from a direct forward by {err}")
        print(f"[ckpt] the new rows against a direct forward: max_abs_err {err:.3e} "
              f"(tol {CHUNK_TOL}); each key once in the files", flush=True)
        del inst, expr, steps
        gc.collect()
        torch.cuda.empty_cache()
    reg.enabled = registry_was
    return by_path


def phase_multi_device(card: str) -> dict:
    """Phase 21: (a) the engine-overhead watchdog at ViT-L/14; (b) replica
    slots; (c) dp2 and tp2 meshes over two entries naming the one card;
    (d) ring attention over one NCCL rank and two gloo ranks; (e) C.45.
    Returns each path's flash launches."""
    import datetime
    import pathlib
    import statistics
    import tempfile
    import threading

    import numpy as np
    import torch
    import torch.distributed as dist

    import daft_tpu_torch as dt
    from daft_tpu_torch.ai.cuda_provider import CUDACLIPImageEmbedder
    from daft_tpu_torch.errors import DaftValueError
    from daft_tpu_torch.functions.ai import embed_image
    from daft_tpu_torch.models.layers import ShardedLinear
    from daft_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
    from daft_tpu_torch.ops.ring_attention import ring_attention, sequence_parallel_attention
    from daft_tpu_torch.parallel import replica
    from daft_tpu_torch.parallel.mesh import shard_bytes
    from daft_tpu_torch.perf_report import gap_breakdown
    from daft_tpu_torch.tools import ring_world

    paths = {}
    chunk_launches = VIT_L_LAYERS

    def counted(run):
        flash_attention.launch_count = 0
        out = run()
        torch.cuda.synchronize()
        return out, flash_attention.launch_count

    def emb_of(df):
        vals, _ = image_column(df, "emb").to_numpy_masked()
        return np.asarray(vals, dtype=np.float32)

    def vit(**options):
        return embed_image(dt.col("img"), provider="cuda_random", model="ViT-L/14",
                           batch_size=BATCH, **options)

    # (a) The watchdog: the same forward standalone and through the engine.
    imgs = np.random.default_rng(0).integers(0, 256, (WATCHDOG_IMAGES, IMAGE * IMAGE * 3),
                                             dtype=np.uint8)
    pixels = imgs.reshape(-1, IMAGE, IMAGE, 3)
    df = dt.from_pydict({"img": dt.Series.from_numpy(imgs, "img",
                                                     dt.DataType.image("RGB", IMAGE, IMAGE))})
    expr = vit()
    standalone = CUDACLIPImageEmbedder("ViT-L/14", batch_size=BATCH)

    def standalone_once():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = standalone.embed_image(pixels)  # fetched to the host: the work is done
        return time.perf_counter() - t0, out

    def engine_once(profile=None):
        with dt.execution_config_ctx(default_morsel_size=WATCHDOG_IMAGES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            q = df.with_column("emb", expr).select("emb")
            q.collect(profile=profile)
            return time.perf_counter() - t0, q

    (_, st_out), paths["watchdog standalone"] = counted(standalone_once)
    (_, en_q), paths["watchdog engine"] = counted(engine_once)
    chunks = WATCHDOG_IMAGES // BATCH
    for side in ("standalone", "engine"):
        n = paths[f"watchdog {side}"]
        check(n == chunk_launches * chunks,
              f"watchdog {side}: {n} flash launches, expected {chunk_launches} x {chunks}")
    paths = {k: {"flash_attention": v} for k, v in paths.items()}
    en_out = emb_of(en_q)
    err = float(np.abs(en_out - st_out).max())
    print(f"[multi] watchdog: engine rows against standalone rows max_abs_err {err:.3e} "
          f"(tol {CHUNK_TOL}), {chunk_launches * chunks} launches each", flush=True)
    check(en_out.shape == st_out.shape and err <= CHUNK_TOL,
          f"watchdog: the engine's rows differ from the standalone forward's by {err}")

    def blocks(n):
        ratios, st_walls, en_walls = [], [], []
        for b in range(n):
            if b % 2 == 0:
                st, en = standalone_once()[0], engine_once()[0]
            else:
                en, st = engine_once()[0], standalone_once()[0]
            st_walls.append(st)
            en_walls.append(en)
            ratios.append(en / st)
        return ratios, statistics.median(st_walls), statistics.median(en_walls)

    ratios, st, en = blocks(WATCHDOG_BLOCKS)
    verdict = statistics.median(ratios)
    if verdict >= OVERHEAD_LIMIT:
        print(f"[multi] watchdog: x{verdict:.3f} over {WATCHDOG_BLOCKS} blocks "
              f"({[round(r, 4) for r in ratios]}); escalating to {WATCHDOG_ESCALATED}", flush=True)
        ratios, st, en = blocks(WATCHDOG_ESCALATED)
        verdict = statistics.median(ratios)
    profiled_s, profiled_q = engine_once(profile=True)
    breakdown = gap_breakdown(profiled_q.query_profile, st, en)
    print(f"[multi] watchdog ViT-L/14, {WATCHDOG_IMAGES} images in {chunks} chunks of {BATCH}: "
          f"standalone {WATCHDOG_IMAGES / st:.1f} img/s ({st:.4f} s), engine "
          f"{WATCHDOG_IMAGES / en:.1f} img/s ({en:.4f} s), medians of {len(ratios)} ABBA blocks; "
          f"per-block ratios {[round(r, 4) for r in ratios]}; verdict x{verdict:.4f} (limit "
          f"x{OVERHEAD_LIMIT}): {'pass' if verdict < OVERHEAD_LIMIT else 'FAIL'} [{card}]",
          flush=True)
    print(f"[multi] watchdog gap_breakdown (a profiled engine pass, {profiled_s:.4f} s):\n"
          f"{breakdown}", flush=True)
    check(verdict < OVERHEAD_LIMIT,
          f"watchdog: the engine costs x{verdict:.3f} over the standalone forward (limit "
          f"x{OVERHEAD_LIMIT}); attribution:\n{breakdown}")
    del standalone, profiled_q, en_q

    # (d), started here: two gloo ranks on the card, beside (b) and (c).
    g = np.random.default_rng(21)
    qkv = tuple(g.standard_normal((RING_B, RING_T, RING_D)).astype(np.float32) for _ in range(3))
    ring_tmp = tempfile.TemporaryDirectory()
    gloo = {}

    def gloo_world():
        t0 = time.perf_counter()
        try:
            gloo["ranks"] = ring_world.launch({"ring": qkv}, RING_RANKS, ring_tmp.name,
                                              backend="gloo", device="cuda",
                                              timeout=RING_TIMEOUT_S)["ring"]
        except Exception as e:  # noqa: BLE001 — reported by the phase's check below
            gloo["error"] = e
        gloo["wall"] = time.perf_counter() - t0

    gloo_thread = threading.Thread(target=gloo_world, name="smoke-gloo-ring")
    gloo_thread.start()
    try:
        # (b) Replica slots over phase 3's 512 images.
        imgs512 = np.random.default_rng(0).integers(0, 256, (NUM_IMAGES, IMAGE * IMAGE * 3),
                                                    dtype=np.uint8)
        df512 = dt.from_pydict({"img": dt.Series.from_numpy(
            imgs512, "img", dt.DataType.image("RGB", IMAGE, IMAGE))})

        def route(e, morsel):
            def run():
                with dt.execution_config_ctx(default_morsel_size=morsel):
                    t0 = time.perf_counter()
                    out = emb_of(df512.with_column("emb", e).select("emb"))
                    return out, time.perf_counter() - t0
            return counted(run)

        want = NUM_IMAGES // BATCH * chunk_launches
        (ref, _), n_ref = route(expr, NUM_IMAGES)  # phase 3's route, its instance warm
        check(n_ref == want, f"phase 3's route: {n_ref} launches, expected {want}")
        e1 = vit(chips_per_replica=1)
        (one, one_s), n1 = route(e1, NUM_IMAGES)
        inst1 = e1._expr.udf._instances
        print(f"[multi] replica: chips_per_replica=1 over visible_devices() "
              f"{[str(d) for d in replica.visible_devices()]}: {len(inst1)} instance(s) on "
              f"{[str(i.device) for i in inst1.values()]}, {NUM_IMAGES} images {one_s:.3f} s "
              f"(its load in it), {n1} launches, the same bytes as phase 3's route: "
              f"{one.tobytes() == ref.tobytes()} [{card}]", flush=True)
        check(list(inst1) == [0] and n1 == want and one.tobytes() == ref.tobytes(),
              f"replica 1 slot: instances {list(inst1)}, launches {n1}, or its bytes differ")
        paths["replica 1 slot"] = {"flash_attention": n1}

        two = [torch.device("cuda", 0), torch.device("cuda", 0)]
        real_visible = replica.visible_devices
        replica.visible_devices = lambda: list(two)
        try:
            e2 = vit(chips_per_replica=1)
            (both, both_s), n2 = route(e2, SLOT_MORSEL)
            inst2 = e2._expr.udf._instances
            print(f"[multi] replica: two slots over [cuda:0, cuda:0] (two entries naming one "
                  f"card): instances for slots {sorted(inst2)}, {NUM_IMAGES} images in morsels of "
                  f"{SLOT_MORSEL} {both_s:.3f} s (both loads in it), {n2} launches, the same "
                  f"bytes as phase 3's route: {both.tobytes() == ref.tobytes()} [{card}]",
                  flush=True)
            check(sorted(inst2) == [0, 1] and n2 == want and both.tobytes() == ref.tobytes(),
                  f"replica 2 slots: instances {sorted(inst2)}, launches {n2}, or bytes differ")
            paths["replica 2 slots"] = {"flash_attention": n2}
            del e1, e2, inst1, inst2

            # (c) The mesh over the same two entries.
            for axes in ({"dp": 2}, {"tp": 2}):
                name = "mesh " + "".join(f"{k}{v}" for k, v in axes.items())
                e = vit(chips_per_replica=2, mesh_axes=axes)
                (out, out_s), n = route(e, NUM_IMAGES)
                inst = e._expr.udf._instances[0]
                cos = cosines(out, ref)
                rows = BATCH // axes.get("dp", 1)
                per_chunk = chunk_launches * axes.get("dp", 1)
                held = [shard_bytes(t, axes.get("tp", 1)) for t in inst.replicas]
                print(f"[multi] {name} over [cuda:0, cuda:0]: {inst.mesh}, {len(inst.replicas)} "
                      f"tower(s); forwards of {rows} rows (phase 3's of {BATCH}; bit equality "
                      f"{'asked' if rows == BATCH and 'tp' not in axes else 'not asked'}); "
                      f"max_abs_err "
                      f"{np.abs(out - ref).max():.3e}, cosine min {cos.min():.7f} (min "
                      f"{MESH_COSINE_MIN}) against (b); {n} launches ({per_chunk} a chunk); "
                      f"weight bytes held per shard, by dp row: {held}; {NUM_IMAGES} images "
                      f"{out_s:.3f} s (its load in it) [{card}]", flush=True)
                check(inst.mesh.shape == axes, f"{name}: mesh {inst.mesh.shape}")
                check(n == NUM_IMAGES // BATCH * per_chunk, f"{name}: {n} launches")
                check(bool(np.isfinite(out).all()) and cos.min() >= MESH_COSINE_MIN,
                      f"{name}: cosine {cos.min()} against the unsharded tower")
                if rows == BATCH and "tp" not in axes:  # a tp split sums in another order
                    check(out.tobytes() == ref.tobytes(), f"{name}: not the same bytes")
                if "tp" in axes:
                    split = [m for blk in inst.encoder.blocks
                             for m in (blk.attn.qkv, blk.attn.out, blk.mlp.fc1, blk.mlp.fc2)]
                    split.append(inst.encoder.proj)
                    check(all(isinstance(m, ShardedLinear) and len(m.weights) == axes["tp"]
                              for m in split), f"{name}: a Dense layer is not split in two")
                paths[name] = {"flash_attention": n}
                del e, inst
        finally:
            replica.visible_devices = real_visible

        # (e) C.45: the kernel refuses a call that autograd would differentiate.
        gen = torch.Generator(device="cuda").manual_seed(45)
        gq, gk, gv = (torch.randn((2, 64, 4, 64), generator=gen, device="cuda")
                      .to(torch.bfloat16).requires_grad_() for _ in range(3))
        try:
            flash_attention(gq, gk, gv)
            refused = ""
        except DaftValueError as e:
            refused = str(e)
        before = flash_attention.launch_count
        with torch.no_grad():
            out = flash_attention(gq, gk, gv)
        torch.cuda.synchronize()
        launched = flash_attention.launch_count - before
        print(f"[multi] C.45: flash_attention on CUDA tensors that require grad raised: "
              f"{bool(refused)} ({refused[:80]}...); under torch.no_grad() it launched {launched} "
              f"time(s), grad_fn {out.grad_fn} [{card}]", flush=True)
        check("A.10.2" in refused, "C.45: the kernel ran under autograd")
        check(launched == 1 and out.grad_fn is None and bool(torch.isfinite(out.float()).all()),
              "C.45: the kernel did not launch under torch.no_grad()")

        # (d) The references over the whole sequence, then one NCCL rank.
        q, k, v = (torch.from_numpy(a).cuda() for a in qkv)
        q4, k4, v4 = (t.view(RING_B, RING_T, 1, RING_D) for t in (q, k, v))

        def kernel_ref():
            t0 = time.perf_counter()
            o = flash_attention(q4, k4, v4)
            torch.cuda.synchronize()
            return o.view(RING_B, RING_T, RING_D), time.perf_counter() - t0

        (kref, kref_s), n_kref = counted(kernel_ref)
        paths["ring reference"] = {"flash_attention": n_kref}
        t0 = time.perf_counter()
        pref = flash_attention_plain(q4, k4, v4, RING_PLAIN_BLOCK, RING_PLAIN_BLOCK).view(
            RING_B, RING_T, RING_D)
        torch.cuda.synchronize()
        pref_s = time.perf_counter() - t0
        kp = (kref - pref).abs().max().item()
        print(f"[multi] ring reference: the f32 kernel over (B, T, 1, D) = ({RING_B}, {RING_T}, "
              f"1, {RING_D}) {kref_s:.4f} s, {n_kref} launch; the plain version (blocks of "
              f"{RING_PLAIN_BLOCK}) {pref_s:.4f} s; kernel vs plain max_abs_err {kp:.3e} [{card}]",
              flush=True)
        check(n_kref == 1 and kp <= RING_TOL, f"ring reference: {n_kref} launches, err {kp}")

        def nccl_ring():
            with tempfile.TemporaryDirectory() as tmp:
                store = dist.FileStore(str(pathlib.Path(tmp) / "store"), 1)
                dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                                        timeout=datetime.timedelta(seconds=RING_TIMEOUT_S))
                try:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    whole = sequence_parallel_attention(q, k, v)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                    local = ring_attention(q, k, v)
                    torch.cuda.synchronize()
                finally:
                    dist.destroy_process_group()
            return whole, local, wall

        (whole, local, nccl_s), n_nccl = counted(nccl_ring)
        paths["ring nccl1"] = {"flash_attention": n_nccl}
        errs = [(whole - kref).abs().max().item(), (whole - pref).abs().max().item()]
        print(f"[multi] ring nccl, 1 rank on cuda:0: {nccl_s:.4f} s; against the kernel "
              f"{errs[0]:.3e}, against the plain version {errs[1]:.3e} (tol {RING_TOL}); "
              f"ring_attention equal to it: {torch.equal(whole, local)}; {n_nccl} flash launches "
              f"[{card}]", flush=True)
        check(max(errs) <= RING_TOL and n_nccl == 0 and torch.equal(whole, local),
              f"ring nccl1: errors {errs}, {n_nccl} flash launches")
    finally:
        gloo_thread.join()
        ring_tmp.cleanup()
    check("error" not in gloo, f"ring gloo2: {gloo.get('error')}")
    kref_np, pref_np = kref.cpu().numpy(), pref.cpu().numpy()
    n_gloo = 0
    for r, res in enumerate(gloo["ranks"]):
        errs = [float(np.abs(res["whole"] - kref_np).max()),
                float(np.abs(res["whole"] - pref_np).max())]
        t = RING_T // RING_RANKS
        lerr = float(np.abs(res["local"] - kref_np[:, r * t:(r + 1) * t]).max())
        n_gloo += int(res["launches"])
        print(f"[multi] ring gloo rank {r} of {RING_RANKS} on cuda:0 (spawned, FileStore, blocks "
              f"through pinned host buffers; beside (b)-(c)): sequence_parallel_attention "
              f"{res['seconds'][0]:.4f} s, ring_attention {res['seconds'][1]:.4f} s; against the "
              f"kernel {errs[0]:.3e}, the plain version {errs[1]:.3e}, its own rows {lerr:.3e} "
              f"(tol {RING_TOL}); {int(res['launches'])} flash launches [{card}]", flush=True)
        check(max(errs + [lerr]) <= RING_TOL, f"ring gloo rank {r}: errors {errs}, {lerr}")
    print(f"[multi] ring gloo world of {RING_RANKS}: {gloo['wall']:.1f} s from spawn to results "
          f"[{card}]", flush=True)
    check(n_gloo == 0, f"ring gloo2: {n_gloo} flash launches")
    paths["ring gloo2"] = {"flash_attention": n_gloo}
    return paths


def embed_direct(inst, imgs):
    """``inst``'s image tower over ``imgs`` (flat uint8 rows) in one chunk."""
    import torch

    from daft_tpu_torch.models.clip import embed

    px = torch.from_numpy(imgs.reshape(-1, IMAGE, IMAGE, 3)).cuda()
    return embed(inst.encoder, px).cpu().numpy()


def tpch_sql_text(name: str) -> str:
    from daft_tpu_torch.tools import tpch_sql

    return tpch_sql.sql_text(name, SQL_SF)


def wait_for_audit(limit: int, seconds: float = 10.0) -> dict:
    """The audit once the side threads of a cut query have released (the
    end state is exact, its instant is not)."""
    from daft_tpu_torch.execution.resource_manager import get_memory_manager
    from daft_tpu_torch.tools import out_of_core

    mm = get_memory_manager()
    deadline = time.monotonic() + seconds
    while True:
        a = out_of_core.audit(None, None)
        a["permits_out"] = mm.used()
        if a == {"held": 0, "permits_out": 0, "spill_dirs": []} or time.monotonic() > deadline:
            return a
        time.sleep(0.05)


def result_table(df):
    """``df``'s result as one Arrow table."""
    from daft_tpu_torch.micropartition import MicroPartition

    parts = list(df.iter_partitions())
    return MicroPartition.concat(parts).to_arrow_table()


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


def plane_report(card: str, phase_counts: dict, loops: dict) -> None:
    """What the observability plane cost each phase, from its per-morsel and
    per-query costs on this host (``tools/plane_cost.py``) times the
    morsels, device-layer increments and queries the phase counted (the
    registry-off reps of phase 19 count no morsels); then the registry's and
    the profiler's own cost in phase 19's two overhead loops, from one rep's
    counts, beside the overheads measured there."""
    from daft_tpu_torch.tools import plane_cost

    t0 = time.perf_counter()
    cost = plane_cost.measure(PLANE_COST_MORSELS, PLANE_COST_REPS)
    print(f"[plane] the plane's costs on this host (median of {PLANE_COST_REPS} reps, "
          f"{PLANE_COST_MORSELS} morsels through {cost['depth']} operators): one operator-morsel "
          f"{cost['per_morsel_ns']:.1f} ns (instrumented {cost['instrumented_ns']:.1f} ns, "
          f"with the registry off {cost['instrumented_off_ns']:.1f} ns, bare "
          f"{cost['bare_ns']:.1f} ns); one counter increment {cost['counter_inc_ns']:.1f} ns "
          f"(off {cost['counter_inc_off_ns']:.1f} ns); one query's events and stats "
          f"({cost['ops_per_query']} operators) {cost['per_query_ns']:.1f} ns; measured in "
          f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    spent = wall = 0.0
    for number, (deltas, phase_wall) in sorted(phase_counts.items()):
        est = plane_cost.plane_seconds(cost, deltas)
        print(f"[plane] phase {number}: {int(est['morsels'])} operator-morsels "
              f"({est['morsels_s']:.4f} s), {int(est['device_incs'])} device increments at most "
              f"({est['device_incs_s']:.4f} s), {int(est['queries'])} queries "
              f"({est['queries_s']:.4f} s): the plane {est['total_s']:.4f} s of the phase's "
              f"{phase_wall:.1f} s ({100.0 * est['total_s'] / phase_wall:.3f} %)", flush=True)
        if number <= 18:
            spent += est["total_s"]
            wall += phase_wall
    print(f"[plane] phases 1-18: the plane {spent:.3f} s of {wall:.1f} s "
          f"({100.0 * spent / wall:.3f} %) [{card}]", flush=True)
    for name, (counts, off_s, best_pct, paired_pct) in sorted(loops.items()):
        est = plane_cost.loop_overheads(cost, counts, off_s)
        plane = "registry" if name == "metrics" else "profiler"
        print(f"[plane] phase 19's {name} loop: {int(est['morsels'])} operator-morsels and "
              f"{int(est['device_incs'])} device increments a rep; the {plane}'s own cost "
              f"{est[plane + '_s'] * 1e3:.4f} ms = {est[plane + '_pct']:.4f} % of the median "
              f"{off_s:.4f} s without it, against {best_pct:.3f} % / {paired_pct:.3f} % measured "
              f"(the JAX package's budget {OVERHEAD_BUDGET_PCT} %) [{card}]", flush=True)


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
    sampler = PhaseSampler()
    phase_counts = {}

    def timed(number: int, fn, *args):
        from daft_tpu_torch.tools.plane_cost import counter_totals

        before = counter_totals()
        t0 = time.perf_counter()
        out = fn(*args)
        wall = time.perf_counter() - t0
        after = counter_totals()
        phase_counts[number] = ({k: after[k] - before[k] for k in after}, wall)
        print(f"[run] phase {number} ({fn.__name__}) took {wall:.1f} s; "
              f"{time.perf_counter() - start:.1f} s since the start [{card}]", flush=True)
        sampler.report(number)
        return out

    try:
        timed(1, phase_build)
        records = [timed(2, phase_kernels, card)]
        launches, wall_ms = timed(3, phase_main_path, card)
        timed(4, phase_trace, card)
        by_path = {"embed_image": launches}
        for number, phase in enumerate((phase_text, phase_generate, phase_relational, phase_hf,
                                        phase_image, phase_relational_joins, phase_pipelined),
                                       start=5):
            by_path.update(timed(number, phase, card))
        by_path.update(timed(12, phase_scan, card, SCAN_ROWS))
        by_path.update(timed(13, phase_expressions, card))
        sql_paths, sql_state = timed(14, phase_sql, card)
        by_path.update(sql_paths)
        by_path.update(timed(15, phase_out_of_core, card, sql_state))
        by_path.update(timed(16, phase_windows, card, sql_state))
        by_path.update(timed(17, phase_surface, card, sql_state))
        by_path.update(timed(18, phase_udfs_media, card, sql_state))
        by_path.update(timed(19, phase_observability, card, sql_state))
        plane_report(card, phase_counts, sql_state.get("obs_loops", {}))
        by_path.update(timed(20, phase_ai_surface, card))
        by_path.update(timed(21, phase_multi_device, card))
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        sampler.close()
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
