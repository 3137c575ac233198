"""Query caching: the plan-fingerprint cache and the byte-accounted
result / scan cache (port of ``daft_tpu/plancache.py``).

* **One fingerprint scheme** (:func:`fingerprint`): a 16-hex sha1 of
  canonical text. Plan keys are computed **pre-optimize** on the canonical
  logical-plan text (:func:`compute_query_key`), so a repeated shape never
  pays the optimizer to find that it is repeated; the execution config's
  planning-relevant fields digest into the key (:func:`config_digest`), so
  a per-query override of a planning knob never gets a plan made under
  other rules. In-memory sources key on a process-unique uid stamped on
  each partition (``MicroPartition._cache_uid``), never on ``id()``.
* **Plan cache** (:class:`PlanCache`): a bounded LRU of (optimized logical
  plan, physical plan, plan repr). A hit skips optimize + translate. A
  cached plan over in-memory frames keeps them resident, so the cache is
  bounded on those bytes too; its entries carry the source files' (path,
  mtime, size) and a moved file drops the entry at lookup.
* **Result / scan cache** (:class:`ResultCache`): finished results and the
  scans' morsel streams, byte-accounted (``size_bytes``) per tenant, with
  the sources' fingerprints checked at every hit, and every write through
  ``io/writers.py``, ``DataFrame.write_*`` or a catalog calls
  :func:`invalidate_path`: a stale file never serves. Same-key builds
  **single-flight**: one query builds, the rest wait (cancel-aware) and
  serve its entry; a build commits only on a full drain and aborts in the
  query's ``finally``, so a failed, cancelled or abandoned query leaves no
  entry. Eviction is tenant-fair: an inserting tenant evicts its own LRU
  entries first and displaces other tenants' only inside its fair share.

A plan holding a UDF, a nondeterministic function (``now``, ``today``,
``random``, ``uuid``), an unseeded ``Sample``, a write or a source without
file identity is plan-cacheable but never result-cacheable; a correlated
subquery (keyed on its plan's identity) is neither. ``QueryKey.reason``
says why. Every commit and eviction charges its bytes to the tenant's
admission quota (:meth:`ResultCache._apply_admission_charges`), and
admission reclaims them through :meth:`ResultCache.shrink_tenant` when a
live query needs the room.
``put_view`` / ``update_view_freshness`` / ``drop_view`` serve the
streaming views of ROADMAP A.8.6.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import logging
import os
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

log = logging.getLogger("daft_tpu_torch.plancache")

#: Eviction reasons (the ``reason`` label on daft_result_cache_evictions).
EVICT_CAPACITY = "capacity"
EVICT_INVALIDATED = "invalidated"
EVICT_STALE = "stale-source"
EVICT_QUOTA = "tenant-quota"


def fingerprint(text: str) -> str:
    """THE engine fingerprint: 16-hex-char sha1 of canonical text, the JAX
    package's. Both caches, the flight recorder and the SLO tail sampler
    key on it: identical inputs produce identical, joinable keys
    everywhere."""
    return hashlib.sha1(text.encode("utf-8", "replace")).hexdigest()[:16]


# --------------------------------------------------------------------- #
# Canonical plan text + config digest                                     #
# --------------------------------------------------------------------- #
#: Config fields that cannot change what a plan computes: execution-time
#: budgets, observability, fault machinery, admission, and the cache's own
#: knobs. Everything NOT listed here digests into the cache key, so a new
#: config field is conservatively key-relevant until proven otherwise.
_NONPLANNING_FIELDS = frozenset({
    "num_compute_threads", "num_workers", "autoscaling_threshold",
    "query_timeout_s", "cancel_drain_grace_s",
    "task_max_retries", "task_transient_backoff_s",
    "task_transient_backoff_cap_s", "max_partition_recoveries",
    "speculative_execution", "speculative_multiplier",
    "speculative_min_completed", "heartbeat_interval_s",
    "heartbeat_miss_threshold", "fault_spec", "fault_seed",
    "circuit_failure_threshold", "circuit_open_base_s",
    "circuit_open_cap_s", "circuit_half_open_probes",
    "metrics_enabled", "metrics_export_path",
    "admission_enabled", "admission_max_concurrent_queries",
    "admission_queue_depth", "admission_max_memory_fraction",
    "admission_policies", "admission_overload_queue_fraction",
    "admission_permit_wait_p95_s", "admission_shed_cooldown_s",
    "profile_enabled", "profile_export_path",
    "query_recorder_enabled", "query_log_path",
    "slo_latency_p99_s", "slo_error_rate", "slo_fast_window_s",
    "slo_slow_window_s", "slo_fast_burn", "slo_slow_burn",
    "slo_autoprofile_count", "slo_slow_query_s",
    "plan_cache_enabled", "plan_cache_size", "plan_cache_max_pinned_bytes",
    "result_cache_enabled", "result_cache_max_bytes",
    "result_cache_max_entry_bytes", "result_cache_scan_outputs",
    "streaming_max_batch_files", "streaming_max_batch_bytes",
    "streaming_poll_interval_s", "streaming_checkpoint_dir",
    "slo_staleness_p99_s",
    # Feedback OBSERVATION knobs are runtime-only (stamping estimates
    # changes no plan); feedback_correct_plans is deliberately absent —
    # corrections change the optimized plan, so flipping the knob must
    # key distinct plan-cache entries.
    "feedback_enabled", "feedback_path", "feedback_ewma_alpha",
    "feedback_max_fingerprints", "feedback_probe_factor",
})

#: Result-cache entry kinds. ``result`` and ``scan`` entries are built by
#: queries and dropped on write-invalidation; ``view`` entries are OWNED
#: by the materialized-view registry (the streaming views, ROADMAP A.8.6) — they
#: are published by refreshes, served with freshness metadata, and a
#: write under their roots marks them stale-but-servable instead of
#: dropping them (the refresh absorbs the delta; recomputing per write is
#: exactly the cost views exist to avoid).
KIND_RESULT = "result"
KIND_SCAN = "scan"
KIND_VIEW = "view"

#: Function calls whose output depends on when/where the query runs, not
#: only on its inputs — plans containing them must never serve from the
#: result cache (``now()``/``today()`` read the per-query frozen clock).
_NONDETERMINISTIC_FNS = frozenset({"now", "today", "random", "rand", "uuid"})


def config_digest(cfg) -> str:
    """Digest of the planning-relevant execution-config fields. Part of
    every cache key: a per-query override of a planning knob (pushdown
    strictness, fusion flags, morsel sizing) keys a distinct entry instead
    of being served a plan optimized under different rules. Memoized per
    config value (frozen dataclasses hash by value) — the digest is on
    every query's hot path."""
    try:
        return _config_digest_cached(cfg)
    except TypeError:  # unhashable custom cfg (tests): compute directly
        return _config_digest_uncached(cfg)


def _config_digest_uncached(cfg) -> str:
    parts = []
    for f in dataclasses.fields(cfg):
        if f.name not in _NONPLANNING_FIELDS:
            parts.append(f"{f.name}={getattr(cfg, f.name)!r}")
    return fingerprint(";".join(parts))


@functools.lru_cache(maxsize=64)
def _config_digest_cached(cfg) -> str:
    return _config_digest_uncached(cfg)


def _attr_text(v, note=None) -> str:
    from daft_tpu_torch.expressions.expr import Expr

    if isinstance(v, Expr):
        # Structural identity, the compiled-eval discipline: two spellings
        # of the same expression tree share a key. ONE traversal emits the
        # canonical text AND flags nondeterminism/UDFs — this is every
        # query's hot path, so no second walk and no nested-tuple reprs.
        out: List[str] = []
        _expr_text(v, out, note)
        return "E(" + ";".join(out) + ")"
    if isinstance(v, (list, tuple)):
        return "[" + ",".join(_attr_text(x, note) for x in v) + "]"
    if isinstance(v, dict):
        return "{" + ",".join(
            f"{k}:{_attr_text(x, note)}"
            for k, x in sorted(v.items(), key=lambda kv: str(kv[0]))) + "}"
    return repr(v)


def _expr_text(e, out: List[str], note) -> None:
    from daft_tpu_torch.expressions.expr import FunctionCall, InSubquery, UdfCall

    out.append(type(e).__name__)
    out.append(repr(e._attrs_key()))
    if note is not None:
        if isinstance(e, UdfCall):
            note("UDF in plan")
        elif isinstance(e, InSubquery):
            # InSubquery keys on id(its plan): valid only while the plan
            # object lives, which nothing in a cache entry guarantees —
            # neither cache may key on it.
            note("correlated subquery (identity-keyed plan)",
                 plan_too=True)
        elif isinstance(e, FunctionCall) \
                and e.fn_name in _NONDETERMINISTIC_FNS:
            note(f"nondeterministic {e.fn_name}()")
    for c in e.children():
        _expr_text(c, out, note)


_uid_counter = iter(range(1, 1 << 62)).__next__
_uid_lock = threading.Lock()


def _partition_uid(p) -> Optional[int]:
    """Process-unique identity for an immutable in-memory partition,
    stamped lazily (micropartition.py reserves the ``_cache_uid`` slot).
    Unlike ``id()``, a uid is never recycled: a cache entry keyed on it
    can outlive the partition without ever aliasing a new frame at a
    reused address — so entries need no strong refs to source data.
    Returns None for foreign objects that cannot be stamped."""
    uid = getattr(p, "_cache_uid", None)
    if uid is None:
        with _uid_lock:
            uid = getattr(p, "_cache_uid", None)
            if uid is None:
                uid = _uid_counter()
                try:
                    p._cache_uid = uid
                except (AttributeError, TypeError):
                    return None
    return uid


def _node_text(node, roots: List[str], note) -> str:
    from daft_tpu_torch.logical import plan as lp

    name = type(node).__name__
    if isinstance(node, lp.InMemorySource):
        # Identity-keyed via process-unique uids: immutable partitions, so
        # same objects = same data, and a uid is never recycled — cache
        # entries need no strong refs to the source frames.
        parts = []
        for p in node.partitions:
            uid = _partition_uid(p)
            if uid is None and note is not None:
                # Unstampable (stubbed/foreign partition type): id() could
                # be recycled after GC, so results must not be served on
                # this key. The PLAN cache stays safe — its entry holds
                # the plan, which holds the partitions, so the ids it
                # keyed on stay valid for the entry's lifetime.
                note("unstampable in-memory partition")
            parts.append(format(uid if uid is not None else id(p), "x"))
        return f"{name}({','.join(parts)};cols={node.schema.column_names()})"
    if isinstance(node, lp.ScanSource):
        si = node.scan_info
        paths = getattr(si, "paths", None)
        if paths is None:
            # Plugin / generator sources (_PythonScanInfo, DataSource
            # wrappers) have no path identity to fingerprint or stat:
            # identity-key them (the QueryKey's plan pin keeps the id
            # valid) so the PLAN cache still works, but never serve their
            # results from cache — the source may read anything.
            if note is not None:
                note("unfingerprintable source "
                     f"({type(si).__name__})")
            return f"{name}(si:{id(si):x};cols={node.schema.column_names()})"
        if getattr(si, "ephemeral", False) and note is not None:
            # Streaming delta micro-batch: a one-shot explicit file list
            # that never repeats — caching its plan or result would only
            # churn the LRUs with single-use keys.
            note("ephemeral streaming scan", plan_too=True)
        roots.extend(_normalize_path(p) for p in paths)
        opts = {k: v for k, v in getattr(si, "read_options", {}).items()
                if k != "io_config"}
        return (f"{name}({getattr(si, 'file_format', '?')};"
                f"paths={sorted(paths)!r};"
                f"opts={_attr_text(opts)};push={node.pushdowns!r};"
                f"cols={node.schema.column_names()}{_io_text(si, paths)})")
    parts = [name]
    for k in sorted(vars(node)):
        if k.startswith("_"):
            # Private attrs are engine bookkeeping, never plan content:
            # _children/_schema are canonicalized elsewhere, and memo
            # stamps (ReorderJoins' _reordered / _ndv_cache, feedback's
            # _fb_nfp node fingerprints) land lazily on shared subtrees —
            # including them would make a query's fingerprint depend on
            # what ran before it.
            continue
        parts.append(f"{k}={_attr_text(vars(node)[k], note)}")
    return "(".join([parts[0], ";".join(parts[1:]) + ")"])


@dataclasses.dataclass
class QueryKey:
    """Canonical identity of one query: fingerprint over canonical plan
    text + planning-config digest, plus everything the caches need to stay
    honest about it (scan roots for write invalidation, cacheability per
    tier, and how many in-memory source bytes a plan-cache entry would
    keep resident)."""

    fp: str
    text: str
    roots: List[str]  # normalized scan paths for write invalidation
    result_cacheable: bool
    plan_cacheable: bool = True
    reason: str = ""  # why NOT result-cacheable (EXPLAIN surface)
    #: Bytes of in-memory source partitions the plan (and so a plan-cache
    #: entry holding it) references — the plan cache's eviction currency.
    pinned_bytes: int = 0


def _io_text(si, paths) -> str:
    """The digest of the IOConfig that a scan of remote paths resolves them
    with (its own, else the context's default), or '' for local paths or
    none set: the same URL through another endpoint or credentials is
    another source, and the JAX package's key, which drops ``io_config``,
    serves it the first store's plan and rows (ROADMAP C.54)."""
    if all("://" not in p or p.startswith("file://") for p in paths):
        return ""
    io = getattr(si, "read_options", {}).get("io_config")
    if io is None:
        from daft_tpu_torch.context import get_context

        io = get_context().planning_config.default_io_config
    return "" if io is None else f";io={fingerprint(repr(io))}"


def _normalize_path(p: str) -> str:
    if "://" in p:
        return p
    return os.path.abspath(os.path.expanduser(p))


def compute_query_key(plan, cfg) -> QueryKey:
    """Canonical pre-optimize key for a logical plan under a config. Cheap:
    ONE plan walk builds the canonical text AND collects invalidation
    roots AND flags result-uncacheable constructs — never an optimizer
    pass, never IO (this runs on every query's hot path)."""
    from daft_tpu_torch.logical import plan as lp

    roots: List[str] = []
    lines: List[str] = []
    cacheable = True
    plan_ok = True
    reason = ""
    pinned = 0

    def note(why: str, plan_too: bool = False) -> None:
        nonlocal cacheable, plan_ok, reason
        if cacheable:
            cacheable, reason = False, why
        if plan_too:
            plan_ok = False

    for depth, node in _walk_with_depth(plan):
        lines.append(f"{depth}:{_node_text(node, roots, note)}")
        if isinstance(node, lp.InMemorySource):
            pinned += sum(p.size_bytes() for p in node.partitions)
        elif isinstance(node, lp.Sink):
            note("plan writes (Sink)")
            wi = getattr(node, "write_info", None)
            if wi is not None and getattr(wi, "root_dir", None):
                roots.append(_normalize_path(wi.root_dir))
        elif isinstance(node, lp.Sample) and node.seed is None:
            note("unseeded Sample")
    text = "\n".join(lines) + f"\ncfg:{config_digest(cfg)}"
    return QueryKey(fp=fingerprint(text), text=text, roots=roots,
                    result_cacheable=cacheable, plan_cacheable=plan_ok,
                    reason=reason, pinned_bytes=pinned)


def _walk_with_depth(plan, depth: int = 0):
    yield depth, plan
    for c in plan.children():
        yield from _walk_with_depth(c, depth + 1)




# --------------------------------------------------------------------- #
# Source-file fingerprints (stale entries must never serve)               #
# --------------------------------------------------------------------- #
def file_fingerprint(path: str, listed_size: Optional[int] = None
                     ) -> Tuple[str, Optional[int], Optional[int]]:
    """(path, mtime_ns, size) for one source file — THE freshness unit
    both cache tiers validate at hit time. Local files stat; remote URIs
    carry (path, None, listed_size) and rely on the write-invalidation
    hooks. One helper so the result tier and the executor's scan tier can
    never diverge on what 'fresh' means."""
    if "://" in path:
        return (path, None, listed_size)
    p = _normalize_path(path)
    try:
        st = os.stat(p)
        return (p, st.st_mtime_ns, st.st_size)
    except OSError:
        return (p, None, listed_size)


_GLOB_CHARS = "*?["


def _listing_dirs(paths, files) -> List[str]:
    """The local directories whose listing decides a scan's file set: each
    directory root (or a glob's fixed directory prefix) and every directory
    between it and a listed file. A file another process adds to (or
    removes from) any of them moves that directory's mtime, which the
    listed files' own fingerprints cannot show. A root naming one file
    needs none: its fingerprint covers it."""
    dirs = set()
    for p in paths:
        if "://" in p:
            continue
        p = _normalize_path(p)
        cut = min((p.find(c) for c in _GLOB_CHARS if c in p), default=-1)
        if cut >= 0:
            base = os.path.dirname(p[:cut])
        elif os.path.isdir(p):
            base = p
        else:
            continue
        dirs.add(base)
        for f in files:
            d = os.path.dirname(_normalize_path(f.path))
            while d.startswith(base + os.sep) and d not in dirs:
                dirs.add(d)
                d = os.path.dirname(d)
    return sorted(dirs)


def source_fingerprints(optimized_plan) -> List[Tuple[str, Optional[int], Optional[int]]]:
    """(path, mtime_ns, size) per source file of every ScanSource in the
    plan, and per directory whose listing gave those files
    (:func:`_listing_dirs`), so a file added there by a writer outside the
    engine makes the entry stale too. Local paths carry a stat fingerprint
    validated at every cache hit; remote URIs carry (path, None,
    listed_size) and rely on the explicit write-invalidation hooks. File
    lists are already memoized on the ScanInfo by planning — this never
    re-globs."""
    from daft_tpu_torch.logical import plan as lp

    out: List[Tuple[str, Optional[int], Optional[int]]] = []
    for node in optimized_plan.walk():
        if isinstance(node, lp.ScanSource):
            if not hasattr(node.scan_info, "files"):
                continue  # plugin source: no file identity to fingerprint
            try:
                files = node.scan_info.files()
            except Exception:  # noqa: BLE001
                # Fingerprinting must never fail planning — but a skipped
                # source means weaker hit-time validation, so say so.
                log.warning("source fingerprinting failed for %s; entry "
                            "will rely on write-invalidation only",
                            node.scan_info.display_name(), exc_info=True)
                continue
            for f in files:
                out.append(file_fingerprint(f.path, f.size_bytes))
            for d in _listing_dirs(getattr(node.scan_info, "paths", None) or [], files):
                out.append(file_fingerprint(d))
    return out


def _sources_fresh(sources) -> bool:
    for path, mtime_ns, size in sources:
        if mtime_ns is None:
            continue  # remote / unstatable: invalidation hooks own these
        try:
            st = os.stat(path)
        except OSError:
            return False
        if st.st_mtime_ns != mtime_ns or st.st_size != size:
            return False
    return True


def _path_overlaps(written: str, root: str) -> bool:
    """A write to ``written`` touches entries rooted at ``root`` when one
    is a prefix of the other (writing a file under a scanned directory, or
    rewriting the exact scanned file/dir)."""
    w = written.rstrip("/")
    r = root.rstrip("/")
    return w == r or w.startswith(r + "/") or r.startswith(w + "/")


# --------------------------------------------------------------------- #
# Plan cache                                                              #
# --------------------------------------------------------------------- #
class _PlanEntry:
    __slots__ = ("optimized_plan", "physical", "plan_repr", "sources",
                 "roots", "pinned_bytes")

    def __init__(self, optimized_plan, physical, plan_repr, sources, roots,
                 pinned_bytes):
        self.optimized_plan = optimized_plan
        self.physical = physical
        self.plan_repr = plan_repr
        self.sources = sources
        self.roots = roots
        self.pinned_bytes = pinned_bytes


class PlanCache:
    """Bounded LRU of optimize+translate outputs keyed on
    :class:`QueryKey` fingerprints. Plans are immutable descriptions
    (executor state lives on the Executor, keyed per run), so re-executing
    a cached physical plan is the engine's own re-run path.

    Double-bounded: entry COUNT (``plan_cache_size``) and, because a
    cached plan over in-memory frames keeps those frames resident (the
    plan references its InMemorySource partitions), total **pinned
    source bytes** (``plan_cache_max_pinned_bytes``) — without the byte
    bound, 256 distinct shapes over 1 GB frames would silently hold
    256 GB that no cache gauge meters."""

    def __init__(self, size: int = 256, max_pinned_bytes: int = 256 << 20):
        self.size = max(int(size), 1)
        self.max_pinned_bytes = max(int(max_pinned_bytes), 1)
        self._lock = threading.Lock()
        self._pinned_total = 0
        self._entries: "OrderedDict[str, _PlanEntry]" = OrderedDict()

    def get(self, key: QueryKey) -> Optional[_PlanEntry]:
        from daft_tpu_torch import metrics

        with self._lock:
            e = self._entries.get(key.fp)
            if e is not None and not _sources_fresh(e.sources):
                # A source file moved under the cached file list: re-plan
                # (re-glob) rather than re-execute a stale scan.
                self._pop_locked(key.fp)
                e = None
                metrics.RESULT_CACHE_EVICTIONS.labels("plan", EVICT_STALE).inc()
            if e is not None:
                self._entries.move_to_end(key.fp)
                metrics.PLAN_CACHE_HITS.inc()
                return e
        metrics.PLAN_CACHE_MISSES.inc()
        return None

    def _pop_locked(self, fp: str) -> None:
        e = self._entries.pop(fp, None)
        if e is not None:
            self._pinned_total -= e.pinned_bytes

    def put(self, key: QueryKey, optimized_plan, physical,
            plan_repr: str) -> None:
        from daft_tpu_torch import metrics

        if key.pinned_bytes > self.max_pinned_bytes:
            return  # would keep more source data resident than the budget
        entry = _PlanEntry(optimized_plan, physical, plan_repr,
                           source_fingerprints(optimized_plan),
                           list(key.roots), key.pinned_bytes)
        with self._lock:
            self._pop_locked(key.fp)
            self._entries[key.fp] = entry
            self._pinned_total += entry.pinned_bytes
            while len(self._entries) > self.size \
                    or self._pinned_total > self.max_pinned_bytes:
                fp, old = self._entries.popitem(last=False)
                self._pinned_total -= old.pinned_bytes
            metrics.PLAN_CACHE_SIZE.set(len(self._entries))

    def invalidate_path(self, path: str) -> int:
        p = _normalize_path(path)
        with self._lock:
            doomed = [fp for fp, e in self._entries.items()
                      if any(_path_overlaps(p, r) for r in e.roots)]
            for fp in doomed:
                self._pop_locked(fp)
            from daft_tpu_torch import metrics

            metrics.PLAN_CACHE_SIZE.set(len(self._entries))
        return len(doomed)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._pinned_total = 0

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries), "size": self.size,
                    "pinned_bytes": self._pinned_total,
                    "max_pinned_bytes": self.max_pinned_bytes}


# --------------------------------------------------------------------- #
# Result / scan cache                                                     #
# --------------------------------------------------------------------- #
class _ResultEntry:
    __slots__ = ("key", "kind", "tenant", "partitions", "size_bytes",
                 "sources", "roots", "created_at", "hits", "plan_repr",
                 "freshness")

    def __init__(self, key: str, kind: str, tenant: str, partitions,
                 size_bytes: int, sources, roots, plan_repr: str,
                 freshness: Optional[dict] = None):
        self.key = key
        self.kind = kind
        self.tenant = tenant
        self.partitions = partitions
        self.size_bytes = size_bytes
        self.sources = sources
        self.roots = roots
        self.plan_repr = plan_repr
        self.created_at = time.time()
        self.hits = 0
        #: ``view`` entries only: {view, watermark, refreshed_at,
        #: delta_count, pending_writes} — served alongside the partitions
        #: so a reader always knows HOW fresh the answer is.
        self.freshness = freshness


class BuildHandle:
    """Single-flight build claim for one cache key. The claiming query
    accumulates its output partitions and either :meth:`commit`\\ s the
    finished entry or :meth:`abort`\\ s — abort is idempotent, a no-op
    after commit, and MUST run in the query's ``finally`` (the admission-
    ticket discipline): a cancelled/timed-out/early-closed query leaves
    no partial entry and no byte accounting behind."""

    __slots__ = ("cache", "key", "kind", "tenant", "partitions", "bytes",
                 "_max_bytes", "_oversized", "_done", "_sources", "_roots",
                 "_plan_repr")

    def __init__(self, cache: "ResultCache", key: str, kind: str,
                 tenant: str, max_bytes: int):
        self.cache = cache
        self.key = key
        self.kind = kind
        self.tenant = tenant
        self.partitions: List = []
        self.bytes = 0
        self._max_bytes = max_bytes
        self._oversized = False
        self._done = False
        self._sources: List = []
        self._roots: List[str] = []
        self._plan_repr = ""

    def set_provenance(self, sources=None, roots=None,
                       plan_repr: str = "") -> None:
        """Source fingerprints + invalidation roots the committed entry
        will carry — captured at plan time (pre-execution stats are
        conservative: a file rewritten mid-read reads stale at the next
        hit and the entry drops)."""
        self._sources = list(sources or [])
        self._roots = list(roots or [])
        self._plan_repr = plan_repr

    def add(self, mp) -> None:
        """Accumulate one output partition (memoized size_bytes: an add,
        not a buffer walk). Oversized results stop accumulating — they can
        never be cached, so tracking them would only hold memory."""
        if self._oversized:
            return
        self.bytes += mp.size_bytes()
        if self.bytes > self._max_bytes:
            self._oversized = True
            self.partitions = []
            return
        self.partitions.append(mp)

    def commit(self) -> bool:
        if self._done:
            return False
        self._done = True
        if self._oversized:
            self.cache._finish_build(self.key, None)
            return False
        entry = _ResultEntry(self.key, self.kind, self.tenant,
                             list(self.partitions), self.bytes,
                             self._sources, self._roots, self._plan_repr)
        return self.cache._finish_build(self.key, entry)

    def abort(self) -> None:
        if self._done:
            return
        self._done = True
        self.partitions = []
        self.cache._finish_build(self.key, None)


class ResultCache:
    """The byte-accounted result/scan cache. One per process, like the
    admission controller whose tenant quotas it charges."""

    def __init__(self, max_bytes: int = 1 << 30,
                 max_entry_bytes: int = 256 << 20):
        self.capacity = max(int(max_bytes), 1)
        self.max_entry_bytes = max(int(max_entry_bytes), 1)
        self._cond = threading.Condition()
        self._entries: "OrderedDict[str, _ResultEntry]" = OrderedDict()
        self._tenant_bytes: Dict[str, int] = {}
        self._building: Dict[str, bool] = {}
        self._total = 0

    # -- lookup / single-flight build ---------------------------------- #
    def lookup_or_claim(self, key: str, kind: str, tenant: str, token=None,
                        wait_s: float = 30.0):
        """Returns ``("hit", entry)`` or ``("build", BuildHandle)``.

        Concurrent callers with the same key single-flight: the first
        claims the build, the rest wait (cancel-aware, bounded) for its
        commit and serve the entry. A failed/aborted build wakes waiters
        to a MISS — the next caller through claims a fresh build, so a
        worker dying mid-build can never poison the key."""
        from daft_tpu_torch import metrics

        deadline = time.monotonic() + wait_s
        with self._cond:
            while True:
                entry = self._peek_fresh_locked(key)
                if entry is not None:
                    entry.hits += 1
                    self._entries.move_to_end(key)
                    metrics.RESULT_CACHE_HITS.labels(kind).inc()
                    metrics.RESULT_CACHE_HIT_BYTES.inc(entry.size_bytes)
                    return "hit", entry
                if key not in self._building:
                    self._building[key] = True
                    metrics.RESULT_CACHE_MISSES.labels(kind).inc()
                    return "build", BuildHandle(self, key, kind, tenant,
                                                self.max_entry_bytes)
                # Someone is building this key: wait for their commit.
                if token is not None:
                    token.check("result-cache wait")
                if time.monotonic() >= deadline:
                    # Builder wedged past our patience: build independently
                    # (correct, just not deduplicated).
                    metrics.RESULT_CACHE_MISSES.labels(kind).inc()
                    return "build", BuildHandle(self, key + "#dup", kind,
                                                tenant, self.max_entry_bytes)
                self._cond.wait(0.05)

    def _peek_fresh_locked(self, key: str) -> Optional[_ResultEntry]:
        entry = self._entries.get(key)
        if entry is None:
            return None
        if entry.kind == KIND_VIEW:
            # Views are DESIGNED to serve while their sources move: the
            # freshness block says exactly how far behind they are, and
            # the refresh loop (not source stats) advances them.
            return entry
        if not _sources_fresh(entry.sources):
            self._remove_locked(key, EVICT_STALE)
            return None
        return entry

    def get(self, key: str) -> Optional[_ResultEntry]:
        """Plain freshness-validated lookup (no build claim)."""
        from daft_tpu_torch import metrics

        with self._cond:
            entry = self._peek_fresh_locked(key)
            if entry is not None:
                entry.hits += 1
                self._entries.move_to_end(key)
                metrics.RESULT_CACHE_HITS.labels(entry.kind).inc()
                metrics.RESULT_CACHE_HIT_BYTES.inc(entry.size_bytes)
            return entry

    def _finish_build(self, key: str, entry: Optional[_ResultEntry]) -> bool:
        """Commit (entry) or abort (None) a build; always wakes waiters."""
        charged: List[Tuple[str, int]] = []
        inserted = False
        is_dup = key.endswith("#dup")
        base_key = key.split("#dup", 1)[0]
        with self._cond:
            if not is_dup:
                # A '#dup' handle (a waiter that outlived its patience and
                # built independently) does NOT own the single-flight
                # claim: popping it would let every later same-key arrival
                # stampede while the original builder still runs.
                self._building.pop(base_key, None)
            existing = self._entries.get(base_key)
            if existing is not None and existing.kind == KIND_VIEW \
                    and (entry is None or entry.kind != KIND_VIEW):
                # The view registry owns this key: a query that raced a
                # refresh must not replace the view entry (and its
                # freshness block) with a plain result entry.
                entry = None
            if entry is not None and entry.size_bytes <= self.capacity:
                if self._make_room_locked(entry.tenant, entry.size_bytes,
                                          charged):
                    old = self._entries.pop(base_key, None)
                    if old is not None:
                        self._account_locked(old.tenant, -old.size_bytes,
                                             charged)
                    entry.key = base_key
                    self._entries[base_key] = entry
                    self._account_locked(entry.tenant, entry.size_bytes,
                                         charged)
                    inserted = True
            self._publish_gauges_locked()
            self._cond.notify_all()
        self._apply_admission_charges(charged)
        return inserted

    # -- materialized views --------------------------------------------- #
    def put_view(self, key: str, tenant: str, partitions,
                 freshness: dict, roots=None, plan_repr: str = "") -> bool:
        """Publish a materialized-view snapshot under the view's query key
        (the streaming views, ROADMAP A.8.6). Bypasses the single-flight claim —
        the view registry serializes refreshes per view itself — and
        replaces any previous snapshot atomically under the lock. Returns
        False when the snapshot is over the per-entry bound or the tenant's
        fair share refuses the bytes (the view still serves from the
        registry's in-memory snapshot; only the cache fast path is lost)."""
        size = sum(p.size_bytes() for p in partitions)
        if size > self.max_entry_bytes or size > self.capacity:
            return False
        entry = _ResultEntry(key, KIND_VIEW, tenant, list(partitions), size,
                             [], list(roots or []), plan_repr,
                             freshness=dict(freshness))
        charged: List = []
        inserted = False
        with self._cond:
            old = self._entries.pop(key, None)
            if old is not None:
                self._account_locked(old.tenant, -old.size_bytes, charged)
            if self._make_room_locked(tenant, size, charged):
                self._entries[key] = entry
                self._account_locked(tenant, size, charged)
                inserted = True
            self._publish_gauges_locked()
            self._cond.notify_all()
        self._apply_admission_charges(charged)
        return inserted

    def update_view_freshness(self, key: str, **fields) -> bool:
        """Refresh the freshness block on a live view entry (staleness is
        recomputed at read time from ``refreshed_at``; this is for
        watermark/delta-count advances that don't change the data)."""
        with self._cond:
            e = self._entries.get(key)
            if e is None or e.kind != KIND_VIEW:
                return False
            if e.freshness is None:
                e.freshness = {}
            e.freshness.update(fields)
            return True

    def drop_view(self, key: str) -> bool:
        """Unregister path: remove the view entry and its byte charges."""
        charged: List = []
        with self._cond:
            e = self._entries.get(key)
            if e is None or e.kind != KIND_VIEW:
                return False
            self._entries.pop(key)
            self._account_locked(e.tenant, -e.size_bytes, charged)
            self._publish_gauges_locked()
            self._cond.notify_all()
        self._apply_admission_charges(charged)
        return True

    # -- accounting / eviction ------------------------------------------ #
    def _account_locked(self, tenant: str, delta: int, charged: List) -> None:
        self._tenant_bytes[tenant] = self._tenant_bytes.get(tenant, 0) + delta
        if self._tenant_bytes[tenant] <= 0:
            self._tenant_bytes.pop(tenant, None)
        self._total += delta
        charged.append((tenant, delta))

    def _fair_share_locked(self, extra_tenant: str) -> int:
        tenants = set(self._tenant_bytes) | {extra_tenant}
        return self.capacity // max(len(tenants), 1)

    def _make_room_locked(self, tenant: str, need: int,
                          charged: List) -> bool:
        """Evict until ``need`` fits. Tenant-fair: the inserting tenant's
        own LRU entries go first; other tenants' entries may be displaced
        only while the inserting tenant stays within its fair share — a
        hostile tenant flooding the cache evicts itself, not its
        neighbors."""
        from daft_tpu_torch import metrics

        share = self._fair_share_locked(tenant)
        while self._total + need > self.capacity:
            own = next((k for k, e in self._entries.items()
                        if e.tenant == tenant), None)
            if own is not None:
                e = self._entries.pop(own)
                self._account_locked(e.tenant, -e.size_bytes, charged)
                metrics.RESULT_CACHE_EVICTIONS.labels(
                    e.kind, EVICT_CAPACITY).inc()
                continue
            if self._tenant_bytes.get(tenant, 0) + need > share:
                # Inserting would push this tenant past its fair share and
                # the only victims left belong to others: refuse the insert.
                metrics.RESULT_CACHE_EVICTIONS.labels("result",
                                                      EVICT_QUOTA).inc()
                return False
            victim = next(iter(self._entries), None)
            if victim is None:
                return need <= self.capacity
            e = self._entries.pop(victim)
            self._account_locked(e.tenant, -e.size_bytes, charged)
            metrics.RESULT_CACHE_EVICTIONS.labels(e.kind,
                                                  EVICT_CAPACITY).inc()
        return True

    def _remove_locked(self, key: str, reason: str,
                       charged: Optional[List] = None) -> None:
        from daft_tpu_torch import metrics

        e = self._entries.pop(key, None)
        if e is None:
            return
        local: List = charged if charged is not None else []
        self._account_locked(e.tenant, -e.size_bytes, local)
        metrics.RESULT_CACHE_EVICTIONS.labels(e.kind, reason).inc()
        if charged is None:
            self._publish_gauges_locked()
            self._apply_admission_charges(local)

    def _publish_gauges_locked(self) -> None:
        from daft_tpu_torch import metrics

        metrics.RESULT_CACHE_BYTES.set(self._total)
        metrics.RESULT_CACHE_ENTRIES.set(len(self._entries))

    @staticmethod
    def _apply_admission_charges(charged: List[Tuple[str, int]]) -> None:
        """Mirror the (tenant, byte delta) pairs into the admission
        controller's per-tenant cache ledger, strictly outside the cache
        lock: admission takes its own lock, and the reverse nesting
        (admission → cache, in ``shrink_tenant``) would otherwise
        deadlock."""
        if not charged:
            return
        from daft_tpu_torch.execution.admission import get_controller

        per_tenant: Dict[str, int] = {}
        for tenant, delta in charged:
            per_tenant[tenant] = per_tenant.get(tenant, 0) + delta
        controller = get_controller()
        for tenant, delta in per_tenant.items():
            if delta:
                controller.note_cache_bytes(tenant, delta)

    # -- invalidation ---------------------------------------------------- #
    def invalidate_path(self, path: str) -> int:
        from daft_tpu_torch import metrics

        p = _normalize_path(path)
        charged: List = []
        with self._cond:
            doomed = []
            for k, e in self._entries.items():
                if not any(_path_overlaps(p, r) for r in e.roots):
                    continue
                if e.kind == KIND_VIEW:
                    # Stale-but-servable: the write is a pending delta the
                    # next refresh absorbs; dropping the view would turn
                    # every write into a full recompute — the exact cost
                    # views exist to avoid.
                    if e.freshness is not None:
                        e.freshness["pending_writes"] = \
                            e.freshness.get("pending_writes", 0) + 1
                    continue
                doomed.append(k)
            for k in doomed:
                e = self._entries.pop(k)
                self._account_locked(e.tenant, -e.size_bytes, charged)
                metrics.RESULT_CACHE_EVICTIONS.labels(
                    e.kind, EVICT_INVALIDATED).inc()
            if doomed:
                metrics.RESULT_CACHE_INVALIDATIONS.inc(len(doomed))
            self._publish_gauges_locked()
            self._cond.notify_all()
        self._apply_admission_charges(charged)
        return len(doomed)

    def shrink_tenant(self, tenant: str, nbytes: int) -> int:
        """Reclaim >= nbytes of ``tenant``'s cache (LRU first) — called by
        admission when a live query needs quota headroom the tenant's
        cached results are occupying. Cache bytes always yield to live
        queries."""
        from daft_tpu_torch import metrics

        freed = 0
        charged: List = []
        with self._cond:
            for k in [k for k, e in self._entries.items()
                      if e.tenant == tenant]:
                if freed >= nbytes:
                    break
                e = self._entries.pop(k)
                freed += e.size_bytes
                self._account_locked(e.tenant, -e.size_bytes, charged)
                metrics.RESULT_CACHE_EVICTIONS.labels(e.kind,
                                                      EVICT_QUOTA).inc()
            self._publish_gauges_locked()
            self._cond.notify_all()
        self._apply_admission_charges(charged)
        return freed

    def clear(self) -> None:
        charged: List = []
        with self._cond:
            for k in list(self._entries):
                e = self._entries.pop(k)
                self._account_locked(e.tenant, -e.size_bytes, charged)
            self._building.clear()
            self._publish_gauges_locked()
            self._cond.notify_all()
        self._apply_admission_charges(charged)

    # -- introspection ---------------------------------------------------- #
    def stats(self) -> dict:
        with self._cond:
            return {
                "entries": len(self._entries),
                "bytes": self._total,
                "capacity": self.capacity,
                "building": len(self._building),
                "tenant_bytes": dict(self._tenant_bytes),
            }

    def snapshot(self) -> List[dict]:
        """Per-entry view (the JAX package's dashboard cache panel)."""
        with self._cond:
            out = []
            for e in self._entries.values():
                row = {
                    "key": e.key, "kind": e.kind, "tenant": e.tenant,
                    "bytes": e.size_bytes, "hits": e.hits,
                    "age_s": round(time.time() - e.created_at, 3),
                    "sources": len(e.sources),
                }
                if e.freshness is not None:
                    row["freshness"] = dict(e.freshness)
                out.append(row)
            return out


# --------------------------------------------------------------------- #
# Process globals + the write-invalidation entry point                    #
# --------------------------------------------------------------------- #
_PLAN_CACHE: Optional[PlanCache] = None
_RESULT_CACHE: Optional[ResultCache] = None
_global_lock = threading.Lock()


def get_plan_cache(cfg=None) -> PlanCache:
    global _PLAN_CACHE
    if _PLAN_CACHE is None:
        with _global_lock:
            if _PLAN_CACHE is None:
                _PLAN_CACHE = PlanCache(
                    getattr(cfg, "plan_cache_size", 256),
                    getattr(cfg, "plan_cache_max_pinned_bytes", 256 << 20))
    return _PLAN_CACHE


def get_result_cache(cfg=None) -> ResultCache:
    global _RESULT_CACHE
    if _RESULT_CACHE is None:
        with _global_lock:
            if _RESULT_CACHE is None:
                if cfg is None:
                    from daft_tpu_torch.context import get_context

                    cfg = get_context().execution_config
                _RESULT_CACHE = ResultCache(
                    getattr(cfg, "result_cache_max_bytes", 1 << 30),
                    getattr(cfg, "result_cache_max_entry_bytes", 256 << 20))
    return _RESULT_CACHE


def invalidate_path(path: str) -> int:
    """THE write-invalidation entry point: every write through
    ``io/writers.py``, ``io/sink.py``, or a catalog mutation calls this
    with the written path. Dependent plan-cache entries (stale file lists)
    and result/scan-cache entries both drop; the next read re-plans and
    re-executes. Returns the number of dropped entries."""
    n = 0
    if _PLAN_CACHE is not None:
        n += _PLAN_CACHE.invalidate_path(path)
    if _RESULT_CACHE is not None:
        n += _RESULT_CACHE.invalidate_path(path)
    return n


def reset_caches() -> None:
    """Drop all cached state (tests)."""
    if _PLAN_CACHE is not None:
        _PLAN_CACHE.clear()
    if _RESULT_CACHE is not None:
        _RESULT_CACHE.clear()


def cache_stats() -> dict:
    """Combined cache panel payload (the JAX package's dashboard serves it
    at ``/api/cache``; the port's server is ROADMAP A.8.6)."""
    return {
        "plan": get_plan_cache().stats(),
        "result": get_result_cache().stats(),
        "entries": get_result_cache().snapshot(),
    }
