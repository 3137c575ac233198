"""Local execution engine (port of ``daft_tpu/execution/executor.py``).

Runs a physical plan as a pull chain of operator generators, yielding result
MicroPartitions in input order. The port has these operators:

* ``InMemorySource`` — yields the materialised partitions;
* ``Project`` / ``Filter`` — the maximal Project/Filter chain below a node runs
  as one stage over ``morselize``d input (morsels of ``MIN_MORSEL_ROWS`` ..
  ``default_morsel_size`` rows); the longest suffix of the chain that the
  device can run whole runs as ONE program per morsel
  (``ops/compiled_eval.ChainSpec``), the rest step by step, where each
  projection's numeric subtrees may still run on the device
  (``ops/device_eval``);
* ``UDFProject`` — re-morsels its input to ``min(udf.batch_size * 16,
  default_morsel_size)`` rows (16 device batches per morsel: enough chunks for
  the provider to overlap the copy of one with the forward of another, with a
  bounded host window) and evaluates the UDF per morsel;
* ``Aggregate`` — partial aggregation per chunk of ``AGG_CHUNK_ROWS``+ rows.
  A global one absorbs the Project/Filter chain below it: the chain and the
  partial aggregation run as one program per chunk
  (``ops/compiled_eval.AggChainSpec``). A grouped one leaves the chain as its
  own stage and aggregates through Acero on the host, the aggregations'
  children too, as the JAX package does; the first morsel's group reduction
  picks the route: merge the chunks' partials in chunk order at the end, or, above
  ``high_cardinality_aggregation_threshold``, hash-partition the rows into
  ``num_compute_threads`` buckets and aggregate each bucket once;
* ``Limit`` — offset/limit over the stream, closing its input early.

Every stage runs sequentially on the calling thread, the partitioned
aggregation's buckets too. Not ported yet: the shared compute pool and
pipelined stages (``map_stage``, ROADMAP A.9.4), UDF replica concurrency and
dynamic batching, memory permits and spill (the grouped aggregation's grace
spill under a memory budget goes with them, A.3), cancellation, profiling
spans, runtime stats, the feedback plane, shared-subtree caching, and the
other operators (scan, joins, sort, window, repartition, write, ...).
"""

from __future__ import annotations

import itertools
import os
from typing import Iterator, List, Optional

import numpy as np

from daft_tpu_torch.context import ExecutionConfig
from daft_tpu_torch.errors import DaftPlanError
from daft_tpu_torch.execution.aggregation import AggState
from daft_tpu_torch.execution.join_index import _key_values
from daft_tpu_torch.execution.pipeline import chunk_morsels, morselize, split_morsels
from daft_tpu_torch.expressions.evaluator import evaluate
from daft_tpu_torch.expressions.expr import UdfCall
from daft_tpu_torch.micropartition import MicroPartition
from daft_tpu_torch.ops import compiled_eval
from daft_tpu_torch.ops.device_eval import device_eval_counters
from daft_tpu_torch.physical import plan as pp
from daft_tpu_torch.recordbatch import RecordBatch
from daft_tpu_torch.series import Series


class Executor:
    """Runs a local physical plan, yielding result MicroPartitions."""

    #: Rows per partial-aggregation chunk. FIXED, so the association of the
    #: float partial sums depends only on the input stream.
    AGG_CHUNK_ROWS = 256 * 1024
    #: Morsels smaller than this merge before a Project/Filter/Aggregate stage
    #: (the JAX package's default ``min_morsel_size``).
    MIN_MORSEL_ROWS = 16 * 1024

    def __init__(self, cfg: ExecutionConfig):
        self.cfg = cfg
        self.max_morsel_rows = cfg.default_morsel_size
        self.min_morsel_rows = min(self.MIN_MORSEL_ROWS, self.max_morsel_rows)
        n = cfg.num_compute_threads
        self.compute_threads = n if n > 0 else (os.cpu_count() or 1)

    def run(self, plan: pp.PhysicalPlan) -> Iterator[MicroPartition]:
        return self._run(plan)

    def _run(self, node: pp.PhysicalPlan) -> Iterator[MicroPartition]:
        handler = getattr(self, f"_run_{type(node).__name__}", None)
        if handler is None:
            raise DaftPlanError(f"No executor for physical node {node.name()}")
        return handler(node)

    def _run_InMemorySource(self, node: pp.InMemorySource) -> Iterator[MicroPartition]:
        yield from node.partitions

    def _run_Project(self, node: pp.Project) -> Iterator[MicroPartition]:
        yield from self._run_relational_chain(node)

    def _run_Filter(self, node: pp.Filter) -> Iterator[MicroPartition]:
        yield from self._run_relational_chain(node)

    # -- stage + kernel fusion -------------------------------------------
    @staticmethod
    def _node_kernel(nd):
        """The interpreted per-morsel kernel for one Project/Filter node."""
        if isinstance(nd, pp.Filter):
            return lambda mp: mp.filter(nd.predicate)
        return lambda mp: mp.eval_expression_list(nd.exprs)

    @staticmethod
    def _collect_stage_chain(head) -> List[pp.PhysicalPlan]:
        """The maximal Project/Filter chain rooted at ``head``, top-first: a
        pure function of the plan."""
        nodes = [head]
        while isinstance(nodes[-1].children[0], (pp.Project, pp.Filter)):
            nodes.append(nodes[-1].children[0])
        return nodes

    @staticmethod
    def _chain_steps(nodes) -> List[tuple]:
        """(kind, payload) steps in EXECUTION (bottom-up) order for a
        top-first node chain."""
        return [("filter", nd.predicate) if isinstance(nd, pp.Filter)
                else ("project", list(nd.exprs)) for nd in reversed(nodes)]

    def _compiled_suffix(self, nodes, steps, out_schema):
        """The longest SUFFIX of a bottom-up step chain that runs on the
        device whole (real plans often carry a prefix it cannot run, such as
        a cast off a 64-bit source): ``(k, spec, reason)`` where steps[:k]
        stay interpreted and steps[k:] run as one program, or
        ``(0, None, reason)`` with the first refusal's reason."""
        exec_order = list(reversed(nodes))  # exec_order[i] produced steps[i]
        first_reason = None
        for k in range(len(steps)):
            input_schema = nodes[-1].children[0].schema if k == 0 else exec_order[k - 1].schema
            spec, reason = compiled_eval.build_chain_spec(steps[k:], input_schema, out_schema,
                                                          self.cfg)
            if spec is not None:
                return k, spec, None
            first_reason = first_reason or reason
        return 0, None, first_reason

    def _run_relational_chain(self, head) -> Iterator[MicroPartition]:
        """A Project/Filter chain as one stage: the interpreted prefix, then
        the device suffix as one program per morsel."""
        nodes = self._collect_stage_chain(head)
        if len(nodes) > 1:
            device_eval_counters.record_stage_fusions(len(nodes) - 1)
        steps = self._chain_steps(nodes)
        split, spec, reason = self._compiled_suffix(nodes, steps, head.schema)
        kernels = [self._node_kernel(nd) for nd in reversed(nodes)]
        for mp in morselize(self._run(nodes[-1].children[0]), self.min_morsel_rows,
                            self.max_morsel_rows):
            for kern in kernels[:split]:
                mp = kern(mp)
            if spec is not None:
                out = spec.run_morsel(mp)
                if out is not None:
                    yield out
                    continue
            elif reason != "nothing_on_device":
                device_eval_counters.record_host(f"chain_{reason}", rows=len(mp))
            for kern in kernels[split:]:
                mp = kern(mp)
            yield mp

    def _run_UDFProject(self, node: pp.UDFProject) -> Iterator[MicroPartition]:
        udf = next(n.udf for n in node.udf_expr.walk() if isinstance(n, UdfCall))
        exprs = node.passthrough + [node.udf_expr]
        udf_bs = udf.batch_size
        morsel_rows = self.cfg.default_morsel_size
        if udf_bs:
            morsel_rows = min(udf_bs * 16, morsel_rows)
        for mp in split_morsels(self._run(node.children[0]), morsel_rows):
            yield mp.eval_expression_list(exprs)

    def _run_Aggregate(self, node: pp.Aggregate) -> Iterator[MicroPartition]:
        def fresh_state() -> AggState:
            return AggState(node.agg_exprs, node.group_by, node.schema,
                            input_schema=node.children[0].schema)

        yield from self._pipelined_agg(node, fresh_state)

    def _pipelined_agg(self, node: pp.Aggregate, fresh_state) -> Iterator[MicroPartition]:
        """In-memory aggregation with a cardinality-adaptive strategy:

        * the input is morselized and packed into row-chunks of more than
          ``AGG_CHUNK_ROWS`` rows (pure functions of the stream);
        * a global aggregation absorbs the Filter/Project chain below it: the
          chain and the partial aggregation run as ONE program per chunk where
          the whole of it (or a suffix of the chain with the aggregation) runs
          on the device; otherwise the chain runs as its own stage and the
          partials on the host;
        * a grouped aggregation leaves the chain as its own stage (its
          device suffix still runs as one program per morsel) and aggregates
          each chunk through Acero on the host; the first morsel's partial
          measures the group reduction;
        * low-cardinality aggregations merge the chunks' partials in chunk
          order (each group's per-chunk sums associate at fixed chunk
          boundaries);
        * high-cardinality ones (partials barely shrink, so a merge pass would
          nearly double the work) hash-partition instead.
        """
        state: AggState = fresh_state()
        plan = state.plan
        agg_spec, agg_split, reason = None, 0, "grouped"
        chain_nodes: List[pp.PhysicalPlan] = []
        cur = node.children[0]
        if not plan.group_by:
            reason = None
            while isinstance(cur, (pp.Project, pp.Filter)):
                chain_nodes.append(cur)
                cur = cur.children[0]
            steps = self._chain_steps(chain_nodes)
            exec_order = list(reversed(chain_nodes))
            partial_schema = state.partial_schema(node.children[0].schema)
            # Longest device suffix; k may reach len(steps): a bare partial
            # reduction still runs on the device when the chain cannot.
            for k in range(len(steps) + 1):
                input_schema = cur.schema if k == 0 else exec_order[k - 1].schema
                agg_spec, why = compiled_eval.build_agg_chain_spec(
                    steps[k:], plan, input_schema, partial_schema, self.cfg)
                reason = reason or why
                if agg_spec is not None:
                    agg_split = k
                    break
        source = self._run(cur) if agg_spec is not None else self._run(node.children[0])
        chunks = chunk_morsels(morselize(source, self.min_morsel_rows, self.max_morsel_rows),
                               self.AGG_CHUNK_ROWS)
        first = next(chunks, None)
        if first is None:
            yield MicroPartition(node.schema, [state.finalize()])
            return
        chain_kernels = [self._node_kernel(nd) for nd in reversed(chain_nodes)]

        def partial_of(chunk: List[MicroPartition]) -> RecordBatch:
            return self._partial_of(chunk, plan, agg_spec, agg_split, cur, chain_kernels, reason)

        yield from self._pipelined_agg_body(node, fresh_state, state, plan, first, chunks,
                                            partial_of)

    def _pipelined_agg_body(self, node, fresh_state, state, plan, first, chunks,
                            partial_of) -> Iterator[MicroPartition]:
        if plan.group_by:
            # Cardinality probe on the FIRST MORSEL only (bounded waste:
            # probing a whole chunk would hash-aggregate the chunk twice on
            # the high-cardinality path). Data-driven, so every bucket count
            # takes the same branch.
            probe = partial_of(first[:1])
            if len(probe) > len(first[0]) * self.cfg.high_cardinality_aggregation_threshold:
                yield from self._partitioned_agg(node, fresh_state,
                                                 itertools.chain([first], chunks))
                return
        # add_partial defers merging to ONE pass at finalize: the threshold
        # merge would re-aggregate the whole merged state once per chunk as
        # soon as it outgrows the threshold.
        for chunk in itertools.chain([first], chunks):
            state.add_partial(partial_of(chunk))
        yield MicroPartition(node.schema, [state.finalize()])

    def _partitioned_agg(self, node: pp.Aggregate, fresh_state,
                         chunks) -> Iterator[MicroPartition]:
        """High-cardinality grouped aggregation: hash-partition each chunk by
        group key into one bucket per worker, then aggregate every bucket
        SINGLE-SHOT. A group's rows land whole in one bucket with input order
        preserved (stable partitioning), so each group's float accumulation
        order, and thus every sum, is the same at any bucket count; only the
        output ROW order varies with it, and grouped output order is
        unspecified engine-wide. The port aggregates the buckets one after
        another (the compute pool is ROADMAP A.9.4)."""
        buckets_n = max(self.compute_threads, 1)
        buckets: List[List[RecordBatch]] = [[] for _ in range(buckets_n)]
        for chunk in chunks:
            rb = RecordBatch.concat([b for mp in chunk for b in mp.record_batches()])
            keys = [evaluate(g, rb) for g in node.group_by]
            parts = self._cheap_int_partition(rb, keys, buckets_n)
            if parts is None:
                parts = rb.partition_by_hash(keys, buckets_n)
            for i, part in enumerate(parts):
                if len(part):
                    buckets[i].append(part)
        for rbs in buckets:
            st: AggState = fresh_state()
            if rbs:
                rb = rbs[0] if len(rbs) == 1 else RecordBatch.concat(rbs)
                # One partial pass over the whole bucket (bypassing the flush
                # threshold keeps each group's association a single in-order
                # Acero pass, invariant to the bucket count).
                st.accumulate_partial(self._grouped_partial(rb, st.plan))
            out = st.finalize()
            if len(out):
                yield MicroPartition(node.schema, [out])

    @staticmethod
    def _cheap_int_partition(rb: RecordBatch, keys,
                             n_buckets: int) -> Optional[List[RecordBatch]]:
        """Bucket rows on a SINGLE int-like group key with one vector
        multiply-shift and per-bucket mask filters, cheaper than the generic
        row hash + stable sort. Order within a bucket is input order (the
        filter is stable), which the float-determinism contract rests on;
        None defers to the generic path. Bucket assignment depends only on
        key values and the bucket count."""
        if len(keys) != 1:
            return None
        kv = _key_values(keys[0])  # the ONE int-like-key eligibility rule
        if kv is None:
            return None
        vals, mask = kv
        # Eligibility is by dtype only, never by data: chunks of one
        # aggregation that disagreed on the bucket function would split a
        # group across buckets. Any int width maps through a wrap-around
        # uint64 cast, the same for every chunk.
        if vals.dtype.kind == "M":
            h = vals.view(np.int64).astype(np.uint64)
        else:
            h = vals.astype(np.uint64)
        # Fibonacci multiplicative hash: one multiply + shift scrambles
        # strided key sets (all-even keys etc.) that a bare modulo clumps.
        with np.errstate(over="ignore"):
            h = (h * np.uint64(0x9E3779B97F4A7C15)) >> np.uint64(17)
        ids = (h % np.uint64(n_buckets)).astype(np.int64)
        if mask is not None:
            ids[mask] = 0  # null group rows all land in bucket 0
        return [rb.filter(Series.from_numpy(ids == b, "m")) for b in range(n_buckets)]

    @staticmethod
    def _grouped_partial(rb: RecordBatch, plan) -> RecordBatch:
        """A grouped partial aggregation, its children included: Acero on
        the host, counted as ``agg_grouped``."""
        device_eval_counters.record_host("agg_grouped", rows=len(rb))
        return rb.agg(plan.partial_exprs, plan.group_by)

    def _partial_of(self, chunk: List[MicroPartition], plan, agg_spec, agg_split: int, cur,
                    chain_kernels, reason: Optional[str]) -> RecordBatch:
        rb = RecordBatch.concat([b for mp in chunk for b in mp.record_batches()])
        if plan.group_by:
            return self._grouped_partial(rb, plan)
        if agg_spec is None:
            device_eval_counters.record_host(f"agg_{reason}", rows=len(rb))
            return rb.agg(plan.partial_exprs)
        # The interpreted prefix (steps the device cannot run), then the
        # device suffix with the partial aggregation as one program.
        mp = MicroPartition(cur.schema, [rb])
        for kern in chain_kernels[:agg_split]:
            mp = kern(mp)
        rb = mp.combined()
        out = agg_spec.run_chunk(rb)
        if out is not None:
            return out
        # A data-driven host route (counted by run_chunk): finish the suffix
        # interpreted.
        for kern in chain_kernels[agg_split:]:
            mp = kern(mp)
        return mp.combined().agg(plan.partial_exprs)

    def _run_Limit(self, node: pp.Limit) -> Iterator[MicroPartition]:
        to_skip = node.offset
        remaining = node.limit
        for mp in self._run(node.children[0]):
            if to_skip > 0:
                n = len(mp)
                if n <= to_skip:
                    to_skip -= n
                    continue
                mp = mp.slice(to_skip, n - to_skip)
                to_skip = 0
            if remaining <= 0:
                break
            if len(mp) > remaining:
                mp = mp.head(remaining)
            remaining -= len(mp)
            yield mp
            if remaining <= 0:
                break
