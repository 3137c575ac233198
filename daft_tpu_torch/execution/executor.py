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
* ``Aggregate`` (global) — absorbs the Project/Filter chain below it: the
  chain and the partial aggregation run as one program per chunk of
  ``AGG_CHUNK_ROWS``+ rows (``ops/compiled_eval.AggChainSpec``); partials merge
  in chunk order at the end;
* ``Limit`` — offset/limit over the stream, closing its input early.

Every stage runs sequentially on the calling thread. Not ported yet: the
shared compute pool and pipelined stages (``map_stage``), UDF replica
concurrency and dynamic batching, memory permits and spill, cancellation,
profiling spans, runtime stats, the feedback plane, shared-subtree caching,
grouped aggregation, and the other operators (scan, joins, sort, window,
repartition, write, ...).
"""

from __future__ import annotations

from typing import Iterator, List, Optional

from daft_tpu_torch.context import ExecutionConfig
from daft_tpu_torch.errors import DaftNotImplementedError, DaftPlanError
from daft_tpu_torch.execution.aggregation import AggState
from daft_tpu_torch.execution.pipeline import chunk_morsels, morselize, split_morsels
from daft_tpu_torch.expressions.expr import UdfCall
from daft_tpu_torch.micropartition import MicroPartition
from daft_tpu_torch.ops import compiled_eval
from daft_tpu_torch.ops.device_eval import device_eval_counters
from daft_tpu_torch.physical import plan as pp
from daft_tpu_torch.recordbatch import RecordBatch


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
        """Global aggregation. The Filter/Project chain below it is absorbed:
        chain → partial aggregation runs as ONE program per chunk where the
        whole of it (or a suffix of the chain with the aggregation) runs on
        the device; otherwise the chain runs as its own stage and the
        partials on the host. Partials merge in chunk order."""
        if node.group_by:
            raise DaftNotImplementedError("grouped aggregation is not ported to daft_tpu_torch")
        state = AggState(node.agg_exprs, node.schema, node.children[0].schema)
        plan = state.plan
        chain_nodes: List[pp.PhysicalPlan] = []
        cur = node.children[0]
        while isinstance(cur, (pp.Project, pp.Filter)):
            chain_nodes.append(cur)
            cur = cur.children[0]
        steps = self._chain_steps(chain_nodes)
        exec_order = list(reversed(chain_nodes))
        partial_schema = state.partial_schema()
        agg_spec, agg_split, reason = None, 0, None
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
        chain_kernels = [self._node_kernel(nd) for nd in exec_order]
        for chunk in chunk_morsels(morselize(source, self.min_morsel_rows, self.max_morsel_rows),
                                   self.AGG_CHUNK_ROWS):
            state.add_partial(self._partial_of(chunk, plan, agg_spec, agg_split, cur,
                                               chain_kernels, reason))
        yield MicroPartition(node.schema, [state.finalize()])

    @staticmethod
    def _partial_of(chunk: List[MicroPartition], plan, agg_spec, agg_split: int, cur,
                    chain_kernels, reason: Optional[str]) -> RecordBatch:
        rb = RecordBatch.concat([b for mp in chunk for b in mp.record_batches()])
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
