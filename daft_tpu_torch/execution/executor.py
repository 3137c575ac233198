"""Local execution engine (port of ``daft_tpu/execution/executor.py``).

Runs a physical plan as a pull chain of operator generators, yielding result
MicroPartitions in input order. This slice ports four operators:

* ``InMemorySource`` — yields the materialised partitions;
* ``Project`` — evaluates the projection per morsel (morsels no larger than
  ``default_morsel_size``);
* ``UDFProject`` — re-morsels its input to ``min(udf.batch_size * 16,
  default_morsel_size)`` rows (16 device batches per morsel: enough chunks for
  the provider to overlap the copy of one with the forward of another, with a
  bounded host window) and evaluates the UDF per morsel;
* ``Limit`` — offset/limit over the stream, closing its input early.

Not ported yet: the shared compute pool and pipelined stages (``map_stage``),
stage fusion and compiled Project/Filter chains, UDF replica concurrency
(``max_concurrency`` > 1, ``chips_per_replica``) and dynamic batching, memory
permits and spill, cancellation, profiling spans, runtime stats, the feedback
plane, shared-subtree caching, and every other operator (scan, filter, joins,
aggregation, sort, window, repartition, write, ...).
"""

from __future__ import annotations

from typing import Iterator

from daft_tpu_torch.context import ExecutionConfig
from daft_tpu_torch.errors import DaftPlanError
from daft_tpu_torch.execution.pipeline import split_morsels
from daft_tpu_torch.expressions.expr import UdfCall
from daft_tpu_torch.micropartition import MicroPartition
from daft_tpu_torch.physical import plan as pp


class Executor:
    """Runs a local physical plan, yielding result MicroPartitions."""

    def __init__(self, cfg: ExecutionConfig):
        self.cfg = cfg

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
        for mp in split_morsels(self._run(node.children[0]), self.cfg.default_morsel_size):
            yield mp.eval_expression_list(node.exprs)

    def _run_UDFProject(self, node: pp.UDFProject) -> Iterator[MicroPartition]:
        udf = next(n.udf for n in node.udf_expr.walk() if isinstance(n, UdfCall))
        exprs = node.passthrough + [node.udf_expr]
        udf_bs = udf.batch_size
        morsel_rows = self.cfg.default_morsel_size
        if udf_bs:
            morsel_rows = min(udf_bs * 16, morsel_rows)
        for mp in split_morsels(self._run(node.children[0]), morsel_rows):
            yield mp.eval_expression_list(exprs)

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
