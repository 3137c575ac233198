"""Window specification (port of ``daft_tpu/window.py``; reference:
daft/window.py:259 — Window.partition_by / order_by / rows_between)."""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

from daft_tpu_torch.expressions.expression import Expression, col


class Window:
    # String sentinels: must keep identity across process boundaries (a
    # pickled object() sentinel is a different instance on the worker).
    unbounded_preceding = "__unbounded_preceding__"
    unbounded_following = "__unbounded_following__"
    current_row = "__current_row__"

    def __init__(self):
        self._partition_by: List[Expression] = []
        self._order_by: List[Expression] = []
        self._descending: List[bool] = []
        self._frame: Optional[Tuple] = None

    def _copy(self) -> "Window":
        w = Window()
        w._partition_by = list(self._partition_by)
        w._order_by = list(self._order_by)
        w._descending = list(self._descending)
        w._frame = self._frame
        return w

    def partition_by(self, *cols_) -> "Window":
        w = self._copy()
        w._partition_by += [c if isinstance(c, Expression) else col(c) for c in cols_]
        return w

    def order_by(self, *cols_, desc: Union[bool, List[bool]] = False) -> "Window":
        w = self._copy()
        new = [c if isinstance(c, Expression) else col(c) for c in cols_]
        w._order_by += new
        w._descending += desc if isinstance(desc, list) else [desc] * len(new)
        return w

    def rows_between(self, start, end) -> "Window":
        w = self._copy()
        w._frame = ("rows", start, end)
        return w

    def range_between(self, start, end) -> "Window":
        w = self._copy()
        w._frame = ("range", start, end)
        return w
