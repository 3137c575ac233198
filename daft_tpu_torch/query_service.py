"""The table registry of the query service (the registry lines of
``daft_tpu/query_service.py``).

``register_table(name, df)`` names a DataFrame for the SQL the query service
serves. ``submit_query`` and its HTTP and Arrow Flight transports, which read
this registry, are ROADMAP A.8.4.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from daft_tpu_torch.errors import DaftValueError


class TableRegistry:
    """Named DataFrames servable to the query service (one per process)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._tables: Dict[str, object] = {}

    def register(self, name: str, df) -> None:
        if not name or not isinstance(name, str):
            raise DaftValueError(f"table name must be a non-empty string, got {name!r}")
        with self._lock:
            self._tables[name] = df

    def unregister(self, name: str) -> None:
        with self._lock:
            self._tables.pop(name, None)

    def tables(self) -> Dict[str, object]:
        with self._lock:
            return dict(self._tables)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._tables)


_REGISTRY: Optional[TableRegistry] = None
_registry_lock = threading.Lock()


def get_table_registry() -> TableRegistry:
    global _REGISTRY
    if _REGISTRY is None:
        with _registry_lock:
            if _REGISTRY is None:
                _REGISTRY = TableRegistry()
    return _REGISTRY


def register_table(name: str, df) -> None:
    """Serve ``df`` as SQL table ``name`` to the query service
    (``daft_tpu_torch.register_table``)."""
    get_table_registry().register(name, df)
