"""Session: attached catalogs, temp tables, SQL execution (port of
``daft_tpu/session.py``).

Reference: src/daft-session + daft/session.py:86-602 (Session.sql / attach /
create_table / use, temp tables). ``current_session()`` is the process's
session, which SQL's ``CREATE TABLE``, ``DROP TABLE``, ``INSERT``,
``SHOW TABLES``, ``USE`` and ``SET`` of a session variable run against
(``sql/planner.py``), and whose tables a query's unbound names resolve to.
Loading an extension (``load_extension``) is ROADMAP A.8.7.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from daft_tpu_torch.catalog import Catalog, InMemoryCatalog, Table, ViewTable
from daft_tpu_torch.errors import DaftValueError

_current: Optional["Session"] = None
_lock = threading.Lock()


def current_session() -> "Session":
    global _current
    with _lock:
        if _current is None:
            _current = Session()
        return _current


class Session:
    def load_extension(self, path: str):
        """The JAX package dlopens a stable-ABI plugin here (reference:
        Session.load_extension, daft/session.py:269)."""
        from daft_tpu_torch.errors import DaftNotImplementedError

        raise DaftNotImplementedError(
            "Session.load_extension is not ported to daft_tpu_torch yet: ROADMAP A.8.7 "
            "(the extension ABI)")

    def __init__(self):
        self._catalogs: Dict[str, Catalog] = {"default": InMemoryCatalog("default")}
        self._current_catalog = "default"
        self._temp_tables: Dict[str, Table] = {}
        self._variables: Dict[str, object] = {}
        self._current_namespace: Optional[str] = None

    # -- session variables (SQL SET; reference: daft-sql session vars) -----
    def set_variable(self, name: str, value) -> None:
        self._variables[name] = value

    def get_variable(self, name: str, default=None):
        return self._variables.get(name, default)

    # -- catalogs ---------------------------------------------------------
    def attach(self, catalog: Catalog, alias: Optional[str] = None) -> None:
        self._catalogs[alias or catalog.name] = catalog

    def attach_table(self, table_or_df, alias: str) -> None:
        from daft_tpu_torch.dataframe.dataframe import DataFrame

        if isinstance(table_or_df, DataFrame):
            self._temp_tables[alias] = ViewTable(alias, table_or_df)
        elif isinstance(table_or_df, Table):
            self._temp_tables[alias] = table_or_df
        else:
            raise DaftValueError(f"Cannot attach {type(table_or_df)}")

    def detach_catalog(self, alias: str) -> None:
        self._catalogs.pop(alias, None)

    def detach_table(self, alias: str) -> None:
        self._temp_tables.pop(alias, None)

    def use(self, catalog: str) -> None:
        """Switch the current catalog; ``catalog.namespace`` also records a
        current namespace (reference: Session.use / SQL USE)."""
        name, _, namespace = catalog.partition(".")
        if name not in self._catalogs:
            raise DaftValueError(f"Unknown catalog {name!r}")
        self._current_catalog = name
        self._current_namespace = namespace or None

    @property
    def current_catalog(self) -> Catalog:
        return self._catalogs[self._current_catalog]

    def list_catalogs(self) -> List[str]:
        return sorted(self._catalogs)

    # -- tables -----------------------------------------------------------
    def create_temp_table(self, name: str, df) -> Table:
        t = ViewTable(name, df)
        self._temp_tables[name] = t
        return t

    def create_table(self, name: str, source=None) -> Table:
        if "." in name:
            cat_name, tbl = name.split(".", 1)
            return self._catalogs[cat_name].create_table(tbl, source)
        if self._current_namespace:
            # USE catalog.namespace: unqualified creates land IN the
            # namespace, so a following unqualified read finds them.
            name = f"{self._current_namespace}.{name}"
        return self.current_catalog.create_table(name, source)

    def _resolve_in_current(self, name: str) -> str:
        """Namespace-scope an unqualified name against the current catalog:
        after USE catalog.namespace, ``t`` means ``namespace.t`` when that
        exists (reads/drops) — used by every entry point so reads and
        writes of the same unqualified name target the same table."""
        if self._current_namespace:
            qualified = f"{self._current_namespace}.{name}"
            if self.current_catalog.has_table(qualified):
                return qualified
        return name

    def get_table(self, name: str) -> Optional[Table]:
        if name in self._temp_tables:
            return self._temp_tables[name]
        if "." in name:
            cat_name, tbl = name.split(".", 1)
            cat = self._catalogs.get(cat_name)
            if cat is not None and cat.has_table(tbl):
                return cat.get_table(tbl)
            return None
        cat = self.current_catalog
        resolved = self._resolve_in_current(name)
        if cat.has_table(resolved):
            return cat.get_table(resolved)
        return None

    def list_tables(self, pattern: Optional[str] = None) -> List[str]:
        names = sorted(self._temp_tables) + self.current_catalog.list_tables(pattern)
        if self._current_namespace:
            prefix = self._current_namespace + "."
            scoped = [n for n in names if n.startswith(prefix) or "." not in n]
            return scoped
        return names

    def drop_table(self, name: str) -> None:
        if name in self._temp_tables:
            del self._temp_tables[name]
            return
        # Catalog-qualified names route like get_table/create_table.
        if "." in name:
            cat_name, tbl = name.split(".", 1)
            cat = self._catalogs.get(cat_name)
            if cat is not None and cat.has_table(tbl):
                cat.drop_table(tbl)
                return
        self.current_catalog.drop_table(self._resolve_in_current(name))

    # -- sql --------------------------------------------------------------
    def sql(self, query: str, **bindings):
        from daft_tpu_torch.sql.planner import plan_sql

        return plan_sql(query, bindings, session=self)
