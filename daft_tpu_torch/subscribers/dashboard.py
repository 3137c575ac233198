"""The interactive DataFrame display (port of the display part of
``daft_tpu/subscribers/dashboard.py``; reference: src/daft-dashboard
``register_dataframe_for_display`` / ``generate_interactive_html``).

``DataFrameDisplay`` keeps the previews of registered DataFrames and
``generate_interactive_html`` renders one as a standalone HTML table whose
long cells are cut and marked for expansion. The dashboard's HTTP server, its
state and its static assets are not ported (ROADMAP A.8), so nothing here
reads an asset file.
"""

from __future__ import annotations

import html
import threading
from typing import Dict, List, Optional

_CELL_TRUNCATE = 80


class DataFrameDisplay:
    """Registry of DataFrames published for interactive display."""

    MAX_PREVIEW_ROWS = 64

    def __init__(self):
        self._lock = threading.Lock()
        self._dfs: Dict[str, dict] = {}
        self._next = 0

    def register(self, df, name: Optional[str] = None,
                 max_rows: Optional[int] = None) -> str:
        # One execution of max_rows + 1 rows tells whether more exist,
        # without running the unlimited plan for a count.
        limit = self.MAX_PREVIEW_ROWS if max_rows is None else max_rows
        data = df.limit(limit + 1).to_pydict()
        fetched = len(next(iter(data.values()), []))
        truncated = fetched > limit
        if truncated:
            data = {k: v[:limit] for k, v in data.items()}
        with self._lock:
            self._next += 1
            df_id = f"df{self._next}"
            self._dfs[df_id] = {
                "id": df_id, "name": name or df_id, "data": data,
                "columns": list(data.keys()),
                "rows": None if truncated else fetched,
                "preview_rows": min(fetched, limit),
            }
        return df_id

    def listing(self) -> List[dict]:
        with self._lock:
            return [{"id": d["id"], "name": d["name"],
                     "rows": d["rows"] if d["rows"] is not None
                     else f"{d['preview_rows']}+",
                     "cols": len(d["columns"])} for d in self._dfs.values()]

    def get(self, df_id: str) -> Optional[dict]:
        with self._lock:
            return self._dfs.get(df_id)

    def cell(self, df_id: str, row: int, col: str) -> Optional[str]:
        d = self.get(df_id)
        if d is None or col not in d["data"]:
            return None
        vals = d["data"][col]
        if not (0 <= row < len(vals)):
            return None
        return str(vals[row])


def generate_interactive_html(entry: dict) -> str:
    """A registered DataFrame as a standalone table: a cell longer than
    ``_CELL_TRUNCATE`` characters is cut and carries ``data-row`` /
    ``data-col`` and the ``trunc`` class, without its full value."""
    cols = entry["columns"]
    data = entry["data"]
    n = entry["preview_rows"]
    head = "".join(f"<th>{_escape(c)}</th>" for c in cols)
    rows = []
    for i in range(n):
        tds = []
        for c in cols:
            v = "" if data[c][i] is None else str(data[c][i])
            if len(v) > _CELL_TRUNCATE:
                tds.append(
                    f'<td class="trunc" data-row="{i}" data-col="{_escape(c)}"'
                    f'>{_escape(v[:_CELL_TRUNCATE])}…</td>')
            else:
                tds.append(f"<td>{_escape(v)}</td>")
        rows.append("<tr>" + "".join(tds) + "</tr>")
    if entry["rows"] is None:
        more = "<p>… more rows (preview truncated)</p>"
    else:
        more = (f"<p>… {entry['rows'] - n} more rows</p>"
                if entry["rows"] > n else "")
    return (f"<h3>{_escape(entry['name'])}</h3>"
            f"<table><thead><tr>{head}</tr></thead>"
            f"<tbody>{''.join(rows)}</tbody></table>{more}")


def _escape(s: str) -> str:
    return html.escape(str(s), quote=True)
