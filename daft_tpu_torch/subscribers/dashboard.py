"""The dashboard's server as far as the front door needs it, and the
interactive DataFrame display (port of parts of
``daft_tpu/subscribers/dashboard.py``; reference: src/daft-dashboard).

:class:`DashboardServer` (a stdlib ``ThreadingHTTPServer`` on 127.0.0.1)
serves the network front door and the planes behind it:

* ``POST /api/query``: SQL over the registered tables through
  ``query_service.submit_query`` (400 on a malformed body or field, 429
  with ``Retry-After`` for a shed, 504 for an expired deadline, 499 for a
  cancel, 500 for an engine fault);
* ``GET /api/querylog`` (the flight recorder's ring, ``?n=&tenant=&outcome=``),
  ``/api/slo`` (the SLO tracker's tenants and armed fingerprints; ``views``
  is ``[]`` until the streaming views, ROADMAP A.8.6), ``/api/admission``
  (per-tenant admission rows and the controller's totals) and
  ``/api/health``.

Every other route of the JAX package's dashboard (the web app and its
assets, ``/api/queries``, ``/metrics``, ``/api/engine``, the DataFrame
previews, the cache, memory, views, planner, perf and fleet panels) answers
501 with a JSON body naming ROADMAP A.8.6. :class:`DashboardState` keeps
what those routes read: the bounded per-query store fed by ``QueryStart`` /
``QueryEnd`` / ``OperatorStats`` and the admission events' per-tenant
tallies. ``DataFrameDisplay`` keeps the previews of registered DataFrames
and ``generate_interactive_html`` renders one as a standalone HTML table
whose long cells are cut and marked for expansion.
"""

from __future__ import annotations

import html
import json
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

from daft_tpu_torch.subscribers.events import (
    Event,
    OperatorStats,
    QueryAdmitted,
    QueryEnd,
    QueryQueued,
    QueryShed,
    QueryStart,
    Subscriber,
)

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


class DashboardState:
    """What the front door's routes read: a bounded per-query store and the
    admission events' per-tenant tallies."""

    #: Bounded per-query store: an always-on serving process sees millions
    #: of queries. The oldest finished queries are evicted past this, their
    #: share of the summary kept in cumulative tallies; the flight
    #: recorder's ring (/api/querylog) stays the per-query history.
    MAX_QUERIES = 512

    def __init__(self):
        self._lock = threading.Lock()
        self.queries: Dict[str, dict] = {}
        self._evicted = {"queries": 0, "failed": 0, "rows": 0}
        # Per-tenant event history (admits, sheds, waits); the live queue
        # and slot numbers come from the controller in admission_rows().
        self.admission: Dict[str, dict] = {}

    def _tenant_row(self, tenant: str) -> dict:
        return self.admission.setdefault(tenant, {
            "tenant": tenant, "admitted": 0, "queued_events": 0, "shed": 0,
            "shed_by_reason": {}, "last_wait_s": 0.0, "max_wait_s": 0.0,
            "last_shed_level": 0})

    def on_event(self, e: Event) -> None:
        with self._lock:
            if isinstance(e, QueryQueued):
                self._tenant_row(e.tenant)["queued_events"] += 1
            elif isinstance(e, QueryAdmitted):
                row = self._tenant_row(e.tenant)
                row["admitted"] += 1
                row["last_wait_s"] = e.wait_s
                row["max_wait_s"] = max(row["max_wait_s"], e.wait_s)
                row["last_shed_level"] = e.shed_level
            elif isinstance(e, QueryShed):
                row = self._tenant_row(e.tenant)
                row["shed"] += 1
                row["shed_by_reason"][e.reason] = row["shed_by_reason"].get(e.reason, 0) + 1
            elif isinstance(e, QueryStart):
                if len(self.queries) >= self.MAX_QUERIES:
                    self._evict_locked()
                self.queries[e.query_id] = {
                    "query_id": e.query_id, "status": "running", "plan": e.plan,
                    "start": time.time(), "duration_s": None, "operators": {}}
            elif isinstance(e, QueryEnd):
                q = self.queries.get(e.query_id)
                if q:
                    q["status"] = "error" if e.error else "done"
                    q["duration_s"] = e.duration_s
                    q["error"] = e.error
            elif isinstance(e, OperatorStats):
                q = self.queries.get(e.query_id)
                if q:
                    op = q["operators"].setdefault(e.operator, {
                        "operator": e.operator, "batches": 0, "rows_in": 0,
                        "rows_out": 0, "cpu_us": 0})
                    op["batches"] += 1
                    op["rows_in"] += e.rows_in
                    op["rows_out"] += e.rows_out
                    op["cpu_us"] += e.cpu_us

    def _evict_locked(self) -> None:
        """Drop the oldest finished queries until under the bound, folding
        them into the cumulative tallies; running queries stay (admission
        bounds how many there are)."""
        for qid in list(self.queries):
            if len(self.queries) < self.MAX_QUERIES:
                break
            q = self.queries[qid]
            if q["status"] == "running":
                continue
            self._evicted["queries"] += 1
            if q["status"] == "error":
                self._evicted["failed"] += 1
            self._evicted["rows"] += sum(op["rows_out"] for op in q["operators"].values())
            del self.queries[qid]

    def query_detail(self, query_id: str) -> Optional[dict]:
        with self._lock:
            q = self.queries.get(query_id)
            if q is None:
                return None
            out = dict(q)
            out["operators"] = sorted(q["operators"].values(), key=lambda o: -o["cpu_us"])
            return out

    def admission_rows(self) -> List[dict]:
        """Per-tenant admission table: the event history merged with the
        controller's live queue and slot state."""
        from daft_tpu_torch.execution.admission import get_controller

        live = get_controller().snapshot()
        with self._lock:
            rows = []
            for t in sorted(set(self.admission) | set(live)):
                row = dict(self._tenant_row(t))
                row["shed_by_reason"] = dict(row["shed_by_reason"])
                row.update(live.get(t, {"running": 0, "queued": 0, "mem_reserved": 0}))
                rows.append(row)
        return rows

    def engine_summary(self) -> dict:
        """The query store's process-lifetime tallies (evicted queries
        included). The JAX package's summary also reads the spill, device,
        compile-cache, shuffle and IO counters for its ``/api/engine``
        route, which is ROADMAP A.8.6."""
        with self._lock:
            return {
                "queries_total": len(self.queries) + self._evicted["queries"],
                "queries_running": sum(1 for q in self.queries.values()
                                       if q["status"] == "running"),
                "queries_failed": sum(1 for q in self.queries.values()
                                      if q["status"] == "error") + self._evicted["failed"],
                "rows_processed": sum(op["rows_out"] for q in self.queries.values()
                                      for op in q["operators"].values())
                + self._evicted["rows"],
            }


class DashboardSubscriber(Subscriber):
    def __init__(self, state: DashboardState):
        self.state = state

    def on_event(self, event: Event) -> None:
        self.state.on_event(event)


#: The body of every route of the JAX package's dashboard the port does not
#: serve yet.
_NOT_PORTED_BODY = {"error": "not ported to daft_tpu_torch yet: the dashboard's web app "
                             "and its other panels are ROADMAP A.8.6",
                    "kind": "NotImplemented"}


class _Handler(BaseHTTPRequestHandler):
    state: DashboardState = None  # type: ignore[assignment]

    def log_message(self, *args):  # quiet
        pass

    def do_GET(self):
        parsed = urllib.parse.urlsplit(self.path)
        path = parsed.path
        if path == "/api/querylog":
            # The flight recorder's ring, filterable by tenant and outcome.
            from daft_tpu_torch.querylog import get_recorder

            q = urllib.parse.parse_qs(parsed.query)
            try:
                n = int(q.get("n", ["200"])[0])
            except ValueError:
                self.send_error(400)
                return
            rec = get_recorder()
            self._send_json(200, {
                "records": rec.recent(n=n, tenant=q.get("tenant", [None])[0],
                                      outcome=q.get("outcome", [None])[0]),
                "stats": rec.stats()})
        elif path == "/api/slo":
            from daft_tpu_torch import slo

            tracker = slo.get_tracker()
            self._send_json(200, {"tenants": tracker.snapshot(),
                                  "autoprofile": tracker.autoprofile_state(),
                                  # The views' freshness: ROADMAP A.8.6.
                                  "views": []})
        elif path == "/api/admission":
            from daft_tpu_torch.execution.admission import get_controller

            self._send_json(200, {"tenants": self.state.admission_rows(),
                                  "totals": get_controller().totals()})
        elif path == "/api/health":
            self._send_json(200, {"status": "ok"})
        else:
            self._send_json(501, dict(_NOT_PORTED_BODY, path=path))

    def do_POST(self):
        """``POST /api/query`` with JSON ``{"sql", "tenant", "timeout_s",
        "priority", "max_rows"}``: the query travels the path of an
        in-process collect, so a shed request is a 429 with ``Retry-After``
        and a real ``shed`` record, an expired deadline a 504 with a real
        ``timeout`` one."""
        parsed = urllib.parse.urlsplit(self.path)
        if parsed.path != "/api/query":
            self._send_json(501, dict(_NOT_PORTED_BODY, path=parsed.path))
            return
        from daft_tpu_torch import query_service

        try:
            length = int(self.headers.get("Content-Length", "0"))
            req = json.loads(self.rfile.read(length) or b"{}")
            if not isinstance(req, dict):
                raise ValueError("request body must be a JSON object")
            # The fields' conversions are client input errors: a timeout_s
            # of "abc" answers 400, not a 500 engine fault.
            timeout_s = req.get("timeout_s")
            timeout_s = float(timeout_s) if timeout_s is not None else None
            priority = req.get("priority")
            priority = int(priority) if priority is not None else None
            max_rows = req.get("max_rows")
            max_rows = int(max_rows) if max_rows is not None else None
        except (ValueError, TypeError) as e:
            self._send_json(400, {"error": f"bad request body: {e}", "kind": "BadRequest"})
            return
        try:
            result = query_service.submit_query(
                req.get("sql"), tenant=req.get("tenant"), timeout_s=timeout_s,
                priority=priority, max_rows=max_rows)
        except BaseException as e:  # noqa: BLE001 — mapped to a status, never a dropped socket
            status, payload = query_service.error_response(e)
            headers = {}
            if status == 429 and payload.get("retry_after_s"):
                headers["Retry-After"] = str(max(int(payload["retry_after_s"] + 0.5), 1))
            self._send_json(status, payload, headers)
            return
        self._send_json(200, result)

    def _send_json(self, status: int, payload: dict, headers: Optional[dict] = None) -> None:
        body = json.dumps(payload, default=str).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)


class DashboardServer:
    """The dashboard's HTTP server on 127.0.0.1 (``port=0``: any free
    port). Each request runs on a thread of its own."""

    def __init__(self, port: int = 0):
        self.state = DashboardState()
        handler = type("Handler", (_Handler,), {"state": self.state})
        self._server = ThreadingHTTPServer(("127.0.0.1", port), handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True,
                                        name="daft-dashboard")

    def start(self) -> "DashboardServer":
        self._thread.start()
        return self

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def subscriber(self) -> DashboardSubscriber:
        return DashboardSubscriber(self.state)

    def register_table(self, name: str, df) -> None:
        """Serve ``df`` as SQL table ``name`` through ``POST /api/query``
        (the process's registry: the Flight front door sees it too)."""
        from daft_tpu_torch.query_service import register_table

        register_table(name, df)

    def shutdown(self) -> None:
        """Stop serving, close the socket and join the server's thread."""
        if self._thread.is_alive():
            # shutdown() waits for serve_forever to return: only a started
            # server has one to wait for.
            self._server.shutdown()
            self._thread.join(timeout=10)
        self._server.server_close()


def launch(port: int = 8238, attach: bool = True) -> DashboardServer:
    """Start the dashboard and attach its subscriber to the context."""
    server = DashboardServer(port).start()
    if attach:
        from daft_tpu_torch.context import get_context

        get_context().attach_subscriber(server.subscriber())
    return server
