"""The Arrow Flight query front door (the query server of
``daft_tpu/distributed/flight.py``).

``do_get`` with a JSON ticket ``{"sql", "tenant", "timeout_s",
"priority"}`` streams the answer back as Arrow record batches: the bulk
twin of the dashboard's ``POST /api/query``. The query travels the
in-process path (``query_service.submit_query_arrow``: the front door, the
caches, the SLO plane), so a shed ticket fails with the engine's retry
semantics (``FlightUnavailableError``), an expired deadline with
``FlightTimedOutError``, a cancel with ``FlightCancelledError``, and every
outcome lands one flight record. A ticket that is not a JSON object, or
whose fields do not convert, is the client's error (``FlightServerError``
naming the bad ticket). The shuffle's Flight server and client are ROADMAP
A.8.5.
"""

from __future__ import annotations

import json
import threading

import pyarrow as pa
import pyarrow.flight as flight


class QueryFlightServer(flight.FlightServerBase):
    def do_get(self, context, ticket: flight.Ticket):
        from daft_tpu_torch import query_service
        from daft_tpu_torch.errors import (
            DaftAdmissionError,
            DaftCancelledError,
            DaftTimeoutError,
        )

        try:
            req = json.loads(ticket.ticket.decode() or "{}")
            if not isinstance(req, dict):
                raise ValueError("ticket must be a JSON object")
            # The conversions are part of the ticket's validation: a
            # malformed timeout_s is the client's error, not a fault.
            timeout_s = req.get("timeout_s")
            timeout_s = float(timeout_s) if timeout_s is not None else None
            priority = req.get("priority")
            priority = int(priority) if priority is not None else None
        except (ValueError, TypeError, UnicodeDecodeError) as e:
            raise flight.FlightServerError(f"bad query ticket: {e}")
        try:
            table = query_service.submit_query_arrow(
                req.get("sql"), tenant=req.get("tenant"), timeout_s=timeout_s,
                priority=priority)
        except DaftAdmissionError as e:
            # Transient by the engine's taxonomy: the client backs off
            # retry_after_s (in the message) and resubmits.
            raise flight.FlightUnavailableError(
                f"shed at admission (retry after "
                f"~{getattr(e, 'retry_after_s', 1.0):.2f}s): {e}")
        except DaftTimeoutError as e:
            raise flight.FlightTimedOutError(str(e))
        except DaftCancelledError as e:
            raise flight.FlightCancelledError(str(e))
        except Exception as e:  # noqa: BLE001 — one wire boundary
            raise flight.FlightServerError(f"query failed: {e}")
        return flight.RecordBatchStream(table)

    def list_flights(self, context, criteria):
        from daft_tpu_torch.query_service import get_table_registry

        for name in get_table_registry().names():
            descriptor = flight.FlightDescriptor.for_path(name)
            yield flight.FlightInfo(pa.schema([]), descriptor, [], -1, -1)

    @property
    def address(self) -> str:
        return f"grpc://localhost:{self.port}"


def start_query_server(port: int = 0) -> QueryFlightServer:
    """Start the Flight query front door on a daemon thread and return the
    server (``.address`` is the dial string; ``.shutdown()`` stops it)."""
    server = QueryFlightServer(f"grpc://0.0.0.0:{port}")
    thread = threading.Thread(target=server.serve, daemon=True, name="daft-query-flight")
    thread.start()
    return server
