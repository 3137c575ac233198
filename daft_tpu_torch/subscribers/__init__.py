"""Subscribers (port of ``daft_tpu/subscribers/``): the engine events and the
``Subscriber`` base (``events.py``), the JSONL event log (``event_log.py``)
and, in ``dashboard.py``, the dashboard's server as far as the front door
needs it (``POST /api/query``, ``/api/querylog``, ``/api/slo``,
``/api/admission``) and the DataFrame display that
``DataFrame._repr_html_`` renders. The dashboard's web app and its other
panels are ROADMAP A.8.6."""
