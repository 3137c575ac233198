"""Subscribers (port of ``daft_tpu/subscribers/``): the engine events and the
``Subscriber`` base (``events.py``), the JSONL event log (``event_log.py``)
and the DataFrame display that ``DataFrame._repr_html_`` renders
(``dashboard.py``). The dashboard's server, state and assets are ROADMAP
A.8."""
