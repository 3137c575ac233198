"""Subscribers (port of ``daft_tpu/subscribers/``): only the DataFrame
display that ``DataFrame._repr_html_`` renders is ported; the dashboard's
server, state, assets and the event subscribers are ROADMAP A.8."""
