"""IO of the port (port of ``daft_tpu/io``): the ``File`` runtime only. Scans,
writers and the object-store clients are ROADMAP A.8."""
