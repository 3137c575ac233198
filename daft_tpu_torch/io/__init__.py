"""IO of the port (port of ``daft_tpu/io``): local files. Scans
(``scan.py``, ``formats.py``, ``hive.py``, ``reads.py``), writers
(``writers.py``), the plugin surface (``source.py``, ``sink.py``,
``mock.py``), the IO accounting, retry and circuit breaking (``iostats.py``,
``retry.py``, ``circuit.py``), ``IOConfig`` (``config.py``) and the ``File``
runtime (``file.py``). The object-store and HTTP clients, the table formats
and the database sources are ROADMAP A.8."""
