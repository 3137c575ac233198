"""Kernels of the port: host implementations (numpy / pyarrow), copied from
``daft_tpu/kernels``, and the torch lowerings the relational device layer
(``ops/device_eval.py``, ``ops/compiled_eval.py``) runs on the device."""
