"""Host kernels of the port (numpy), copied from ``daft_tpu/kernels``."""
