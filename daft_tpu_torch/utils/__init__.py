"""Pure-Python utilities of the port, copied from ``daft_tpu/utils``."""
