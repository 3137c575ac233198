"""Runners (port of ``daft_tpu/runners/``): the native runner drives every
query; the distributed runner is ROADMAP A.8.5."""
