"""Measurement tools for the port's kernels; run as ``python3 -m``."""
