"""Checkpoint reading (port of ``daft_tpu/models/checkpoint.py``).

Reads the ``.npz`` layout that ``daft_tpu/models/checkpoint.py::_load_flax_file``
reads: one array per parameter under its ``/``-joined flax state-dict key
(``params/vision/block_0/attn/qkv/kernel``). numpy only; the model modules map
the keys onto their parameters (``models/clip.py::load_flax_params``). Not
ported yet: flax ``.msgpack`` files and orbax checkpoint directories.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from daft_tpu_torch.errors import DaftValueError


def load_npz(path: str) -> Dict[str, np.ndarray]:
    """Every array of an ``.npz`` checkpoint by key."""
    if not path.endswith(".npz"):
        raise DaftValueError(f"only .npz checkpoints are supported, got {path!r}")
    with np.load(os.path.abspath(path)) as f:
        return {k: f[k] for k in f.files}
