"""Checkpoint reading (port of ``daft_tpu/models/checkpoint.py``).

Reads the ``.npz`` layout that ``daft_tpu/models/checkpoint.py::_load_flax_file``
reads: one array per parameter under its ``/``-joined flax state-dict key
(``params/vision/block_0/attn/qkv/kernel``). numpy only; each model module
names its keys (``models/clip.py``, ``models/minilm.py``) and
``copy_flax_params`` copies them in; ``models/convert.py`` converts local HF
checkpoint directories into the same keys. Not ported yet: flax
``.msgpack`` files and orbax checkpoint directories (ROADMAP Queue A, item
A.2).
"""

from __future__ import annotations

import os
from typing import Dict, Sequence

import numpy as np
import torch
from torch import nn

from daft_tpu_torch.errors import DaftValueError


def load_npz(path: str) -> Dict[str, np.ndarray]:
    """Every array of an ``.npz`` checkpoint by key."""
    if not path.endswith(".npz"):
        raise DaftValueError(f"only .npz checkpoints are supported, got {path!r}")
    with np.load(os.path.abspath(path)) as f:
        return {k: f[k] for k in f.files}


@torch.no_grad()
def copy_flax_params(module: nn.Module, flat: Dict[str, np.ndarray],
                     names: Dict[str, tuple], prefixes: Sequence[str], what: str) -> list:
    """Copy a flat flax state dict into ``module``. Each key loses the first
    of ``prefixes`` it starts with, then ``names`` maps it to (torch
    parameter name, how): ``same`` copies the array, ``dense`` transposes a
    Dense kernel (in, out) onto a Linear weight (out, in), ``conv`` flattens a
    conv kernel (p, p, 3, w) onto a patchify weight (w, p*p*3). Keys ``names``
    lacks are ignored and parameters the dict lacks keep their values, as the
    JAX loader does. Each array is cast to its parameter's dtype. Returns the
    torch names loaded; raises if none matched or a shape disagrees."""
    params = dict(module.named_parameters())
    loaded = []
    for key, arr in flat.items():
        for prefix in prefixes:
            if key.startswith(prefix):
                key = key[len(prefix):]
                break
        if key not in names:
            continue
        tname, how = names[key]
        a = np.asarray(arr, dtype=np.float32)
        if how == "dense":
            a = a.T
        elif how == "conv":
            a = a.reshape(-1, a.shape[-1]).T
        target = params[tname]
        if tuple(a.shape) != tuple(target.shape):
            raise DaftValueError(
                f"checkpoint {key!r} has shape {a.shape} for {tname} {tuple(target.shape)}")
        target.copy_(torch.tensor(a, dtype=target.dtype))
        loaded.append(tname)
    if not loaded:
        raise DaftValueError(f"no {what} parameter found in the checkpoint")
    return loaded
