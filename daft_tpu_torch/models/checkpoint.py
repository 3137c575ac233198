"""Checkpoint reading (port of ``daft_tpu/models/checkpoint.py``).

``load_flat`` reads the three weight formats the JAX package's
``load_params`` reads into one flat dict, keyed by the ``/``-joined flax
state-dict keys (``params/vision/block_0/attn/qkv/kernel``):

* an ``.npz`` (numpy);
* any other file as a flax ``.msgpack`` (``flax.serialization``'s layout,
  read with ``msgpack``: ndarray, complex and numpy-scalar leaves, and the
  chunked arrays flax writes past its ``MAX_CHUNK_SIZE``);
* a directory with ``_METADATA`` as an orbax ``StandardCheckpointer``
  checkpoint, read with ``tensorstore`` (zarr or zarr3 arrays, in an
  ``ocdbt`` store or one directory each), which is what orbax reads with.

``msgpack`` and ``tensorstore`` are imported only by their reader. A
``bfloat16`` leaf comes back as the f32 array of the same values. Each model
module names its keys (``models/clip.py``, ``models/minilm.py``,
``models/lm.py``) and ``copy_flax_params`` copies them in, cast to each
parameter's dtype; ``models/convert.py`` converts local HF checkpoint
directories into the same keys.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterable, Optional, Sequence

import numpy as np
import torch
from torch import nn

from daft_tpu_torch.errors import DaftValueError

#: flax.serialization's msgpack extension codes.
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


def checkpoint_format(path: str) -> str:
    """``npz``, ``orbax`` or ``msgpack``: the reader the JAX package's
    ``load_params`` takes for ``path`` (a directory is orbax's, an ``.npz``
    numpy's, any other file flax's)."""
    if os.path.isdir(path):
        return "orbax"
    return "npz" if path.endswith(".npz") else "msgpack"


def load_flat(path: str, tree: Optional[Iterable[str]] = None) -> Dict[str, np.ndarray]:
    """Every array of the checkpoint at ``path`` by its flat flax key.

    ``tree`` is the flat keys of the model's JAX parameter tree. Where it is
    given, the file's keys are held to it as the JAX package's reader for
    the format holds them: ``flax.serialization.from_bytes`` raises when the
    file lacks a key of the tree and ignores the file's other keys; orbax's
    ``restore`` raises on either; the ``.npz`` reader keeps the model's value
    for a missing key and ignores the other keys."""
    path = os.path.abspath(path)
    fmt = checkpoint_format(path)
    flat = {"npz": load_npz, "msgpack": load_msgpack, "orbax": load_orbax}[fmt](path)
    if tree is not None and fmt != "npz":
        tree = set(tree)
        missing = sorted(tree - set(flat))
        extra = sorted(set(flat) - tree) if fmt == "orbax" else []
        if missing or extra:
            raise DaftValueError(
                f"{fmt} checkpoint {path!r} does not match the model's tree: "
                f"missing {missing[:5]}{' ...' if len(missing) > 5 else ''}, "
                f"unexpected {extra[:5]}{' ...' if len(extra) > 5 else ''}")
    return flat


def load_npz(path: str) -> Dict[str, np.ndarray]:
    """Every array of an ``.npz`` checkpoint by key."""
    if not path.endswith(".npz"):
        raise DaftValueError(f"not an .npz checkpoint: {path!r}")
    with np.load(os.path.abspath(path)) as f:
        return {k: f[k] for k in f.files}


def _f32_if_bf16(arr: np.ndarray) -> np.ndarray:
    return arr.astype(np.float32) if arr.dtype.name == "bfloat16" else arr


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    """flax's ``_ndarray_from_bytes``: ``(shape, dtype name, C-order bytes)``;
    bfloat16 bits widen to f32 by a shift, with no ``ml_dtypes``."""
    import msgpack

    shape, name, buf = msgpack.unpackb(data, raw=True)
    name = name.decode()
    if name == "bfloat16":
        bits = np.frombuffer(buf, dtype=np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    try:
        dtype = np.dtype(name)
    except TypeError as e:
        raise DaftValueError(f"msgpack checkpoint leaf of unsupported dtype {name!r}") from e
    return np.frombuffer(buf, dtype=dtype).reshape(shape)


def _ext_hook(code: int, data: bytes) -> Any:
    import msgpack

    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == _EXT_COMPLEX:
        real, imag = msgpack.unpackb(data)
        return np.asarray(complex(real, imag))
    if code == _EXT_NPSCALAR:
        return _ndarray_from_bytes(data)
    raise DaftValueError(f"msgpack checkpoint holds an unknown extension type {code}")


def _flatten(node: Any, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(node, dict) and node.get(_CHUNKED) is True:
        shape = tuple(node["shape"][str(i)] for i in range(len(node["shape"])))
        chunks = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
        out[prefix] = np.concatenate(chunks).reshape(shape)
    elif isinstance(node, dict):
        for k, v in node.items():
            _flatten(v, f"{prefix}/{k}" if prefix else str(k), out)
    else:
        out[prefix] = np.asarray(node)


def load_msgpack(path: str) -> Dict[str, np.ndarray]:
    """Every leaf of a flax ``.msgpack`` file (``flax.serialization.to_bytes``)
    by its flat key."""
    import msgpack

    with open(path, "rb") as f:
        try:
            tree = msgpack.unpackb(f.read(), ext_hook=_ext_hook, raw=False)
        except (msgpack.UnpackException, ValueError) as e:
            raise DaftValueError(f"cannot read {path!r} as a flax .msgpack: {e}") from e
    out: Dict[str, np.ndarray] = {}
    _flatten(tree, "", out)
    return out


def load_orbax(path: str) -> Dict[str, np.ndarray]:
    """Every array of an orbax ``StandardCheckpointer`` directory by its flat
    key: each entry of ``_METADATA``'s ``tree_metadata`` names its keys, and
    the array lies at their ``.``-joined path, read with ``tensorstore``."""
    meta_path = os.path.join(path, "_METADATA")
    if not os.path.isfile(meta_path):
        raise DaftValueError(f"{path!r} is not an orbax checkpoint directory (no _METADATA)")
    try:
        import tensorstore as ts
    except ImportError as e:
        raise ImportError(
            "reading an orbax checkpoint directory needs the tensorstore package") from e
    with open(meta_path) as f:
        meta = json.load(f)
    driver = "zarr3" if meta.get("use_zarr3") else "zarr"
    out: Dict[str, np.ndarray] = {}
    for entry in meta["tree_metadata"].values():
        value = entry.get("value_metadata", {})
        if value.get("skip_deserialize"):
            continue
        if value.get("value_type") not in ("np.ndarray", "jax.Array", "scalar"):
            raise DaftValueError(
                f"orbax checkpoint {path!r} holds a leaf of type {value.get('value_type')!r}")
        keys = [str(k["key"]) for k in entry["key_metadata"]]
        name = ".".join(keys)
        kvstore = ({"driver": "ocdbt", "base": f"file://{path}", "path": name}
                   if meta.get("use_ocdbt", True)
                   else {"driver": "file", "path": os.path.join(path, name)})
        arr = ts.open({"driver": driver, "kvstore": kvstore}, open=True, read=True).result()
        out["/".join(keys)] = _f32_if_bf16(np.asarray(arr.read().result()))
    return out


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
