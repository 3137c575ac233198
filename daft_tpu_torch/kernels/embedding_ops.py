"""Embedding kernels (port of ``daft_tpu/kernels/embedding_ops.py``; reference:
distance functions in src/daft-functions/src/distance).

Embeddings are dense fixed-width columns, so these run on the device through
the relational layer: one torch function per kernel, in f32. The host
implementation runs the same function on CPU tensors and casts up to the
resolved f64, with the any-input-null rule (``torch_same_rules``).
"""

from __future__ import annotations

import numpy as np
import torch

from daft_tpu_torch.datatype import DataType
from daft_tpu_torch.errors import DaftTypeError
from daft_tpu_torch.kernels.registry import register_kernel
from daft_tpu_torch.schema import Field
from daft_tpu_torch.series import Series


def _f64(fields, kwargs):
    return Field(fields[0].name, DataType.float64())


def _emb_pair(args):
    a, b = args[0], args[1]
    if not (a.dtype.is_device_representable() and a.dtype.shape):
        raise DaftTypeError(f"Expected embedding-like column, got {a.dtype!r}")
    av, am = a.to_numpy_masked()
    if len(b) == 1 and len(a) != 1:
        bv = np.broadcast_to(b.to_numpy()[0], av.shape)
        bm = None
    else:
        bv, bm = b.to_numpy_masked()
    mask = am if bm is None else (am | bm if am is not None else bm)
    return torch.from_numpy(np.array(av)), torch.from_numpy(np.array(bv)), mask


def cosine_distance(a, b):
    a = a.float()
    b = b.float()
    num = (a * b).sum(-1)
    den = torch.linalg.vector_norm(a, dim=-1) * torch.linalg.vector_norm(b, dim=-1)
    return 1.0 - num / torch.where(den == 0, 1.0, den)


def dot(a, b):
    return (a.float() * b.float()).sum(-1)


def l2_distance(a, b):
    d = a.float() - b.float()
    return torch.sqrt((d * d).sum(-1))


def l2_normalize(a):
    a = a.float()
    n = torch.linalg.vector_norm(a, dim=-1, keepdim=True)
    return a / torch.where(n == 0, 1.0, n)


def _distance_kernel(name, fn):
    @register_kernel(name, _f64, torch_fn=lambda args, **kw: fn(args[0], args[1]),
                     torch_same_rules=True)
    def host(args, **kwargs):
        av, bv, mask = _emb_pair(args)
        out = fn(av, bv).numpy().astype(np.float64)
        return Series.from_numpy(out, args[0].name)._with_mask(mask)

    return host


_distance_kernel("cosine_distance", cosine_distance)
_distance_kernel("embedding_dot", dot)
_distance_kernel("l2_distance", l2_distance)


@register_kernel("l2_normalize",
                 lambda f, k: Field(f[0].name, DataType.embedding(DataType.float32(), f[0].dtype.shape[0])),
                 torch_fn=lambda args, **kw: l2_normalize(args[0]),
                 torch_same_rules=True)
def _l2_normalize(args, **kwargs):
    s = args[0]
    vals, mask = s.to_numpy_masked()
    out = l2_normalize(torch.from_numpy(np.array(vals))).numpy()
    dt = DataType.embedding(DataType.float32(), out.shape[1])
    return Series.from_numpy(out, s.name, dt)._with_mask(mask)
