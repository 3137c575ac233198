"""The port's type system (``daft_tpu_torch/datatype.py``, ``schema.py``)
against the JAX package's, on the CPU.

Mirrors ``tests/test_datatypes.py`` case for case: each case runs in both
packages and must give the JAX package's answers (the Arrow types, the
reprs, the shapes and the errors) and the value that the JAX test asserts.
Left out: ``DataType.to_jax`` (``test_datatypes.py:24-33``); the embedding
case keeps its other checks.
"""

import numpy as np
import pyarrow as pa
import pytest

import daft_tpu.datatype
import daft_tpu.schema
import daft_tpu_torch.datatype
import daft_tpu_torch.schema

PKGS = ((daft_tpu.datatype, daft_tpu.schema), (daft_tpu_torch.datatype, daft_tpu_torch.schema))


def _both(build):
    """``build(datatype module, schema module)`` in the port, held equal to
    the JAX package's."""
    jax, port = (build(d, s) for d, s in PKGS)
    assert port == jax
    return port


def test_simple_roundtrip():
    def run(d, s):
        D = d.DataType
        types = [D.int64(), D.float32(), D.bool(), D.string(), D.binary(), D.date()]
        return [(str(t.to_arrow()), D.from_arrow(t.to_arrow()) == t) for t in types]

    assert all(ok for _, ok in _both(run))


def test_nested_types():
    def run(d, s):
        D = d.DataType
        lst = D.list(D.int32())
        st = D.struct({"a": D.int64(), "b": D.string()})
        return (lst.inner == D.int32(), st.fields["a"] == D.int64(),
                D.from_arrow(st.to_arrow()) == st, str(st.to_arrow()), repr(st))

    assert _both(run)[:3] == (True, True, True)


def test_embedding():
    def run(d, s):
        emb = d.DataType.embedding(d.DataType.float32(), 768)
        return emb.size, emb.shape, emb.is_device_representable(), str(emb.to_arrow())

    assert _both(run)[:3] == (768, (768,), True)


def test_image_types():
    def run(d, s):
        D = d.DataType
        img = D.image("RGB")
        fixed = D.image("RGB", 224, 224)
        with pytest.raises(Exception) as e:
            D.image(height=3)
        return (img.image_mode == d.ImageMode.RGB, fixed.shape,
                fixed.is_device_representable(), type(e.value).__name__, str(e.value))

    assert _both(run)[:3] == (True, (224, 224, 3), True)


def test_tensor():
    def run(d, s):
        D = d.DataType
        t = D.tensor(D.float32(), (3, 4))
        return t.shape, D.tensor(D.float32()).is_device_representable(), repr(t)

    assert _both(run)[:2] == ((3, 4), False)


def test_bfloat16():
    def run(d, s):
        bf = d.DataType.bfloat16()
        return bf.is_floating(), bf.to_arrow() == pa.binary(2), bf.is_device_representable()

    assert _both(run) == (True, True, True)


def test_unify():
    def run(d, s):
        D, u = d.DataType, d.unify_dtypes
        return [u(D.int32(), D.int64()) == D.int64(), u(D.int64(), D.float32()) == D.float64(),
                u(D.null(), D.string()) == D.string(), u(D.float32(), D.float32()) == D.float32()]

    assert _both(run) == [True] * 4


def test_schema():
    def run(d, s):
        D = d.DataType
        sc = s.Schema.from_pydict({"a": D.int64(), "b": D.string()})
        with pytest.raises(Exception) as e:
            s.Schema([s.Field("x", D.int64()), s.Field("x", D.int64())])
        return (sc.column_names(), sc["a"].dtype == D.int64(), sc.exclude(["a"]).column_names(),
                str(sc.to_arrow()), type(e.value).__name__, str(e.value))

    assert _both(run)[:3] == (["a", "b"], True, ["b"])


def test_infer_from_py():
    def run(d, s):
        D = d.DataType
        arr = np.zeros((3, 4), dtype=np.float32)
        return [D.infer_from_py(1) == D.int64(), D.infer_from_py(1.0) == D.float64(),
                D.infer_from_py("x") == D.string(),
                D.infer_from_py([1, 2]) == D.list(D.int64()),
                D.infer_from_py(arr) == D.tensor(D.float32(), (3, 4)),
                [repr(D.infer_from_py(v)) for v in (1, 1.0, "x", [1, 2], arr, True, b"b")]]

    assert _both(run)[:5] == [True] * 5
