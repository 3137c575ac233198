"""The port's image path (daft_tpu_torch: io/file.py, kernels/image_ops.py,
kernels/file_ops.py, the ``.image`` namespace, the image free functions and
functions/media.py) against the JAX package's, on the CPU.

The same numpy-seeded images, encoded by PIL, go through ``daft_tpu`` and
through ``daft_tpu_torch`` with ``execution_config.device = "cpu"``. Every
host kernel (decode, encode, crop, to_mode, the attributes, to_tensor, the
eight hashes, the variable-shape PIL resize) and every file function must be
bit-equal, with the same resolved dtype. The fixed-shape resize runs as two
f32 weight-matrix contractions in the port and as ``jax.image.resize`` in the
JAX package: uint8 results may differ by one level on under 1 % of values
(f32 contractions in another order, then a rounding), f32 results are held
at rtol 1e-5 / atol 1e-3.
"""

import contextlib
import io
import os

import numpy as np
import pyarrow as pa
import pytest
import torch
import torch.nn.functional as F
from PIL import Image

import daft_tpu
import daft_tpu.functions as jfn
import daft_tpu.functions.media as jmedia
import daft_tpu_torch
import daft_tpu_torch.functions as tfn
import daft_tpu_torch.functions.media as tmedia
from daft_tpu.expressions.expression import ImageNamespace as JaxImageNamespace
from daft_tpu.io.file import File as JaxFile
from daft_tpu.io.file import file_series as jax_file_series
from daft_tpu.kernels.image_ops import _batch_resize_jax
from daft_tpu.kernels.registry import get_kernel as jax_get_kernel
from daft_tpu_torch.errors import DaftValueError
from daft_tpu_torch.expressions.expression import ImageNamespace as TorchImageNamespace
from daft_tpu_torch.io.file import File, file_series
from daft_tpu_torch.kernels import image_ops
from daft_tpu_torch.kernels.registry import get_kernel, has_kernel

PKGS = (daft_tpu, daft_tpu_torch)
FUNCS = {daft_tpu: jfn, daft_tpu_torch: tfn}
MEDIA = {daft_tpu: jmedia, daft_tpu_torch: tmedia}
UINT8_MAX_OFF = 1         # levels
UINT8_OFF_SHARE = 0.01    # of values
F32_RTOL, F32_ATOL = 1e-5, 1e-3
HASH_METHODS = ("phash", "phash_simple", "dhash", "dhash_vertical", "ahash", "whash",
                "crop_resistant", "colorhash")


def _ctx(pkg):
    if pkg is daft_tpu_torch:
        return daft_tpu_torch.execution_config_ctx(device="cpu")
    return contextlib.nullcontext()


def _norm(v):
    """A value both packages' results can be compared by: arrays by dtype,
    shape and bytes, File handles by their Arrow row."""
    if isinstance(v, np.ndarray):
        return ("ndarray", v.dtype.str, v.shape, v.tobytes())
    if hasattr(v, "to_row"):
        return ("File", v.to_row())
    if isinstance(v, dict):
        return {k: _norm(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_norm(x) for x in v]
    return v


def _run(pkg, data: dict, make_expr):
    """``make_expr(pkg)`` over ``data`` through the engine: (resolved dtype,
    the output column)."""
    cols = {k: (v(pkg) if callable(v) else v) for k, v in data.items()}
    df = pkg.from_pydict(cols).with_column("out", make_expr(pkg))
    with _ctx(pkg):
        return repr(df.schema["out"].dtype), df.to_pydict()["out"]


def _both_equal(data: dict, make_expr):
    (jdt, jout), (tdt, tout) = (_run(pkg, data, make_expr) for pkg in PKGS)
    assert tdt == jdt
    assert _norm(tout) == _norm(jout)
    return tout


def _picture(rng, h: int, w: int, channels: int) -> np.ndarray:
    """Smooth gradients plus noise, so JPEG and the hashes see structure."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([(xx * (c + 1) * 255 / max(w, 1) + yy * 255 / max(h, 1)) % 256
                     for c in range(channels)], axis=-1)
    return np.clip(base + rng.normal(0, 12, base.shape), 0, 255).astype(np.uint8)


def _encode(arr: np.ndarray, fmt: str, mode=None) -> bytes:
    img = Image.fromarray(arr.squeeze(-1) if arr.shape[-1] == 1 else arr)
    if mode is not None:
        img = img.convert(mode)
    buf = io.BytesIO()
    img.save(buf, format=fmt)
    return buf.getvalue()


def _encoded(seed: int = 0) -> list:
    """Mixed sizes and modes: JPEG RGB and L, PNG L / LA / RGB / RGBA and a
    palette PNG (mode P: decoded as RGB without a mode)."""
    rng = np.random.default_rng(seed)
    out = []
    for i, (h, w) in enumerate([(20, 31), (33, 17), (24, 24), (40, 29), (18, 45), (27, 27),
                                (31, 22)]):
        kind = i % 7
        if kind == 0:
            out.append(_encode(_picture(rng, h, w, 3), "JPEG"))
        elif kind == 1:
            out.append(_encode(_picture(rng, h, w, 1), "JPEG"))
        elif kind == 2:
            out.append(_encode(_picture(rng, h, w, 1), "PNG"))
        elif kind == 3:
            out.append(_encode(_picture(rng, h, w, 2), "PNG"))
        elif kind == 4:
            out.append(_encode(_picture(rng, h, w, 3), "PNG"))
        elif kind == 5:
            out.append(_encode(_picture(rng, h, w, 4), "PNG"))
        else:
            out.append(_encode(_picture(rng, h, w, 3), "PNG", mode="P"))
    return out


ENCODED = _encoded()
CORRUPT = b"\xff\xd8\xff not a jpeg"


def _bytes_col(with_bad: bool = True) -> dict:
    return {"b": ENCODED + ([None, CORRUPT] if with_bad else [])}


def _decoded(mode=None):
    return lambda pkg: pkg.col("b").image.decode(on_error="null", mode=mode)


def _fixed(pkg, mode: str = "RGB", h: int = 24, w: int = 20, n: int = 5, seed: int = 3,
           null_rows=()):
    """A FixedShapeImage column of ``n`` seeded rows, ``null_rows`` null."""
    m = pkg.ImageMode.from_str(mode)
    rng = np.random.default_rng(seed)
    rows = [None if i in null_rows else _picture(rng, h, w, m.num_channels)
            for i in range(n)]
    return pkg.Series.from_pylist(rows, "img", pkg.DataType.image(mode, h, w))


# -- decode -----------------------------------------------------------------
@pytest.mark.parametrize("mode", [None, "L", "LA", "RGB", "RGBA"])
def test_decode_null_on_error(mode):
    out = _both_equal(_bytes_col(), _decoded(mode))
    assert out[-2] is None and out[-1] is None
    assert all(v is not None for v in out[:-2])


@pytest.mark.parametrize("mode", [None, "RGB"])
def test_decode_raise_on_error(mode):
    make = lambda pkg: pkg.col("b").image.decode(on_error="raise", mode=mode)  # noqa: E731
    _both_equal(_bytes_col(with_bad=False), make)
    for pkg in PKGS:
        with pytest.raises(Exception, match="cannot identify image file"):
            _run(pkg, {"b": ENCODED[:2] + [CORRUPT]}, make)


# -- host kernels on decoded (variable-shape) and fixed-shape columns ---------
@pytest.mark.parametrize("fmt", ["png", "jpeg"])
@pytest.mark.parametrize("source", ["variable", "fixed"])
def test_encode(fmt, source):
    if source == "variable":
        _both_equal(_bytes_col(), lambda pkg: _decoded("RGB")(pkg).image.encode(fmt))
    else:
        _both_equal({"img": lambda pkg: _fixed(pkg, null_rows=(2,))},
                    lambda pkg: pkg.col("img").image.encode(fmt))


@pytest.mark.parametrize("bbox", [(0, 0, 8, 8), (3, 5, 10, 7), (10, 10, 100, 100)])
@pytest.mark.parametrize("source", ["variable", "fixed"])
def test_crop(bbox, source):
    if source == "variable":
        _both_equal(_bytes_col(), lambda pkg: _decoded()(pkg).image.crop(bbox))
    else:
        _both_equal({"img": lambda pkg: _fixed(pkg, "RGBA", null_rows=(0,))},
                    lambda pkg: pkg.col("img").image.crop(bbox))


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
@pytest.mark.parametrize("source", ["variable", "fixed"])
def test_to_mode(mode, source):
    if source == "variable":
        _both_equal(_bytes_col(), lambda pkg: _decoded()(pkg).image.to_mode(mode))
    else:
        _both_equal({"img": lambda pkg: _fixed(pkg, "RGB", null_rows=(1,))},
                    lambda pkg: pkg.col("img").image.to_mode(mode))


@pytest.mark.parametrize("name", ["width", "height", "channel", "mode"])
@pytest.mark.parametrize("source", ["variable", "fixed"])
def test_attributes(name, source):
    def make(pkg):
        img = _decoded()(pkg) if source == "variable" else pkg.col("img")
        return getattr(img.image, name)()

    data = _bytes_col() if source == "variable" else {
        "img": lambda pkg: _fixed(pkg, "LA", null_rows=(3,))}
    out = _both_equal(data, make)
    by_attribute = _both_equal(data, lambda pkg: (
        _decoded()(pkg) if source == "variable" else pkg.col("img")).image.attribute(name))
    assert _norm(by_attribute) == _norm(out)


@pytest.mark.parametrize("source", ["variable", "fixed"])
def test_to_tensor(source):
    if source == "variable":
        _both_equal(_bytes_col(), lambda pkg: _decoded()(pkg).image.to_tensor())
    else:
        _both_equal({"img": lambda pkg: _fixed(pkg, "RGB", null_rows=(4,))},
                    lambda pkg: pkg.col("img").image.to_tensor())


@pytest.mark.parametrize("method", HASH_METHODS)
def test_hash(method):
    out = _both_equal(_bytes_col(), lambda pkg: _decoded()(pkg).image.hash(method=method))
    assert out[-1] is None and all(isinstance(v, bytes) for v in out[:-2])
    _both_equal({"img": lambda pkg: _fixed(pkg, "RGBA", h=40, w=36)},
                lambda pkg: pkg.col("img").image.hash(method=method, hash_size=4,
                                                      binbits=4, segments=2))


@pytest.mark.parametrize("mode", [None, "L", "RGB", "RGBA"])
def test_variable_shape_resize_is_pil(mode):
    """Decoded rows are resized per row by PIL on the host: with a mode the
    column becomes a FixedShapeImage, without one it stays variable."""
    out = _both_equal(_bytes_col(), lambda pkg: _decoded(mode)(pkg).image.resize(16, 12))
    assert out[-1] is None and out[-2] is None


# -- free functions --------------------------------------------------------
FREE = {
    "resize": lambda f, e: f.resize(e, 10, 14),
    "crop": lambda f, e: f.crop(e, (2, 2, 9, 6)),
    "encode_image": lambda f, e: f.encode_image(e, "PNG"),
    "convert_image": lambda f, e: f.convert_image(e, "L"),
    "image_attribute": lambda f, e: f.image_attribute(e, "height"),
    "image_width": lambda f, e: f.image_width(e),
    "image_height": lambda f, e: f.image_height(e),
    "image_channel": lambda f, e: f.image_channel(e),
    "image_mode": lambda f, e: f.image_mode(e),
    "image_hash": lambda f, e: f.image_hash(e, method="dhash"),
    "image_to_tensor": lambda f, e: f.image_to_tensor(e),
}


@pytest.mark.parametrize("name", sorted(FREE))
def test_free_function(name):
    _both_equal({"b": ENCODED + [None]}, lambda pkg: FREE[name](
        FUNCS[pkg], FUNCS[pkg].decode_image(pkg.col("b"), mode="RGB")))


def test_free_decode_image_raises_on_a_corrupt_row():
    make = lambda pkg: FUNCS[pkg].decode_image(pkg.col("b"))  # noqa: E731
    _both_equal(_bytes_col(with_bad=False), make)
    for pkg in PKGS:
        with pytest.raises(Exception, match="cannot identify image file"):
            _run(pkg, {"b": [CORRUPT]}, make)


def test_namespace_has_every_jax_method_and_each_kernel_is_registered():
    public = lambda cls: {n for n in vars(cls) if not n.startswith("_")}  # noqa: E731
    assert public(TorchImageNamespace) == public(JaxImageNamespace)
    assert len(public(JaxImageNamespace)) == 12
    e = daft_tpu_torch.col("x").image
    exprs = [e.decode(), e.encode("png"), e.resize(2, 2), e.crop((0, 0, 1, 1)),
             e.to_mode("L"), e.width(), e.height(), e.channel(), e.mode(),
             e.attribute("width"), e.hash(), e.to_tensor(),
             tmedia.file("x"), tmedia.image_file("x", verify=True),
             tmedia.decode_image_file(daft_tpu_torch.col("x")),
             tmedia.image_file_metadata(daft_tpu_torch.col("x"))]
    names = {x._expr.fn_name for x in exprs}
    assert names == {"image_decode", "image_encode", "image_resize", "image_crop",
                     "image_to_mode", "image_attribute", "image_hash", "to_tensor",
                     "file_ref", "decode_image_file", "image_file_metadata"}
    assert all(has_kernel(n) for n in names)


# -- the fixed-shape resize ---------------------------------------------------
def _uint8_close(a: np.ndarray, b: np.ndarray) -> bool:
    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    return d.max() <= UINT8_MAX_OFF and (d > 0).mean() < UINT8_OFF_SHARE


def _resize_both(mode: str, h: int, w: int, oh: int, ow: int, null_rows=(), n: int = 3):
    out = {}
    for pkg in PKGS:
        dt, col = _run(pkg, {"img": lambda p: _fixed(p, mode, h, w, n=n, seed=7,
                                                    null_rows=null_rows)},
                       lambda p: p.col("img").image.resize(ow, oh))
        out[pkg] = (dt, col)
    (jdt, jcol), (tdt, tcol) = out[daft_tpu], out[daft_tpu_torch]
    assert tdt == jdt == f"Image[{mode}; {oh} x {ow}]"
    assert [v is None for v in tcol] == [v is None for v in jcol]
    pick = lambda col: np.stack(  # noqa: E731
        [np.asarray(v, dtype=np.uint8) for v in col if v is not None])
    return pick(jcol), pick(tcol)


SHAPES = [((256, 256), (224, 224)), ((480, 640), (224, 224)), ((64, 48), (224, 224)),
          ((300, 200), (100, 150)), ((40, 40), (40, 40))]


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0][0]}x{s[0][1]}-{s[1][0]}x{s[1][1]}")
def test_fixed_resize_matches_jax_image_resize(shape, mode):
    (h, w), (oh, ow) = shape
    ref, got = _resize_both(mode, h, w, oh, ow, n=2)
    assert got.shape == ref.shape
    assert _uint8_close(ref, got)
    if (h, w) == (oh, ow):  # jax.image.resize skips an axis that keeps its size
        assert np.array_equal(ref, got)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0][0]}x{s[0][1]}-{s[1][0]}x{s[1][1]}")
def test_fixed_resize_f32_matches_jax_image_resize(shape):
    (h, w), (oh, ow) = shape
    rng = np.random.default_rng(5)
    vals = (rng.random((2, h, w, 3), dtype=np.float32) * 255).astype(np.float32)
    cols = {}
    for pkg in PKGS:
        s = pkg.Series.from_numpy(vals.reshape(2, -1), "img",
                                  pkg.DataType.image("RGB32F", h, w))
        dt, col = _run(pkg, {"img": s}, lambda p: p.col("img").image.resize(ow, oh))
        assert dt == f"Image[RGB32F; {oh} x {ow}]"
        cols[pkg] = np.stack([np.asarray(v, dtype=np.float32) for v in col])
    np.testing.assert_allclose(cols[daft_tpu_torch], cols[daft_tpu], rtol=F32_RTOL,
                               atol=F32_ATOL)


def test_fixed_resize_null_and_zero_rows():
    ref, got = _resize_both("RGB", 48, 40, 20, 24, null_rows=(0, 3), n=5)
    assert _uint8_close(ref, got) and len(got) == 3
    # All-zero pixels stay zero; a column whose rows are all filtered out
    # comes back empty in both packages.
    for pkg in PKGS:
        zeros = pkg.Series.from_numpy(np.zeros((2, 8 * 6 * 3), np.uint8), "img",
                                      pkg.DataType.image("RGB", 8, 6))
        df = pkg.from_pydict({"img": zeros})
        with _ctx(pkg):
            out = df.with_column("r", pkg.col("img").image.resize(4, 4)).to_pydict()["r"]
            assert all(not np.asarray(v).any() for v in out)
            empty = df.where(pkg.col("img").is_null()).with_column(
                "r", pkg.col("img").image.resize(4, 4)).to_pydict()
            assert empty == {"img": [], "r": []}


def test_rgb16_resize_raises_in_both_packages():
    """C.28: the resize returns f32 for a 16-bit batch, which Arrow refuses
    to store back as uint16 once a value is not whole."""
    rng = np.random.default_rng(9)
    vals = rng.integers(0, 65536, (2, 12 * 10 * 3)).astype(np.uint16)
    for pkg, get in ((daft_tpu, jax_get_kernel), (daft_tpu_torch, get_kernel)):
        s = pkg.Series.from_numpy(vals, "img", pkg.DataType.image("RGB16", 12, 10))
        with _ctx(pkg), pytest.raises(pa.ArrowInvalid, match="was truncated"):
            get("image_resize")([s], w=7, h=5)


def test_fixed_resize_needs_the_configured_device():
    """No fallback: on the default device ("cuda") a machine without CUDA
    raises instead of resizing on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    df = daft_tpu_torch.from_pydict({"img": _fixed(daft_tpu_torch)})
    with pytest.raises(DaftValueError, match="no CUDA device"):
        df.with_column("r", daft_tpu_torch.col("img").image.resize(8, 8)).to_pydict()


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to TF32's 10 mantissa bits (round to nearest)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def test_contraction_runs_with_tf32_off_and_tf32_would_fail(monkeypatch):
    """TF32 is off for the contraction and restored after it; and the
    tolerance would catch TF32: the same contraction on TF32-rounded operands
    moves more than 1 % of the uint8 values."""
    vals = np.asarray(_fixed(daft_tpu_torch, "RGB", 256, 256, n=2).to_numpy())
    ref = np.asarray(_batch_resize_jax(vals, 224, 224))
    seen, einsum = [], torch.einsum

    def spy(eq, a, b):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return einsum(eq, a, b)

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        monkeypatch.setattr(torch, "einsum", spy)
        with daft_tpu_torch.execution_config_ctx(device="cpu"):
            got = image_ops._batch_resize(vals, 224, 224).numpy()
        assert seen == [False, False]
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert _uint8_close(ref, got)
    monkeypatch.setattr(torch, "einsum", lambda eq, a, b: einsum(eq, _tf32(a), _tf32(b)))
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        as_tf32 = image_ops._batch_resize(vals, 224, 224).numpy()
    assert not _uint8_close(ref, as_tf32)


def test_interpolate_without_antialias_would_fail():
    """torch's default ``F.interpolate(antialias=False)`` is not the JAX
    package's resize when downsampling (C.2): the tolerance rejects it."""
    vals = np.asarray(_fixed(daft_tpu_torch, "RGB", 480, 640, n=2).to_numpy())
    ref = np.asarray(_batch_resize_jax(vals, 224, 224))
    x = torch.tensor(vals).permute(0, 3, 1, 2).float()
    plain = F.interpolate(x, size=(224, 224), mode="bilinear", antialias=False)
    plain = plain.round().clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).numpy()
    assert not _uint8_close(ref, plain)


def test_weight_matrices_are_cached_per_size_and_device():
    a = image_ops._weight_mat(300, 100, torch.device("cpu"))
    assert image_ops._weight_mat(300, 100, torch.device("cpu")) is a
    assert a.shape == (300, 100) and a.dtype == torch.float32
    np.testing.assert_allclose(a.sum(0).numpy(), 1.0, rtol=1e-6)


# -- File and the image-file functions ------------------------------------------
@pytest.fixture
def image_files(tmp_path):
    paths = []
    for i, raw in enumerate(ENCODED[:5]):
        p = tmp_path / f"img{i}.bin"
        p.write_bytes(raw)
        paths.append(str(p))
    bad = tmp_path / "notes.txt"
    bad.write_bytes(b"plain text, no image")
    return paths, str(bad), str(tmp_path / "missing.jpg")


def test_file_handles(image_files):
    paths, _, _ = image_files
    raw = open(paths[0], "rb").read()
    for f in (File.from_path(paths[0]), File(url="file://" + paths[0]), File.from_bytes(raw)):
        assert f.read() == raw and f.size() == len(raw)
        with f.open() as fh:
            assert fh.read(4) == raw[:4]
        assert File.from_row(f.to_row()).to_row() == f.to_row()
    assert File.from_path(paths[0]).url == paths[0] and File.from_bytes(raw).url is None
    assert File.from_row(None) is None
    with pytest.raises(DaftValueError):
        File()
    # An object store's URL, through the context's IOConfig (ROADMAP A.8.2).
    from daft_tpu_torch.tools.object_stores import S3Stub

    with S3Stub() as stub:
        stub.mount("bucket", os.path.dirname(paths[0]))
        cfg = daft_tpu_torch.IOConfig(s3=daft_tpu_torch.S3Config(
            endpoint_url=stub.url, region_name=stub.region, key_id=stub.key_id,
            access_key=stub.secret, use_native_client=True))
        with daft_tpu_torch.planning_config_ctx(default_io_config=cfg):
            remote = File(url="s3://bucket/" + os.path.basename(paths[0]))
            assert remote.read() == raw and remote.size() == len(raw)
        assert not stub.bad_auth
    s = file_series([paths[1], raw, None, File.from_path(paths[2])])
    jax_s = jax_file_series([paths[1], raw, None, JaxFile.from_path(paths[2])])
    assert s.to_arrow().to_pylist() == jax_s.to_arrow().to_pylist()
    handles = s.to_pylist()
    assert isinstance(handles[0], File) and handles[2] is None
    assert handles[1].read() == raw and handles[3].read() == open(paths[2], "rb").read()


@pytest.mark.parametrize("verify", [False, True])
def test_file_and_image_file(image_files, verify):
    paths, _, _ = image_files
    data = {"p": paths + [None]}
    _both_equal(data, lambda pkg: MEDIA[pkg].file(pkg.col("p")))
    _both_equal(data, lambda pkg: MEDIA[pkg].image_file("p", verify=verify))
    _both_equal({"b": ENCODED[:3]}, lambda pkg: MEDIA[pkg].image_file("b", verify=verify))


def test_image_file_verify_rejects_a_non_image(image_files):
    paths, bad, _ = image_files
    for pkg in PKGS:
        with pytest.raises(Exception, match="is not a valid image file"):
            _run(pkg, {"p": paths[:1] + [bad]},
                 lambda p: MEDIA[p].image_file("p", verify=True))
    # Unverified, the same column is only a column of references.
    _both_equal({"p": paths[:1] + [bad]}, lambda p: MEDIA[p].image_file("p"))


@pytest.mark.parametrize("mode", [None, "RGB", "L"])
def test_decode_image_file(image_files, mode):
    paths, bad, missing = image_files
    out = _both_equal({"p": paths + [bad, missing, None]}, lambda pkg: MEDIA[pkg].decode_image_file(
        MEDIA[pkg].file(pkg.col("p")), mode=mode, on_error="null"))
    assert out[-3:] == [None, None, None] and all(v is not None for v in out[:-3])
    _both_equal({"p": paths}, lambda pkg: MEDIA[pkg].decode_image_file(
        MEDIA[pkg].image_file("p", verify=True), mode=mode))


def test_decode_image_file_raises_on_a_missing_file(image_files):
    _, _, missing = image_files
    for pkg in PKGS:
        with pytest.raises(FileNotFoundError):
            _run(pkg, {"p": [missing]},
                 lambda p: MEDIA[p].decode_image_file(MEDIA[p].file(p.col("p"))))


def test_image_file_metadata(image_files):
    paths, bad, _ = image_files
    out = _both_equal({"p": paths + [bad, None]}, lambda pkg: MEDIA[pkg].image_file_metadata(
        MEDIA[pkg].file(pkg.col("p"))))
    assert out[-2:] == [None, None]
    assert {row["format"] for row in out[:-2]} == {"jpeg", "png"}
