"""Image kernels (port of ``daft_tpu/kernels/image_ops.py``; reference:
src/daft-image, ~2.8k LoC).

* **decode / encode, to_mode, crop, attributes, to_tensor, hashes** — host
  side (PIL and numpy), copied in behaviour from the JAX package, which keeps
  them on the host too.
* **resize** — a variable-shape column is resized per row with PIL
  ``BILINEAR`` on the host. A ``FixedShapeImage`` column is one dense NHWC
  batch, resized by ``_batch_resize`` on ``execution_config.device`` (the
  GPU unless the config says ``"cpu"``): the bilinear, antialiased
  ``jax.image.resize`` the JAX package runs through XLA, written as its two
  weight-matrix contractions in f32 (C.2).
"""

from __future__ import annotations

import contextlib
import functools
import io

import numpy as np
import pyarrow as pa
import torch

from daft_tpu_torch.context import get_context
from daft_tpu_torch.datatype import DataType, ImageFormat, ImageMode, TypeId
from daft_tpu_torch.device import resolve_device
from daft_tpu_torch.errors import DaftTypeError, DaftValueError
from daft_tpu_torch.kernels.registry import register_kernel
from daft_tpu_torch.schema import Field
from daft_tpu_torch.series import Series

_MODE_TO_PIL = {
    ImageMode.L: "L", ImageMode.LA: "LA", ImageMode.RGB: "RGB", ImageMode.RGBA: "RGBA",
}


def _decode_resolver(fields, kwargs):
    mode = kwargs.get("mode")
    if isinstance(mode, str):
        mode = ImageMode.from_str(mode)
    return Field(fields[0].name, DataType.image(mode))


@register_kernel("image_decode", _decode_resolver)
def _image_decode(args, on_error: str = "raise", mode=None, **kwargs):
    from PIL import Image as PILImage

    s = args[0]
    if isinstance(mode, str):
        mode = ImageMode.from_str(mode)
    out_rows = []
    for raw in s.to_pylist():
        if raw is None:
            out_rows.append(None)
            continue
        try:
            img = PILImage.open(io.BytesIO(raw))
            pil_mode = _MODE_TO_PIL.get(mode) if mode else ("RGB" if img.mode not in ("L", "LA", "RGB", "RGBA") else img.mode)
            if pil_mode and img.mode != pil_mode:
                img = img.convert(pil_mode)
            arr = np.asarray(img)
            if arr.ndim == 2:
                arr = arr[:, :, None]
            m = mode or ImageMode.from_str(img.mode if img.mode in ("L", "LA", "RGB", "RGBA") else "RGB")
            out_rows.append({
                "data": arr.tobytes(), "channel": arr.shape[2],
                "height": arr.shape[0], "width": arr.shape[1], "mode": m.value,
            })
        except Exception:
            if on_error == "raise":
                raise
            out_rows.append(None)
    dtype = DataType.image(mode)
    arr = pa.array(out_rows, dtype.to_arrow())
    return Series.from_arrow(arr, s.name, dtype)


def _image_rows(s: Series):
    """Yield (ndarray HWC or None, mode) rows from an image-typed series."""
    dt = s.dtype
    if dt.id == TypeId.FIXED_SHAPE_IMAGE:
        vals, mask = s.to_numpy_masked()
        for i in range(len(s)):
            if mask is not None and mask[i]:
                yield None, dt.image_mode
            else:
                yield vals[i], dt.image_mode
    elif dt.id == TypeId.IMAGE:
        for row in s.to_arrow().to_pylist():
            if row is None:
                yield None, None
            else:
                m = ImageMode(row["mode"])
                arr = np.frombuffer(row["data"], dtype=m.pixel_dtype.to_numpy()).reshape(
                    row["height"], row["width"], row["channel"]
                )
                yield arr, m
    else:
        raise DaftTypeError(f"Expected image column, got {dt!r}")


@register_kernel("image_encode", lambda f, k: Field(f[0].name, DataType.binary()))
def _image_encode(args, image_format="png", **kwargs):
    from PIL import Image as PILImage

    if isinstance(image_format, str):
        image_format = ImageFormat.from_str(image_format)
    s = args[0]
    out = []
    for arr, m in _image_rows(s):
        if arr is None:
            out.append(None)
            continue
        img = PILImage.fromarray(arr.squeeze(-1) if arr.shape[2] == 1 else arr)
        buf = io.BytesIO()
        img.save(buf, format=image_format.value.upper())
        out.append(buf.getvalue())
    return Series.from_pylist(out, s.name, DataType.binary())


def _resize_resolver(fields, kwargs):
    f = fields[0]
    dt = f.dtype
    w, h = kwargs["w"], kwargs["h"]
    if dt.id == TypeId.FIXED_SHAPE_IMAGE:
        return Field(f.name, DataType.image(dt.image_mode, h, w))
    if dt.id == TypeId.IMAGE and dt.image_mode is not None:
        return Field(f.name, DataType.image(dt.image_mode, h, w))
    return Field(f.name, dt)


@functools.lru_cache(maxsize=64)
def _weight_mat(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    """(n_in, n_out) f32 weights of one axis of the antialiased bilinear
    resize, as ``jax._src.image.scale.compute_weight_mat`` builds them: a
    triangle kernel widened by ``max(n_in / n_out, 1)`` around each output
    pixel's centre, each column divided by its sum (a sum at or below
    1000 f32 eps gives zeros), and columns whose centre falls outside the
    input zeroed. Every step is one f32 operation, as in JAX (the inverse
    scale is the f64 quotient rounded once), so the CPU builds the same bits
    for every device."""
    inv_scale = np.float32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample = (torch.arange(n_out, dtype=torch.float32) + 0.5) * float(inv_scale) - 0.5
    dist = (sample[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]).abs()
    weights = (1 - dist / float(kernel_scale)).clamp(min=0)
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights)).to(device)


@contextlib.contextmanager
def _tf32_off():
    """Full f32 products for the contraction, as XLA's ``HIGHEST`` precision
    gives the JAX package (C.5): TF32 would round the operands to 10 mantissa
    bits and move 1.8-4.5 % of uint8 outputs by one level (emulated in
    tests/test_torch_image.py). The flag is process-wide, so it is restored
    on the way out."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _batch_resize(batch: np.ndarray, h: int, w: int) -> torch.Tensor:
    """Bilinear, antialiased resize of an NHWC batch on
    ``execution_config.device``, the counterpart of the JAX package's
    ``_batch_resize_jax``: the batch is staged to the device and resized
    there (``_resize_nhwc``). Returns the result on the device."""
    device = resolve_device(get_context().execution_config.device)
    # Arrow's buffers are read-only, which torch.from_numpy refuses to wrap
    # silently: np.require copies such a batch once.
    return _resize_nhwc(torch.from_numpy(np.require(batch, requirements=("C", "W"))).to(device),
                        h, w)


def _resize_nhwc(batch: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``jax.image.resize(method="bilinear")`` of an NHWC batch on its own
    device: cast to f32, contracted with each resized axis's weight matrix
    (an axis that keeps its size is left as it is, as JAX skips it), then
    for uint8 rounded half to even and clipped to [0, 255]. Every other dtype
    keeps the f32 result, as in the JAX package (so 16-bit modes cannot be
    stored back: C.28)."""
    x = batch.to(torch.float32)
    n_h, n_w = x.shape[1], x.shape[2]
    with _tf32_off():
        if n_w != w:
            x = torch.einsum("nhwc,wq->nhqc", x, _weight_mat(n_w, w, x.device))
        if n_h != h:
            x = torch.einsum("nhwc,hp->npwc", x, _weight_mat(n_h, h, x.device))
    if batch.dtype == torch.uint8:
        return torch.round(x).clamp(0, 255).to(torch.uint8)
    return x


@register_kernel("image_resize", _resize_resolver)
def _image_resize(args, w: int = 0, h: int = 0, **kwargs):
    s = args[0]
    dt = s.dtype
    if dt.id == TypeId.FIXED_SHAPE_IMAGE:
        # Whole column is one dense NHWC batch: resized on the device in one
        # call; null rows are resized as zeros and masked again.
        vals, mask = s.to_numpy_masked()
        out = _batch_resize(vals, h, w).cpu().numpy()
        out_dt = DataType.image(dt.image_mode, h, w)
        return Series.from_numpy(out.reshape(len(s), -1), s.name, out_dt)._with_mask(mask)
    # Variable-shape: per-row host resize via PIL (mixed shapes can't batch).
    from PIL import Image as PILImage

    mode = dt.image_mode
    out_rows = []
    for arr, m in _image_rows(s):
        if arr is None:
            out_rows.append(None)
            continue
        img = PILImage.fromarray(arr.squeeze(-1) if arr.shape[2] == 1 else arr)
        img = img.resize((w, h), PILImage.BILINEAR)
        res = np.asarray(img)
        if res.ndim == 2:
            res = res[:, :, None]
        out_rows.append({
            "data": res.tobytes(), "channel": res.shape[2],
            "height": h, "width": w, "mode": (m or ImageMode.RGB).value,
        })
    if mode is not None:
        # Known mode + fixed target shape -> dense FixedShapeImage output.
        out_dt = DataType.image(mode, h, w)
        dense = np.zeros((len(out_rows), h * w * mode.num_channels), dtype=mode.pixel_dtype.to_numpy())
        validity = np.ones(len(out_rows), dtype=bool)
        for i, row in enumerate(out_rows):
            if row is None:
                validity[i] = False
            else:
                dense[i] = np.frombuffer(row["data"], dtype=mode.pixel_dtype.to_numpy())
        res = Series.from_numpy(dense, s.name, out_dt)
        return res._with_mask(~validity) if not validity.all() else res
    out_dt = DataType.image(None)
    return Series.from_arrow(pa.array(out_rows, out_dt.to_arrow()), s.name, out_dt)


@register_kernel("image_to_mode", lambda f, k: Field(f[0].name, _to_mode_dtype(f[0].dtype, k["mode"])))
def _image_to_mode(args, mode=None, **kwargs):
    from PIL import Image as PILImage

    if isinstance(mode, str):
        mode = ImageMode.from_str(mode)
    s = args[0]
    dt = s.dtype
    out_rows = []
    for arr, m in _image_rows(s):
        if arr is None:
            out_rows.append(None)
            continue
        img = PILImage.fromarray(arr.squeeze(-1) if arr.shape[2] == 1 else arr)
        img = img.convert(_MODE_TO_PIL[mode])
        res = np.asarray(img)
        if res.ndim == 2:
            res = res[:, :, None]
        out_rows.append(res)
    out_dt = _to_mode_dtype(dt, mode)
    if out_dt.id == TypeId.FIXED_SHAPE_IMAGE:
        h, w = dt._params[1], dt._params[2]
        dense = np.zeros((len(out_rows), h * w * mode.num_channels), dtype=mode.pixel_dtype.to_numpy())
        validity = np.ones(len(out_rows), dtype=bool)
        for i, r in enumerate(out_rows):
            if r is None:
                validity[i] = False
            else:
                dense[i] = r.reshape(-1)
        res = Series.from_numpy(dense, s.name, out_dt)
        return res._with_mask(~validity) if not validity.all() else res
    rows = [
        None if r is None else {
            "data": r.tobytes(), "channel": r.shape[2], "height": r.shape[0],
            "width": r.shape[1], "mode": mode.value,
        }
        for r in out_rows
    ]
    return Series.from_arrow(pa.array(rows, out_dt.to_arrow()), s.name, out_dt)


def _to_mode_dtype(dt: DataType, mode) -> DataType:
    if isinstance(mode, str):
        mode = ImageMode.from_str(mode)
    if dt.id == TypeId.FIXED_SHAPE_IMAGE:
        return DataType.image(mode, dt._params[1], dt._params[2])
    return DataType.image(mode)


@register_kernel("image_crop", lambda f, k: Field(f[0].name, DataType.image(f[0].dtype.image_mode) if f[0].dtype.id in (TypeId.IMAGE, TypeId.FIXED_SHAPE_IMAGE) else f[0].dtype))
def _image_crop(args, bbox=None, **kwargs):
    s = args[0]
    x, y, w, h = bbox
    out_rows = []
    for arr, m in _image_rows(s):
        if arr is None:
            out_rows.append(None)
            continue
        cropped = arr[y:y + h, x:x + w]
        out_rows.append({
            "data": cropped.tobytes(), "channel": cropped.shape[2],
            "height": cropped.shape[0], "width": cropped.shape[1],
            "mode": (m or ImageMode.RGB).value,
        })
    out_dt = DataType.image(s.dtype.image_mode)
    return Series.from_arrow(pa.array(out_rows, out_dt.to_arrow()), s.name, out_dt)


# ------------------------------------------------------------------ #
# image accessors (reference: daft/functions/image.py image_attribute/ #
# image_width/image_height/image_channel/image_mode)                  #
# ------------------------------------------------------------------ #
def _attr_resolver(fields, kwargs):
    name = kwargs.get("name", "width")
    dt = DataType.string() if name == "mode" else DataType.uint32()
    return Field(fields[0].name, dt)


@register_kernel("image_attribute", _attr_resolver)
def _image_attribute(args, name: str = "width", **kwargs):
    s = args[0]
    out = []
    for arr, m in _image_rows(s):
        if arr is None:
            out.append(None)
        elif name == "width":
            out.append(arr.shape[1])
        elif name == "height":
            out.append(arr.shape[0])
        elif name == "channel":
            out.append(arr.shape[2])
        elif name == "mode":
            out.append((m or ImageMode.RGB).name)
        else:
            raise DaftValueError(f"unknown image attribute {name!r}")
    dt = DataType.string() if name == "mode" else DataType.uint32()
    return Series.from_pylist(out, s.name, dt)


@register_kernel("to_tensor", lambda f, k: Field(
    f[0].name,
    DataType.tensor(DataType.uint8(), (f[0].dtype._params[1], f[0].dtype._params[2],
                                       (f[0].dtype._params[0].num_channels
                                        if f[0].dtype._params[0] else 3)))
    if f[0].dtype.id == TypeId.FIXED_SHAPE_IMAGE
    else DataType.tensor(DataType.uint8())))
def _image_to_tensor(args, **kwargs):
    """Image -> (fixed-shape when known) uint8 tensor (reference: image.py
    image_to_tensor / "to_tensor" builtin)."""
    s = args[0]
    dt = s.dtype
    if dt.id == TypeId.FIXED_SHAPE_IMAGE:
        out_dt = DataType.tensor(
            DataType.uint8(),
            (dt._params[1], dt._params[2],
             dt._params[0].num_channels if dt._params[0] else 3))
        return s.cast(out_dt)
    out_dt = DataType.tensor(DataType.uint8())
    rows = [None if arr is None else np.ascontiguousarray(arr).astype(np.uint8)
            for arr, _ in _image_rows(s)]
    return Series.from_pylist(rows, s.name, out_dt)


# ------------------------------------------------------------------ #
# perceptual image hashes (reference: daft/functions/image.py          #
# image_hash: phash/phash_simple/dhash/dhash_vertical/ahash/whash/     #
# crop_resistant/colorhash -> FixedSizeBinary)                         #
# ------------------------------------------------------------------ #
def _to_gray(arr: np.ndarray) -> np.ndarray:
    if arr.shape[2] < 3:  # L or LA: luminance channel, alpha ignored
        return arr[:, :, 0].astype(np.float64)
    rgb = arr[:, :, :3].astype(np.float64)
    return rgb @ np.array([0.299, 0.587, 0.114])


def _pil_resize_gray(arr: np.ndarray, w: int, h: int) -> np.ndarray:
    from PIL import Image as PILImage

    g = _to_gray(arr)
    img = PILImage.fromarray(np.clip(g, 0, 255).astype(np.uint8), "L")
    return np.asarray(img.resize((w, h), PILImage.LANCZOS), dtype=np.float64)


def _dct_matrix(n: int) -> np.ndarray:
    k = np.arange(n)
    return np.cos(np.pi / n * (k[None, :] + 0.5) * k[:, None])


def _bits_to_bytes(bits: np.ndarray) -> bytes:
    pad = (-len(bits)) % 8
    if pad:
        bits = np.concatenate([bits, np.zeros(pad, dtype=bool)])
    return np.packbits(bits.astype(np.uint8)).tobytes()


def _hash_one(arr: np.ndarray, method: str, hash_size: int, binbits: int,
              segments: int) -> bytes:
    hs = hash_size
    if method == "ahash":
        px = _pil_resize_gray(arr, hs, hs)
        return _bits_to_bytes((px > px.mean()).ravel())
    if method == "dhash":
        px = _pil_resize_gray(arr, hs + 1, hs)
        return _bits_to_bytes((px[:, 1:] > px[:, :-1]).ravel())
    if method == "dhash_vertical":
        px = _pil_resize_gray(arr, hs, hs + 1)
        return _bits_to_bytes((px[1:, :] > px[:-1, :]).ravel())
    if method == "phash":
        n = hs * 4
        px = _pil_resize_gray(arr, n, n)
        C = _dct_matrix(n)
        freq = (C @ px @ C.T)[:hs, :hs]
        flat = freq.ravel()
        med = np.median(flat[1:])  # exclude the DC coefficient
        return _bits_to_bytes(flat > med)
    if method == "phash_simple":
        n = hs * 4
        px = _pil_resize_gray(arr, n, n)
        C = _dct_matrix(n)
        freq = (C @ px)[:hs, :hs]
        return _bits_to_bytes((freq > freq.mean()).ravel())
    if method == "whash":
        # One-level Haar approximation band: 2x2 mean pooling to hash_size.
        px = _pil_resize_gray(arr, hs * 2, hs * 2)
        ll = px.reshape(hs, 2, hs, 2).mean(axis=(1, 3))
        return _bits_to_bytes((ll > np.median(ll)).ravel())
    if method == "crop_resistant":
        parts = []
        H, W = arr.shape[0], arr.shape[1]
        for i in range(segments):
            for j in range(segments):
                seg = arr[i * H // segments:(i + 1) * H // segments or H,
                          j * W // segments:(j + 1) * W // segments or W]
                if seg.size == 0:
                    seg = arr
                parts.append(_hash_one(seg, "phash", hash_size, binbits, segments))
        return b"".join(parts)
    if method == "colorhash":
        # 14 hue/intensity bins quantized to binbits each (imagehash-style).
        rgb = arr[:, :, :3].astype(np.float64) if arr.shape[2] >= 3 else np.repeat(
            arr[:, :, :1].astype(np.float64), 3, axis=2)
        mx, mn = rgb.max(axis=2), rgb.min(axis=2)
        sat = np.where(mx > 0, (mx - mn) / np.maximum(mx, 1e-9), 0.0)
        gray_mask = sat < 0.1
        r, g, b = rgb[:, :, 0], rgb[:, :, 1], rgb[:, :, 2]
        delta = np.maximum(mx - mn, 1e-9)
        hue = np.where(mx == r, (g - b) / delta % 6,
                       np.where(mx == g, (b - r) / delta + 2, (r - g) / delta + 4)) / 6
        counts = np.zeros(14)
        # 2 intensity bins for near-gray pixels + 12 hue bins for the rest.
        lum = mx / 255.0
        counts[0] = np.count_nonzero(gray_mask & (lum < 0.5))
        counts[1] = np.count_nonzero(gray_mask & (lum >= 0.5))
        hue_bins = np.minimum((hue[~gray_mask] * 12).astype(int), 11)
        for hb in hue_bins:
            counts[2 + hb] += 1
        frac = counts / max(counts.sum(), 1)
        maxq = (1 << binbits) - 1
        q = np.minimum((frac * maxq * 4).astype(int), maxq)
        bits = ((q[:, None] >> np.arange(binbits - 1, -1, -1)) & 1).astype(bool)
        return _bits_to_bytes(bits.ravel())
    raise DaftValueError(f"unknown image hash method {method!r}")


def _image_hash_nbytes(method: str, hash_size: int, binbits: int,
                       segments: int) -> int:
    if method == "colorhash":
        return (14 * binbits + 7) // 8
    if method == "crop_resistant":
        return segments * segments * ((hash_size * hash_size + 7) // 8)
    return (hash_size * hash_size + 7) // 8


def _image_hash_resolver(fields, kwargs):
    n = _image_hash_nbytes(kwargs.get("method", "phash"),
                           kwargs.get("hash_size", 8),
                           kwargs.get("binbits", 3), kwargs.get("segments", 3))
    return Field(fields[0].name, DataType.fixed_size_binary(n))


@register_kernel("image_hash", _image_hash_resolver)
def _image_hash(args, method: str = "phash", hash_size: int = 8,
                binbits: int = 3, segments: int = 3, **kwargs):
    s = args[0]
    n = _image_hash_nbytes(method, hash_size, binbits, segments)
    out = [None if arr is None
           else _hash_one(arr, method, hash_size, binbits, segments)
           for arr, _ in _image_rows(s)]
    dt = DataType.fixed_size_binary(n)
    return Series.from_arrow(pa.array(out, dt.to_arrow()), s.name, dt)
