"""DataType: the engine's logical type system.

Port of ``daft_tpu/datatype.py`` (reference: src/daft-schema/src/dtype.rs:17-152).
Every dtype knows its host representation, an Arrow type (Arrow C++ buffers via
pyarrow are the host columnar memory), and whether it is fixed-width, so that
it could live densely on a device. The JAX device seam (``to_jax``) is not
ported.

Logical types (Embedding / Image / FixedShapeImage / Tensor / FixedShapeTensor /
SparseTensor / Map / File / Python) are carried alongside their physical Arrow
storage, mirroring the reference's logical-type wrappers
(src/daft-schema/src/dtype.rs: Embedding/Image/Tensor variants).
"""

from __future__ import annotations

import builtins
from enum import Enum
from typing import Any, Optional, Tuple

import numpy as np
import pyarrow as pa

from daft_tpu_torch.errors import DaftTypeError, DaftValueError


class TypeId(Enum):
    NULL = "null"
    BOOL = "bool"
    INT8 = "int8"
    INT16 = "int16"
    INT32 = "int32"
    INT64 = "int64"
    UINT8 = "uint8"
    UINT16 = "uint16"
    UINT32 = "uint32"
    UINT64 = "uint64"
    # bfloat16 is first-class: it is the models' compute dtype.
    BFLOAT16 = "bfloat16"
    FLOAT32 = "float32"
    FLOAT64 = "float64"
    DECIMAL128 = "decimal128"
    STRING = "string"
    BINARY = "binary"
    FIXED_SIZE_BINARY = "fixed_size_binary"
    DATE = "date"
    TIME = "time"
    TIMESTAMP = "timestamp"
    DURATION = "duration"
    INTERVAL = "interval"
    LIST = "list"
    FIXED_SIZE_LIST = "fixed_size_list"
    STRUCT = "struct"
    MAP = "map"
    # Logical / multimodal types.
    EMBEDDING = "embedding"
    IMAGE = "image"
    FIXED_SHAPE_IMAGE = "fixed_shape_image"
    TENSOR = "tensor"
    FIXED_SHAPE_TENSOR = "fixed_shape_tensor"
    SPARSE_TENSOR = "sparse_tensor"
    PYTHON = "python"
    FILE = "file"
    EXTENSION = "extension"
    UNKNOWN = "unknown"


class ImageMode(Enum):
    """Supported image pixel layouts (reference: src/daft-schema/src/image_mode.rs)."""

    L = 1
    LA = 2
    RGB = 3
    RGBA = 4
    L16 = 5
    LA16 = 6
    RGB16 = 7
    RGBA16 = 8
    RGB32F = 9
    RGBA32F = 10

    @property
    def num_channels(self) -> int:
        return {
            ImageMode.L: 1, ImageMode.LA: 2, ImageMode.RGB: 3, ImageMode.RGBA: 4,
            ImageMode.L16: 1, ImageMode.LA16: 2, ImageMode.RGB16: 3, ImageMode.RGBA16: 4,
            ImageMode.RGB32F: 3, ImageMode.RGBA32F: 4,
        }[self]

    @property
    def pixel_dtype(self) -> "DataType":
        if self in (ImageMode.RGB32F, ImageMode.RGBA32F):
            return DataType.float32()
        if self in (ImageMode.L16, ImageMode.LA16, ImageMode.RGB16, ImageMode.RGBA16):
            return DataType.uint16()
        return DataType.uint8()

    @staticmethod
    def from_str(s: str) -> "ImageMode":
        try:
            return ImageMode[s.upper()]
        except KeyError:
            raise DaftValueError(f"Unknown image mode: {s!r}") from None


class ImageFormat(Enum):
    PNG = "png"
    JPEG = "jpeg"
    TIFF = "tiff"
    GIF = "gif"
    BMP = "bmp"
    WEBP = "webp"

    @staticmethod
    def from_str(s: str) -> "ImageFormat":
        s = s.lower()
        if s == "jpg":
            s = "jpeg"
        try:
            return ImageFormat(s)
        except ValueError:
            raise DaftValueError(f"Unknown image format: {s!r}") from None


class TimeUnit(Enum):
    S = "s"
    MS = "ms"
    US = "us"
    NS = "ns"

    @staticmethod
    def from_str(s: str) -> "TimeUnit":
        try:
            return TimeUnit(s.lower())
        except ValueError:
            raise DaftValueError(f"Unknown time unit: {s!r}") from None


_SIMPLE_ARROW = {
    TypeId.NULL: pa.null(),
    TypeId.BOOL: pa.bool_(),
    TypeId.INT8: pa.int8(),
    TypeId.INT16: pa.int16(),
    TypeId.INT32: pa.int32(),
    TypeId.INT64: pa.int64(),
    TypeId.UINT8: pa.uint8(),
    TypeId.UINT16: pa.uint16(),
    TypeId.UINT32: pa.uint32(),
    TypeId.UINT64: pa.uint64(),
    TypeId.FLOAT32: pa.float32(),
    TypeId.FLOAT64: pa.float64(),
    TypeId.STRING: pa.large_string(),
    TypeId.BINARY: pa.large_binary(),
    TypeId.DATE: pa.date32(),
}

_NUMPY_DTYPES = {
    TypeId.BOOL: np.dtype(np.bool_),
    TypeId.INT8: np.dtype(np.int8),
    TypeId.INT16: np.dtype(np.int16),
    TypeId.INT32: np.dtype(np.int32),
    TypeId.INT64: np.dtype(np.int64),
    TypeId.UINT8: np.dtype(np.uint8),
    TypeId.UINT16: np.dtype(np.uint16),
    TypeId.UINT32: np.dtype(np.uint32),
    TypeId.UINT64: np.dtype(np.uint64),
    TypeId.FLOAT32: np.dtype(np.float32),
    TypeId.FLOAT64: np.dtype(np.float64),
}

_INTEGER_IDS = {
    TypeId.INT8, TypeId.INT16, TypeId.INT32, TypeId.INT64,
    TypeId.UINT8, TypeId.UINT16, TypeId.UINT32, TypeId.UINT64,
}
_FLOAT_IDS = {TypeId.BFLOAT16, TypeId.FLOAT32, TypeId.FLOAT64}


class DataType:
    """An immutable engine data type.

    Construct via the static factory methods (``DataType.int64()``,
    ``DataType.embedding(DataType.float32(), 768)``, ...), mirroring the
    reference's Python surface (reference: daft/datatype.py).
    """

    __slots__ = ("_id", "_params", "_hash")

    def __init__(self, type_id: TypeId, params: Tuple[Any, ...] = ()):
        self._id = type_id
        self._params = params
        self._hash = hash((type_id, params))

    # -- identity ---------------------------------------------------------
    @property
    def id(self) -> TypeId:
        return self._id

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, DataType)
            and self._id is other._id
            and self._params == other._params
        )

    def __hash__(self) -> int:
        return self._hash

    def __repr__(self) -> str:
        tid = self._id
        if not self._params:
            return tid.value.capitalize() if tid != TypeId.STRING else "Utf8"
        if tid == TypeId.LIST:
            return f"List[{self._params[0]!r}]"
        if tid == TypeId.FIXED_SIZE_LIST:
            return f"FixedSizeList[{self._params[0]!r}; {self._params[1]}]"
        if tid == TypeId.FIXED_SIZE_BINARY:
            return f"FixedSizeBinary[{self._params[0]}]"
        if tid == TypeId.STRUCT:
            inner = ", ".join(f"{n}: {t!r}" for n, t in self._params[0])
            return f"Struct[{inner}]"
        if tid == TypeId.MAP:
            return f"Map[{self._params[0]!r}: {self._params[1]!r}]"
        if tid == TypeId.EMBEDDING:
            return f"Embedding[{self._params[0]!r}; {self._params[1]}]"
        if tid == TypeId.IMAGE:
            mode = self._params[0]
            return f"Image[{mode.name}]" if mode is not None else "Image[MIXED]"
        if tid == TypeId.FIXED_SHAPE_IMAGE:
            mode, h, w = self._params
            return f"Image[{mode.name}; {h} x {w}]"
        if tid == TypeId.TENSOR:
            return f"Tensor({self._params[0]!r})"
        if tid == TypeId.FIXED_SHAPE_TENSOR:
            return f"FixedShapeTensor[{self._params[0]!r}; {self._params[1]}]"
        if tid == TypeId.SPARSE_TENSOR:
            return f"SparseTensor({self._params[0]!r})"
        if tid == TypeId.TIMESTAMP:
            tu, tz = self._params
            return f"Timestamp[{tu.value}{', ' + tz if tz else ''}]"
        if tid == TypeId.TIME:
            return f"Time[{self._params[0].value}]"
        if tid == TypeId.DURATION:
            return f"Duration[{self._params[0].value}]"
        if tid == TypeId.DECIMAL128:
            return f"Decimal128[{self._params[0]}, {self._params[1]}]"
        return f"{tid.value}{self._params!r}"

    # -- factories --------------------------------------------------------
    @staticmethod
    def null() -> "DataType":
        return DataType(TypeId.NULL)

    @staticmethod
    def bool() -> "DataType":
        return DataType(TypeId.BOOL)

    @staticmethod
    def int8() -> "DataType":
        return DataType(TypeId.INT8)

    @staticmethod
    def int16() -> "DataType":
        return DataType(TypeId.INT16)

    @staticmethod
    def int32() -> "DataType":
        return DataType(TypeId.INT32)

    @staticmethod
    def int64() -> "DataType":
        return DataType(TypeId.INT64)

    @staticmethod
    def uint8() -> "DataType":
        return DataType(TypeId.UINT8)

    @staticmethod
    def uint16() -> "DataType":
        return DataType(TypeId.UINT16)

    @staticmethod
    def uint32() -> "DataType":
        return DataType(TypeId.UINT32)

    @staticmethod
    def uint64() -> "DataType":
        return DataType(TypeId.UINT64)

    @staticmethod
    def bfloat16() -> "DataType":
        return DataType(TypeId.BFLOAT16)

    @staticmethod
    def float32() -> "DataType":
        return DataType(TypeId.FLOAT32)

    @staticmethod
    def float64() -> "DataType":
        return DataType(TypeId.FLOAT64)

    @staticmethod
    def decimal128(precision: int, scale: int) -> "DataType":
        return DataType(TypeId.DECIMAL128, (precision, scale))

    @staticmethod
    def string() -> "DataType":
        return DataType(TypeId.STRING)

    @staticmethod
    def binary() -> "DataType":
        return DataType(TypeId.BINARY)

    @staticmethod
    def fixed_size_binary(size: int) -> "DataType":
        return DataType(TypeId.FIXED_SIZE_BINARY, (int(size),))

    @staticmethod
    def date() -> "DataType":
        return DataType(TypeId.DATE)

    @staticmethod
    def time(timeunit: "TimeUnit | str" = TimeUnit.US) -> "DataType":
        if isinstance(timeunit, str):
            timeunit = TimeUnit.from_str(timeunit)
        if timeunit not in (TimeUnit.US, TimeUnit.NS):
            raise DaftValueError("Time only supports us/ns units")
        return DataType(TypeId.TIME, (timeunit,))

    @staticmethod
    def timestamp(timeunit: "TimeUnit | str" = TimeUnit.US, timezone: Optional[str] = None) -> "DataType":
        if isinstance(timeunit, str):
            timeunit = TimeUnit.from_str(timeunit)
        return DataType(TypeId.TIMESTAMP, (timeunit, timezone))

    @staticmethod
    def duration(timeunit: "TimeUnit | str" = TimeUnit.US) -> "DataType":
        if isinstance(timeunit, str):
            timeunit = TimeUnit.from_str(timeunit)
        return DataType(TypeId.DURATION, (timeunit,))

    @staticmethod
    def interval() -> "DataType":
        return DataType(TypeId.INTERVAL)

    @staticmethod
    def list(inner: "DataType") -> "DataType":
        return DataType(TypeId.LIST, (inner,))

    @staticmethod
    def fixed_size_list(inner: "DataType", size: int) -> "DataType":
        return DataType(TypeId.FIXED_SIZE_LIST, (inner, int(size)))

    @staticmethod
    def struct(fields: "dict[str, DataType]") -> "DataType":
        return DataType(TypeId.STRUCT, (tuple((str(k), v) for k, v in fields.items()),))

    @staticmethod
    def map(key: "DataType", value: "DataType") -> "DataType":
        return DataType(TypeId.MAP, (key, value))

    @staticmethod
    def embedding(dtype: "DataType", size: int) -> "DataType":
        if not dtype.is_numeric():
            raise DaftTypeError(f"Embedding inner dtype must be numeric, got {dtype!r}")
        return DataType(TypeId.EMBEDDING, (dtype, int(size)))

    @staticmethod
    def image(mode: "ImageMode | str | None" = None, height: Optional[int] = None, width: Optional[int] = None) -> "DataType":
        if isinstance(mode, str):
            mode = ImageMode.from_str(mode)
        if height is not None and width is not None:
            if mode is None:
                raise DaftValueError("Fixed-shape image requires a mode")
            return DataType(TypeId.FIXED_SHAPE_IMAGE, (mode, int(height), int(width)))
        if height is not None or width is not None:
            raise DaftValueError("Image requires both height and width, or neither")
        return DataType(TypeId.IMAGE, (mode,))

    @staticmethod
    def tensor(dtype: "DataType", shape: Optional[Tuple[int, ...]] = None) -> "DataType":
        if shape is not None:
            return DataType(TypeId.FIXED_SHAPE_TENSOR, (dtype, tuple(int(s) for s in shape)))
        return DataType(TypeId.TENSOR, (dtype,))

    @staticmethod
    def sparse_tensor(dtype: "DataType", shape: Optional[Tuple[int, ...]] = None) -> "DataType":
        return DataType(TypeId.SPARSE_TENSOR, (dtype, tuple(shape) if shape else None))

    @staticmethod
    def python() -> "DataType":
        return DataType(TypeId.PYTHON)

    @staticmethod
    def file() -> "DataType":
        return DataType(TypeId.FILE)

    # -- predicates -------------------------------------------------------
    def is_null(self) -> builtins.bool:
        return self._id == TypeId.NULL

    def is_boolean(self) -> builtins.bool:
        return self._id == TypeId.BOOL

    def is_integer(self) -> builtins.bool:
        return self._id in _INTEGER_IDS

    def is_signed_integer(self) -> builtins.bool:
        return self._id in (TypeId.INT8, TypeId.INT16, TypeId.INT32, TypeId.INT64)

    def is_unsigned_integer(self) -> builtins.bool:
        return self._id in (TypeId.UINT8, TypeId.UINT16, TypeId.UINT32, TypeId.UINT64)

    def is_floating(self) -> builtins.bool:
        return self._id in _FLOAT_IDS

    def is_numeric(self) -> builtins.bool:
        return self.is_integer() or self.is_floating() or self._id == TypeId.DECIMAL128

    def is_temporal(self) -> builtins.bool:
        return self._id in (TypeId.DATE, TypeId.TIME, TypeId.TIMESTAMP, TypeId.DURATION)

    def is_string(self) -> builtins.bool:
        return self._id == TypeId.STRING

    def is_binary(self) -> builtins.bool:
        return self._id in (TypeId.BINARY, TypeId.FIXED_SIZE_BINARY)

    def is_list(self) -> builtins.bool:
        return self._id in (TypeId.LIST, TypeId.FIXED_SIZE_LIST)

    def is_struct(self) -> builtins.bool:
        return self._id == TypeId.STRUCT

    def is_map(self) -> builtins.bool:
        return self._id == TypeId.MAP

    def is_nested(self) -> builtins.bool:
        return self.is_list() or self.is_struct() or self.is_map()

    def is_logical(self) -> builtins.bool:
        return self._id in (
            TypeId.EMBEDDING, TypeId.IMAGE, TypeId.FIXED_SHAPE_IMAGE,
            TypeId.TENSOR, TypeId.FIXED_SHAPE_TENSOR, TypeId.SPARSE_TENSOR,
            TypeId.MAP, TypeId.FILE,
        )

    def is_python(self) -> builtins.bool:
        return self._id == TypeId.PYTHON

    def is_comparable(self) -> builtins.bool:
        return (
            self.is_numeric() or self.is_boolean() or self.is_string()
            or self.is_binary() or self.is_temporal() or self.is_null()
        )

    # -- parameter accessors ---------------------------------------------
    @property
    def inner(self) -> "DataType":
        """Inner dtype of list/fixed_size_list/embedding/tensor types."""
        if self._id in (TypeId.LIST, TypeId.FIXED_SIZE_LIST, TypeId.EMBEDDING,
                        TypeId.TENSOR, TypeId.FIXED_SHAPE_TENSOR, TypeId.SPARSE_TENSOR):
            return self._params[0]
        if self._id in (TypeId.IMAGE, TypeId.FIXED_SHAPE_IMAGE):
            mode = self._params[0]
            return (mode or ImageMode.RGB).pixel_dtype
        raise DaftTypeError(f"{self!r} has no inner dtype")

    @property
    def size(self) -> int:
        """Fixed size of fixed_size_list/embedding/fixed_size_binary."""
        if self._id in (TypeId.FIXED_SIZE_LIST, TypeId.EMBEDDING):
            return self._params[1]
        if self._id == TypeId.FIXED_SIZE_BINARY:
            return self._params[0]
        raise DaftTypeError(f"{self!r} has no fixed size")

    @property
    def shape(self) -> Tuple[int, ...]:
        """Trailing (per-row) shape of fixed-shape device-representable types."""
        if self._id == TypeId.FIXED_SHAPE_TENSOR:
            return self._params[1]
        if self._id == TypeId.FIXED_SHAPE_IMAGE:
            mode, h, w = self._params
            return (h, w, mode.num_channels)
        if self._id in (TypeId.EMBEDDING, TypeId.FIXED_SIZE_LIST):
            return (self._params[1],)
        if self.is_numeric() or self.is_boolean():
            return ()
        raise DaftTypeError(f"{self!r} has no static shape")

    @property
    def image_mode(self) -> Optional[ImageMode]:
        if self._id in (TypeId.IMAGE, TypeId.FIXED_SHAPE_IMAGE):
            return self._params[0]
        raise DaftTypeError(f"{self!r} is not an image type")

    @property
    def fields(self) -> "dict[str, DataType]":
        if self._id == TypeId.STRUCT:
            return dict(self._params[0])
        raise DaftTypeError(f"{self!r} is not a struct type")

    @property
    def timeunit(self) -> TimeUnit:
        if self._id in (TypeId.TIME, TypeId.TIMESTAMP, TypeId.DURATION):
            return self._params[0]
        raise DaftTypeError(f"{self!r} has no time unit")

    @property
    def timezone(self) -> Optional[str]:
        if self._id == TypeId.TIMESTAMP:
            return self._params[1]
        raise DaftTypeError(f"{self!r} has no timezone")

    # -- host (Arrow) representation -------------------------------------
    def to_arrow(self) -> pa.DataType:
        """The Arrow storage type backing this dtype on the host."""
        tid = self._id
        if tid in _SIMPLE_ARROW:
            return _SIMPLE_ARROW[tid]
        if tid == TypeId.BFLOAT16:
            # Arrow has no bf16: store raw 2-byte words; device path reinterprets.
            return pa.binary(2)
        if tid == TypeId.DECIMAL128:
            return pa.decimal128(*self._params)
        if tid == TypeId.FIXED_SIZE_BINARY:
            return pa.binary(self._params[0])
        if tid == TypeId.TIME:
            return pa.time64(self._params[0].value)
        if tid == TypeId.TIMESTAMP:
            return pa.timestamp(self._params[0].value, tz=self._params[1])
        if tid == TypeId.DURATION:
            return pa.duration(self._params[0].value)
        if tid == TypeId.INTERVAL:
            return pa.month_day_nano_interval()
        if tid == TypeId.LIST:
            return pa.large_list(self._params[0].to_arrow())
        if tid == TypeId.FIXED_SIZE_LIST:
            return pa.list_(self._params[0].to_arrow(), self._params[1])
        if tid == TypeId.STRUCT:
            return pa.struct([pa.field(n, t.to_arrow()) for n, t in self._params[0]])
        if tid == TypeId.MAP:
            return pa.map_(self._params[0].to_arrow(), self._params[1].to_arrow())
        if tid == TypeId.EMBEDDING:
            return pa.list_(self._params[0].to_arrow(), self._params[1])
        if tid == TypeId.IMAGE:
            # Variable-shape image: struct of flat pixel data + geometry.
            return pa.struct([
                pa.field("data", pa.large_binary()),
                pa.field("channel", pa.uint16()),
                pa.field("height", pa.uint32()),
                pa.field("width", pa.uint32()),
                pa.field("mode", pa.uint8()),
            ])
        if tid == TypeId.FIXED_SHAPE_IMAGE:
            mode, h, w = self._params
            n = h * w * mode.num_channels
            return pa.list_(mode.pixel_dtype.to_arrow(), n)
        if tid == TypeId.TENSOR:
            return pa.struct([
                pa.field("data", pa.large_list(self._params[0].to_arrow())),
                pa.field("shape", pa.large_list(pa.uint64())),
            ])
        if tid == TypeId.FIXED_SHAPE_TENSOR:
            dtype, shape = self._params
            n = int(np.prod(shape)) if shape else 1
            return pa.list_(dtype.to_arrow(), n)
        if tid == TypeId.SPARSE_TENSOR:
            dtype, _shape = self._params
            return pa.struct([
                pa.field("values", pa.large_list(dtype.to_arrow())),
                pa.field("indices", pa.large_list(pa.uint64())),
                pa.field("shape", pa.large_list(pa.uint64())),
            ])
        if tid == TypeId.FILE:
            return pa.struct([
                pa.field("discriminant", pa.uint8()),
                pa.field("data", pa.large_binary()),
                pa.field("url", pa.large_string()),
            ])
        if tid == TypeId.PYTHON:
            raise DaftTypeError("Python dtype has no Arrow representation")
        raise DaftTypeError(f"No Arrow representation for {self!r}")

    @staticmethod
    def from_arrow(t: pa.DataType) -> "DataType":
        """Infer an engine dtype from an Arrow type."""
        if pa.types.is_null(t):
            return DataType.null()
        if pa.types.is_boolean(t):
            return DataType.bool()
        for tid, at in _SIMPLE_ARROW.items():
            if t == at:
                return DataType(tid)
        if pa.types.is_integer(t) or pa.types.is_floating(t):
            return DataType(TypeId(str(t)))  # e.g. "int32" -> INT32
        if pa.types.is_string(t) or pa.types.is_large_string(t) or pa.types.is_string_view(t):
            return DataType.string()
        if pa.types.is_binary(t) or pa.types.is_large_binary(t) or pa.types.is_binary_view(t):
            return DataType.binary()
        if pa.types.is_fixed_size_binary(t):
            return DataType.fixed_size_binary(t.byte_width)
        if pa.types.is_decimal(t):
            return DataType.decimal128(t.precision, t.scale)
        if pa.types.is_date(t):
            return DataType.date()
        if pa.types.is_time(t):
            return DataType.time(TimeUnit.from_str(t.unit))
        if pa.types.is_timestamp(t):
            return DataType.timestamp(TimeUnit.from_str(t.unit), t.tz)
        if pa.types.is_duration(t):
            return DataType.duration(TimeUnit.from_str(t.unit))
        if pa.types.is_interval(t):
            return DataType.interval()
        if pa.types.is_fixed_size_list(t):
            return DataType.fixed_size_list(DataType.from_arrow(t.value_type), t.list_size)
        if pa.types.is_list(t) or pa.types.is_large_list(t) or pa.types.is_list_view(t):
            return DataType.list(DataType.from_arrow(t.value_type))
        if pa.types.is_map(t):
            return DataType.map(DataType.from_arrow(t.key_type), DataType.from_arrow(t.item_type))
        if pa.types.is_struct(t):
            return DataType.struct({f.name: DataType.from_arrow(f.type) for f in t})
        if pa.types.is_dictionary(t):
            return DataType.from_arrow(t.value_type)
        raise DaftTypeError(f"Unsupported Arrow type: {t}")

    @staticmethod
    def from_numpy(dtype: "np.dtype") -> "DataType":
        dtype = np.dtype(dtype)
        if dtype == np.dtype("bool"):
            return DataType.bool()
        name = dtype.name
        if name == "bfloat16":
            return DataType.bfloat16()
        if dtype.kind == "M":  # datetime64
            unit = np.datetime_data(dtype)[0]
            if unit == "D":
                return DataType.date()
            if unit in ("s", "ms", "us", "ns"):
                return DataType.timestamp(unit)
            raise DaftTypeError(f"Unsupported datetime64 unit: {unit}")
        if dtype.kind == "m":  # timedelta64
            unit = np.datetime_data(dtype)[0]
            if unit in ("s", "ms", "us", "ns"):
                return DataType.duration(unit)
            raise DaftTypeError(f"Unsupported timedelta64 unit: {unit}")
        if dtype.kind == "U":
            return DataType.string()
        try:
            return DataType(TypeId(name))
        except ValueError:
            raise DaftTypeError(f"Unsupported numpy dtype: {dtype}") from None

    @staticmethod
    def infer_from_py(value: Any) -> "DataType":
        """Infer a dtype for a single Python value."""
        import datetime

        if value is None:
            return DataType.null()
        if isinstance(value, builtins.bool) or isinstance(value, np.bool_):
            return DataType.bool()
        if isinstance(value, (int, np.integer)):
            return DataType.int64()
        if isinstance(value, (float, np.floating)):
            return DataType.float64()
        if isinstance(value, str):
            return DataType.string()
        if isinstance(value, (bytes, bytearray)):
            return DataType.binary()
        if isinstance(value, datetime.datetime):
            return DataType.timestamp(TimeUnit.US)
        if isinstance(value, datetime.date):
            return DataType.date()
        if isinstance(value, datetime.timedelta):
            return DataType.duration(TimeUnit.US)
        if isinstance(value, np.ndarray):
            if value.ndim >= 1:
                return DataType.tensor(DataType.from_numpy(value.dtype), tuple(value.shape))
            return DataType.from_numpy(value.dtype)
        if isinstance(value, (list, tuple)):
            inner = DataType.null()
            for v in value:
                inner = unify_dtypes(inner, DataType.infer_from_py(v))
            return DataType.list(inner)
        if isinstance(value, dict):
            return DataType.struct({k: DataType.infer_from_py(v) for k, v in value.items()})
        return DataType.python()

    # -- device representation ---------------------------------------------
    def is_device_representable(self) -> builtins.bool:
        """True if values of this dtype are fixed-width and could live densely
        in device memory; in this port every column stays in host Arrow memory
        (reference seam: src/daft-recordbatch/src/lib.rs:1777 ``as_physical``).
        """
        if self.is_numeric() and self._id != TypeId.DECIMAL128:
            return True
        if self._id == TypeId.BOOL:
            return True
        if self._id in (TypeId.EMBEDDING, TypeId.FIXED_SHAPE_TENSOR, TypeId.FIXED_SHAPE_IMAGE):
            return True
        if self._id == TypeId.FIXED_SIZE_LIST:
            return self._params[0].is_device_representable()
        return False

    def to_numpy(self) -> "np.dtype":
        if self._id in _NUMPY_DTYPES:
            return _NUMPY_DTYPES[self._id]
        if self._id == TypeId.BFLOAT16:
            import ml_dtypes

            return np.dtype(ml_dtypes.bfloat16)
        if self._id in (TypeId.EMBEDDING, TypeId.FIXED_SIZE_LIST, TypeId.FIXED_SHAPE_TENSOR):
            return self._params[0].to_numpy()
        if self._id == TypeId.FIXED_SHAPE_IMAGE:
            return self._params[0].pixel_dtype.to_numpy()
        raise DaftTypeError(f"{self!r} has no numpy representation")

def unify_dtypes(a: DataType, b: DataType) -> DataType:
    """Least-common-supertype of two dtypes (reference: supertype resolution in
    src/daft-schema + try_get_supertype in daft-core)."""
    if a == b:
        return a
    if a.is_null():
        return b
    if b.is_null():
        return a
    if a.id == TypeId.UNKNOWN or b.id == TypeId.UNKNOWN:
        return DataType(TypeId.UNKNOWN)
    if a.is_numeric() and b.is_numeric():
        na, nb = a.to_numpy(), b.to_numpy()
        return DataType.from_numpy(np.promote_types(na, nb))
    if a.is_list() and b.is_list():
        return DataType.list(unify_dtypes(a.inner, b.inner))
    if a.is_string() and b.is_string():
        return DataType.string()
    if {a.id, b.id} <= {TypeId.TIMESTAMP, TypeId.DATE}:
        return a if a.id == TypeId.TIMESTAMP else b
    if a.is_struct() and b.is_struct():
        af, bf = a.fields, b.fields
        if set(af) == set(bf):
            return DataType.struct({k: unify_dtypes(af[k], bf[k]) for k in af})
    # Fall back to Python object column.
    return DataType.python()
