"""Free-function expression library (port of ``daft_tpu/functions/__init__.py``).

Reference: daft/functions. The port carries the image functions, thin
wrappers over the kernels of ``kernels/image_ops.py``; the AI functions live
in ``functions/ai.py`` and the file functions in ``functions/media.py``. The
rest of the JAX package's library is ROADMAP A.3.
"""

from __future__ import annotations

from daft_tpu_torch.expressions.expr import FunctionCall, ensure_expr
from daft_tpu_torch.expressions.expression import Expression, lit


def _fn(name: str, *args, **kwargs) -> Expression:
    return Expression(FunctionCall(name, [ensure_expr(a) for a in args], kwargs))


def ensure_expr_wrap(e) -> Expression:
    return e if isinstance(e, Expression) else lit(e)


# -- image (free-function wrappers over image kernels) ---------------------
def resize(e, w: int, h: int):
    return _fn("image_resize", e, w=w, h=h)


def crop(e, bbox):
    return _fn("image_crop", e, bbox=bbox)


def encode_image(e, image_format: str = "PNG"):
    return _fn("image_encode", e, image_format=image_format)


def decode_image(e, mode=None):
    return _fn("image_decode", e, mode=mode)


def convert_image(e, mode: str):
    return _fn("image_to_mode", e, mode=mode)


# -- image accessors (reference: daft/functions/image.py) ------------------
def image_attribute(image, name: str):
    return ensure_expr_wrap(image)._fn("image_attribute", name=name)


def image_width(image):
    return image_attribute(image, "width")


def image_height(image):
    return image_attribute(image, "height")


def image_channel(image):
    return image_attribute(image, "channel")


def image_mode(image):
    return image_attribute(image, "mode")


def image_hash(image, *, method: str = "phash", hash_size: int = 8,
               binbits: int = 3, segments: int = 3):
    """Perceptual image hash -> FixedSizeBinary (reference: image.py
    image_hash; methods: phash/phash_simple/dhash/dhash_vertical/ahash/
    whash/crop_resistant/colorhash)."""
    return ensure_expr_wrap(image)._fn(
        "image_hash", method=method, hash_size=hash_size, binbits=binbits,
        segments=segments)


def image_to_tensor(image):
    return ensure_expr_wrap(image)._fn("to_tensor")
