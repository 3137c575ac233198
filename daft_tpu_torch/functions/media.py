"""Typed-file and image-file functions (port of the file part of
``daft_tpu/functions/media.py``).

Reference: daft/functions/{file_.py,image_file_.py}. The File constructors
verify format by magic-byte sniffing (``kernels/file_ops.py``). They take no
``io_config``: ``File`` reads local paths and ``file://`` URLs only (remote
schemes are ROADMAP A.8). The video, audio, HDF5 and ``run_process``
functions of the JAX module are ROADMAP A.3.5.
"""

from __future__ import annotations

from typing import Optional

from daft_tpu_torch.expressions.expression import Expression, col


def _fref(url, kind=None, verify: bool = False) -> Expression:
    e = url if isinstance(url, Expression) else col(url)
    return e._fn("file_ref", kind=kind, verify=verify)


def file(url) -> Expression:
    """String path/URL (or inline bytes) -> File reference column
    (reference: daft/functions/file_.py file)."""
    return _fref(url)


def image_file(url, verify: bool = False) -> Expression:
    """String -> File[Image] (reference: file_.py image_file)."""
    return _fref(url, "image", verify)


def decode_image_file(file_expr: Expression, mode: Optional[str] = None,
                      on_error: str = "raise") -> Expression:
    """File -> decoded Image column (reference: image_file_.py
    decode_image_file)."""
    return file_expr._fn("decode_image_file", mode=mode, on_error=on_error)


def image_file_metadata(file_expr: Expression) -> Expression:
    """File -> struct{width, height, format, mode} without decoding pixels
    (reference: image_file_.py image_file_metadata)."""
    return file_expr._fn("image_file_metadata")
