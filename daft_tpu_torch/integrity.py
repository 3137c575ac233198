"""The spill files' digest check (port of the file-digest part of
``daft_tpu/integrity.py``).

A spill file is stamped with a digest of its raw bytes right after it is
written and verified before it is read back (``execution/spill.py``). A
mismatch raises :class:`~daft_tpu_torch.errors.DaftCorruptionError`, never a
crash deep in Arrow's IPC decode and never a wrong answer, and the file is
renamed to ``<name>.quarantined`` so nothing reads the same bad bytes again.

The digest is the JAX package's block protocol (the byte stream hashed in
blocks of ``BLOCK_BYTES``, so the digest does not depend on how the writer
chunked its writes) in its crc32 flavour (the ``c1-`` prefix), which the JAX
package takes when its kernel hash is unavailable. The port has no native
library, and the kernel hash's numpy form runs at tens of MB/s, too slow for
the gigabytes of spill a TPC-H SF10 query writes; a digest that never leaves
the process need not match the JAX package's. ``integrity_enabled`` gates
the read-side check, ``integrity_verify_on_write`` re-reads each file right
after it is written (``ExecutionConfig``).

Each check counts in the registry (``daft_integrity_verified_total`` /
``_failed_total`` / ``_quarantined_total``), and a mismatch notifies
``CorruptionDetected``. Not ported: the kernel-hash flavour and the content
digest of wire tables, which go with the distributed layer (ROADMAP A.8).
"""

from __future__ import annotations

import logging
import os
import zlib
from typing import Optional

log = logging.getLogger("daft_tpu_torch.integrity")

#: The byte stream is hashed in blocks of this size, chained.
BLOCK_BYTES = 1 << 20

_PREFIX_CRC = "c1"

#: Suffix of a quarantined artifact.
QUARANTINE_SUFFIX = ".quarantined"


def hash_file(path: str) -> str:
    """Digest a file's raw bytes, a block at a time (bounded memory)."""
    crc, nbytes = 0, 0
    with open(path, "rb") as f:
        while True:
            block = f.read(BLOCK_BYTES)
            if not block:
                break
            nbytes += len(block)
            crc = zlib.crc32(block, crc)
    return f"{_PREFIX_CRC}-{nbytes:x}-{crc:08x}"


def _config(cfg):
    if cfg is None:
        from daft_tpu_torch.context import get_context

        cfg = get_context().execution_config
    return cfg


def enabled(cfg=None) -> bool:
    """Is the read-side check on? (Digests are minted either way.)"""
    return _config(cfg).integrity_enabled


def verify_on_write(cfg=None) -> bool:
    return _config(cfg).integrity_verify_on_write


def quarantine(path: str) -> Optional[str]:
    """Rename a corrupt artifact to ``<path>.quarantined``; the new path, or
    None when the rename failed (the file already gone)."""
    qpath = path + QUARANTINE_SUFFIX
    try:
        os.replace(path, qpath)
        return qpath
    except OSError:
        log.warning("failed to quarantine corrupt artifact %s", path, exc_info=True)
        return None


def _record_verified(artifact: str) -> None:
    from daft_tpu_torch import metrics

    if metrics.get_registry().enabled:
        metrics.INTEGRITY_VERIFIED.labels(artifact).inc()


def _record_failure(artifact: str, path: str, expected: str, actual: str,
                    quarantined: bool) -> None:
    from daft_tpu_torch import metrics
    from daft_tpu_torch.context import get_context
    from daft_tpu_torch.subscribers.events import CorruptionDetected

    if metrics.get_registry().enabled:
        metrics.INTEGRITY_FAILED.labels(artifact).inc()
        if quarantined:
            metrics.INTEGRITY_QUARANTINED.labels(artifact).inc()
    try:
        get_context().notify(CorruptionDetected(
            artifact=artifact, path=path, expected=expected, actual=actual,
            action="quarantined" if quarantined else "detected"))
    except Exception:  # noqa: BLE001 — observability must not mask the error
        log.warning("CorruptionDetected event delivery failed", exc_info=True)


def verify_file(path: str, expected: str, artifact: str, cfg=None,
                do_quarantine: bool = True) -> None:
    """Check a file's raw bytes against the digest minted at write. A no-op
    when the check is off or ``expected`` is empty; on a mismatch the file is
    quarantined and :class:`DaftCorruptionError` raised, naming the
    artifact's kind and path."""
    from daft_tpu_torch.errors import DaftCorruptionError

    if not expected or not enabled(cfg):
        return
    actual = hash_file(path)  # an unreadable file raises OSError: not corruption
    if actual == expected:
        _record_verified(artifact)
        return
    qpath = quarantine(path) if do_quarantine else None
    _record_failure(artifact, path, expected, actual, quarantined=qpath is not None)
    raise DaftCorruptionError(
        f"{artifact} artifact failed integrity verification: {path} "
        f"(expected {expected}, got {actual})"
        + (f" [quarantined -> {qpath}]" if qpath else ""),
        artifact=artifact, path=path)
