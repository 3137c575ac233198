"""Where the port's entry points run: on the GPU unless the caller asks for
the CPU. The JAX package picks its backend from JAX's platform list; the port
asks for its device by name and never falls back."""

from __future__ import annotations

import contextlib
import threading
from typing import Union

import torch

from daft_tpu_torch.errors import DaftValueError

DEFAULT_DEVICE = "cuda"


def resolve_device(device: Union[str, torch.device, None] = DEFAULT_DEVICE) -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and no
    CUDA device is visible, and for any device type but cuda and cpu."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise DaftValueError(
                "no CUDA device is visible: the port runs on the GPU by default; "
                "pass device='cpu' to run on the CPU")
        return dev
    if dev.type != "cpu":
        raise DaftValueError(f"the port runs on cuda or cpu, got device {device!r}")
    return dev


_THREAD = threading.local()


def worker_stream():
    """A context that makes the calling thread's own CUDA stream current,
    made on the thread's first call; a no-op where no CUDA device is visible.
    The stage pool runs each morsel under it, so a worker's copies in, its
    programs and its fetch share one stream, and the fetch's synchronisation
    waits for that worker's work only."""
    if not torch.cuda.is_available():
        return contextlib.nullcontext()
    stream = getattr(_THREAD, "stream", None)
    if stream is None:
        stream = _THREAD.stream = torch.cuda.Stream()
    return torch.cuda.stream(stream)
