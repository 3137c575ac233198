"""Where the port's entry points run: on the GPU unless the caller asks for
the CPU. The JAX package picks its backend from JAX's platform list; the port
asks for its device by name and never falls back."""

from __future__ import annotations

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
