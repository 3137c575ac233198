"""Entry point (port of ``__graft_entry__.entry``).

``entry()`` returns the flagship forward — the CLIP ViT-L/14 image tower
with L2-normalised output — and example arguments for it. Not ported yet:
``dryrun_multichip``'s CLIP training step over a dp x tp mesh (ROADMAP
A.10.2: it needs a gradient through attention, which the card's kernel does
not have). Its engine and ring sections have their counterparts in
``parallel/`` and ``ops/ring_attention.py``.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import torch

from daft_tpu_torch.device import DEFAULT_DEVICE, resolve_device


def entry(device: Any = DEFAULT_DEVICE, seed: int = 0) -> Tuple[Callable, tuple]:
    """(fn, example_args): ``fn(pixels)`` embeds a (B, 224, 224, 3) uint8 batch
    with random ViT-L/14 weights made from ``seed`` on ``device``."""
    from daft_tpu_torch.models.clip import CLIPConfig, CLIPImageEncoder, embed, init_random_

    dev = resolve_device(device)
    cfg = CLIPConfig.vit_l_14()
    encoder = CLIPImageEncoder(cfg, device=dev)
    init_random_(encoder, torch.Generator(dev).manual_seed(seed))
    encoder.eval().requires_grad_(False)

    def forward(pixels: torch.Tensor) -> torch.Tensor:
        return embed(encoder, pixels)

    pixels = torch.zeros((8, cfg.image_size, cfg.image_size, 3), dtype=torch.uint8, device=dev)
    return forward, (pixels,)
