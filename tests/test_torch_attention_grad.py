"""Flash attention under autograd (ROADMAP C.45), on the CPU.

The CUDA kernel writes into a fresh tensor with no ``grad_fn``, so a call
that autograd would have to differentiate through it raises
(``refuse_autograd``; the card's side is checked by ``chip_smoke.py``). The
plain version on CPU tensors differentiates: its gradients equal
``torch.func``'s over the plain softmax formula within 1e-5 (f32, another
order of summation), as the JAX package's attention differentiates through
XLA.
"""

import numpy as np
import pytest
import torch

from daft_tpu_torch.errors import DaftValueError
from daft_tpu_torch.ops.flash_attention import flash_attention, refuse_autograd

TOL = 1e-5


def _qkv(requires_grad: bool, B=2, T=40, H=2, D=32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((B, T, H, D), generator=g).requires_grad_(requires_grad)
            for _ in range(3)]


def test_the_guard_raises_on_tensors_that_require_grad():
    q, k, v = _qkv(True)
    with pytest.raises(DaftValueError, match=r"no backward.*ROADMAP A\.10\.2"):
        refuse_autograd(q, k, v)
    with pytest.raises(DaftValueError, match="no backward"):
        refuse_autograd(q.detach(), k.detach(), v)  # one is enough


@pytest.mark.parametrize("mode", ["no_grad", "inference_mode", "frozen"])
def test_the_guard_lets_inference_through(mode):
    q, k, v = _qkv(mode != "frozen")
    if mode == "no_grad":
        with torch.no_grad():
            refuse_autograd(q, k, v)
    elif mode == "inference_mode":
        with torch.inference_mode():
            refuse_autograd(q, k, v)
    else:
        refuse_autograd(q, k, v)


def _dense(q, k, v):
    s = torch.einsum("bthd,bshd->bhts", q, k) * q.shape[-1] ** -0.5
    return torch.einsum("bhts,bshd->bthd", torch.softmax(s, dim=-1), v)


def test_the_cpu_path_gives_the_gradient_of_the_plain_formula():
    q, k, v = _qkv(True)
    w = torch.randn(q.shape, generator=torch.Generator().manual_seed(1))
    (flash_attention(q, k, v) * w).sum().backward()
    want = torch.func.grad(lambda a, b, c: (_dense(a, b, c) * w).sum(), argnums=(0, 1, 2))(
        q.detach(), k.detach(), v.detach())
    for got, ref in zip((q.grad, k.grad, v.grad), want):
        torch.testing.assert_close(got, ref, rtol=TOL, atol=TOL)


def test_no_tower_runs_attention_with_grad(monkeypatch):
    """The providers' towers are frozen and run under inference mode: the
    image tower's forward leaves its attention's inputs without grad."""
    from daft_tpu_torch.ai.cuda_provider import CUDACLIPImageEmbedder
    from daft_tpu_torch.models import layers

    inst = CUDACLIPImageEmbedder("tiny", batch_size=4, device="cpu")
    assert not any(p.requires_grad for p in inst.encoder.parameters())
    seen = []
    real = layers.flash_attention

    def spy(q, k, v):
        seen.append(torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)))
        return real(q, k, v)

    monkeypatch.setattr(layers, "flash_attention", spy)
    inst.embed_image(np.zeros((4, 32, 32, 3), np.uint8))
    assert seen and not any(seen)
