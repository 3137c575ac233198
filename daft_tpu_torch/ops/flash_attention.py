"""Flash attention for the model towers: a CUDA kernel and its plain version.

``flash_attention(q, k, v)`` is exact non-causal softmax attention over
``(B, T, H, D)`` tensors with scale ``D ** -0.5`` — the function of the Pallas
TPU kernel ``daft_tpu/ops/pallas_attention.py::flash_attention``. On a CUDA
tensor it launches the hand-written kernel in ``csrc/flash_attention.cu``
(bf16: TMA-fed K/V ring and wgmma on the tensor cores; f32: CUDA cores; the
source says what bounds it).
On a CPU tensor it runs ``flash_attention_plain``, the same blockwise online
softmax in torch ops, which autograd differentiates. There is no other route:
a CUDA tensor the kernel does not take raises, and so does a call that
autograd would have to differentiate through the kernel, which has no
backward (``refuse_autograd``).
"""

from __future__ import annotations

import ctypes
import threading

import torch

from daft_tpu_torch.errors import DaftValueError

HEAD_DIMS = (32, 64, 128)
DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_KV = 128
_NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_TMA_MAX_STRIDE = 1 << 40  # bytes

_COUNT_LOCK = threading.Lock()


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          block_q: int = DEFAULT_BLOCK_Q,
                          block_kv: int = DEFAULT_BLOCK_KV) -> torch.Tensor:
    """The plain PyTorch version: for each query block, a loop over key
    blocks with a running max ``m``, denominator ``l`` and accumulator in f32.
    The last key block is cut at T (masking by bounds), so no key is padded."""
    B, T, H, D = q.shape
    scale = D ** -0.5
    qf = q.float().permute(0, 2, 1, 3) * scale   # (B, H, T, D)
    kf = k.float().permute(0, 2, 1, 3)
    vf = v.float().permute(0, 2, 1, 3)
    out = torch.empty((B, H, T, D), dtype=torch.float32, device=q.device)
    for q0 in range(0, T, block_q):
        qb = qf[:, :, q0:q0 + block_q]
        m = torch.full(qb.shape[:-1] + (1,), _NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qb)
        for k0 in range(0, T, block_kv):
            logits = qb @ kf[:, :, k0:k0 + block_kv].transpose(-1, -2)
            m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
            p = torch.exp(logits - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1, keepdim=True)
            acc = acc * corr + p @ vf[:, :, k0:k0 + block_kv]
            m = m_new
        out[:, :, q0:q0 + block_q] = acc / torch.clamp(l, min=1e-30)
    return out.permute(0, 2, 1, 3).to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise DaftValueError(
            f"flash_attention takes q, k, v of one (B, T, H, D) shape; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise DaftValueError(
            f"flash_attention takes float32 or bfloat16 q, k, v of one dtype; got "
            f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise DaftValueError(
            f"q, k, v lie on different devices: {q.device}, {k.device}, {v.device}")
    if q.shape[-1] not in HEAD_DIMS:
        raise DaftValueError(f"flash_attention supports head_dim {HEAD_DIMS}, got {q.shape[-1]}")


def refuse_autograd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise when grad mode is on and any of q, k, v requires grad: the
    kernel writes into a fresh tensor with no ``grad_fn``, so no gradient
    would reach q, k or v and every weight below the attention would get a
    wrong one, silently. The kernel calls it on CUDA tensors; it reads only
    the grad flags, so a test can call it on CPU tensors."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise DaftValueError(
            "flash_attention's CUDA kernel has no backward (the JAX package's pallas_call "
            "has none either): call it under torch.no_grad() or torch.inference_mode(), "
            "or on tensors that do not require grad; a gradient through attention on the "
            "card is ROADMAP A.10.2")


def kernel_strides(t: torch.Tensor) -> tuple:
    """The (B, T, H) element strides the kernel is given. A dimension of size 1
    is never stepped over, so its stride is replaced by the contiguous one:
    whatever torch left there cannot upset the tensor map."""
    B, T, H, D = t.shape
    contiguous = (T * H * D, H * D, D)
    return tuple(c if n == 1 else s for n, s, c in zip((B, T, H), t.stride()[:3], contiguous))


def _check_kernel_layout(t: torch.Tensor, name: str) -> None:
    """The kernel reads rows of D contiguous elements; the bf16 path reads them
    through TMA, so every row must start 16-byte aligned and every stride of
    the tensor map must be a positive multiple of 16 bytes below 2**40."""
    if t.stride(3) != 1:
        raise DaftValueError(f"{name} must be contiguous along head_dim, strides {t.stride()}")
    if t.dtype == torch.bfloat16:
        if t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3]):
            raise DaftValueError(
                f"bf16 {name} rows must be 16-byte aligned (data_ptr % 16 == 0 and B, T, H "
                f"strides multiples of 8); got strides {t.stride()}")
        if not all(0 < s * t.element_size() < _TMA_MAX_STRIDE for s in kernel_strides(t)):
            raise DaftValueError(
                f"bf16 {name} needs positive strides below 2**40 bytes for its tensor map; "
                f"got strides {t.stride()}")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    from daft_tpu_torch.ops import build

    lib = build.load("flash_attention")
    fn = lib.daft_flash_attention
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 9 + [ctypes.c_float, ctypes.c_void_p])
    lib.daft_cuda_error_string.restype = ctypes.c_char_p
    lib.daft_cuda_error_string.argtypes = [ctypes.c_int]
    B, T, H, D = q.shape
    if B > 65535 or H > 65535:
        raise DaftValueError(f"flash_attention kernel grid takes B, H <= 65535; got {B}, {H}")
    o = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(_DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                B, T, H, D, *kernel_strides(q), *kernel_strides(k), *kernel_strides(v),
                D ** -0.5, stream)
    if rc != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: {lib.daft_cuda_error_string(rc).decode()} "
            f"(code {rc}) at q {tuple(q.shape)} {q.dtype}")
    with _COUNT_LOCK:
        flash_attention.launch_count += 1
    return o


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Non-causal attention, q/k/v: (B, T, H, D) -> (B, T, H, D) in q's dtype.

    A CUDA tensor goes to the CUDA kernel (each launch adds one to
    ``flash_attention.launch_count``), and raises where autograd would need
    the kernel's backward (``refuse_autograd``); a CPU tensor goes to
    ``flash_attention_plain``."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    if q.device.type != "cuda":
        raise DaftValueError(f"flash_attention runs on cuda or cpu tensors, got {q.device}")
    refuse_autograd(q, k, v)
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _check_kernel_layout(t, name)
    return _launch(q, k, v)


flash_attention.launch_count = 0
