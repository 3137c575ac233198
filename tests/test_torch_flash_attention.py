"""The port's flash attention against the JAX package's.

``flash_attention_plain`` (what ``daft_tpu_torch.ops.flash_attention`` runs on
a CPU tensor) is held against the Pallas kernel in interpret mode and against
``jax.nn.dot_product_attention`` on the same numpy-seeded inputs. The CUDA
kernel itself runs only on a GPU; ``chip_smoke.py`` holds it against
``flash_attention_plain`` there.

Tolerances: 2e-5 in f32 (the same arithmetic, summed in another order) and
3e-2 in bf16 (inputs and output rounded to bf16), as in tests/test_pallas.py.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from daft_tpu.ops.pallas_attention import flash_attention as pallas_flash_attention
from daft_tpu_torch.errors import DaftValueError
from daft_tpu_torch.ops import build
from daft_tpu_torch.ops import flash_attention as fa

F32_TOL = 2e-5
BF16_TOL = 3e-2


def _qkv(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(dtype) for _ in range(3)]


@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("T", [5, 128, 257, 300])
def test_plain_matches_pallas_kernel_f32(T, D):
    q, k, v = _qkv((2, T, 4, D), seed=T + D)
    ref = pallas_flash_attention(*[jnp.asarray(a) for a in (q, k, v)], interpret=True)
    out = fa.flash_attention_plain(*[torch.from_numpy(a) for a in (q, k, v)])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("T", [5, 128, 257, 300])
def test_plain_matches_dot_product_attention_f32(T, D):
    q, k, v = _qkv((2, T, 4, D), seed=T * D)
    ref = jax.nn.dot_product_attention(*[jnp.asarray(a) for a in (q, k, v)])
    out = fa.flash_attention_plain(*[torch.from_numpy(a) for a in (q, k, v)])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=F32_TOL, rtol=F32_TOL)


def test_plain_matches_pallas_kernel_bf16():
    q, k, v = _qkv((1, 200, 2, 64), seed=1)
    ref = pallas_flash_attention(*[jnp.asarray(a, dtype=jnp.bfloat16) for a in (q, k, v)],
                                 interpret=True)
    out = fa.flash_attention_plain(*[torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)])
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, dtype=np.float32),
                               atol=BF16_TOL, rtol=BF16_TOL)


@pytest.mark.parametrize("block", [(128, 128), (64, 32), (300, 7)])
def test_plain_block_sizes_agree(block):
    """The block loop and the bounds masking of the last block give the same
    attention whatever the block sizes."""
    q, k, v = (torch.from_numpy(a) for a in _qkv((2, 257, 2, 32), seed=3))
    base = fa.flash_attention_plain(q, k, v)
    out = fa.flash_attention_plain(q, k, v, block_q=block[0], block_kv=block[1])
    torch.testing.assert_close(out, base, atol=F32_TOL, rtol=F32_TOL)


def test_wrapper_takes_plain_version_on_cpu_tensors():
    q, k, v = (torch.from_numpy(a) for a in _qkv((2, 40, 2, 32), seed=4))
    before = fa.flash_attention.launch_count
    torch.testing.assert_close(fa.flash_attention(q, k, v), fa.flash_attention_plain(q, k, v),
                               atol=0, rtol=0)
    assert fa.flash_attention.launch_count == before


def test_wrapper_reads_strided_views():
    """The model hands the wrapper views into one fused qkv projection."""
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(2, 9, 3 * 64)).astype(np.float32))
    q, k, v = (t.view(2, 9, 2, 32) for t in x.split(64, dim=-1))
    assert not q.is_contiguous()
    torch.testing.assert_close(fa.flash_attention(q, k, v),
                               fa.flash_attention_plain(*(t.contiguous() for t in (q, k, v))))


@pytest.mark.parametrize("case", ["head_dim", "shape", "dtype", "mixed_dtype", "device"])
def test_wrapper_rejects_what_it_does_not_take(case):
    q = torch.zeros(1, 4, 2, 32)
    k, v = q.clone(), q.clone()
    if case == "head_dim":
        q = k = v = torch.zeros(1, 4, 2, 48)
    elif case == "shape":
        k = torch.zeros(1, 5, 2, 32)
    elif case == "dtype":
        q, k, v = (t.half() for t in (q, k, v))
    elif case == "mixed_dtype":
        k = k.to(torch.bfloat16)
    elif case == "device":
        q, k, v = (t.to("meta") for t in (q, k, v))
    with pytest.raises(DaftValueError):
        fa.flash_attention(q, k, v)


@pytest.mark.parametrize("case", ["head_dim_stride", "bf16_row_stride", "bf16_offset"])
def test_kernel_layout_check(case):
    """What the CUDA kernel cannot read is refused before any launch."""
    if case == "head_dim_stride":
        t = torch.zeros(1, 4, 2, 64).transpose(2, 3)[..., :32]
    elif case == "bf16_row_stride":  # T stride 68: rows not 16-byte aligned
        t = torch.zeros(1, 4, 68, dtype=torch.bfloat16)[..., :64].unflatten(-1, (2, 32))
    else:  # strides fine, data pointer 2 bytes off
        t = torch.zeros(1, 4, 72, dtype=torch.bfloat16)[..., 1:65].unflatten(-1, (2, 32))
    with pytest.raises(DaftValueError):
        fa._check_kernel_layout(t, "q")


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setattr(build, "DEFAULT_NVCC", "/nonexistent/bin/nvcc")
    with pytest.raises(build.KernelBuildError, match="nvcc not found"):
        build._nvcc()


def test_kernel_sources_and_library_names():
    assert build.kernel_names() == ["flash_attention"]
    path = build.library_path("flash_attention")
    assert path.parent == build.BUILD_DIR and path.name.startswith("libflash_attention-")


def test_module_imports_without_nvcc_or_gpu():
    """Importing the op module builds nothing and needs no GPU."""
    code = ("import daft_tpu_torch.ops.flash_attention as m, daft_tpu_torch.ops.build as b; "
            "assert m.flash_attention.launch_count == 0; assert b._LIBS == {}")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
