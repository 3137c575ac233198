"""The port's flash attention against the JAX package's.

``flash_attention_plain`` (what ``daft_tpu_torch.ops.flash_attention`` runs on
a CPU tensor) is held against the Pallas kernel in interpret mode and against
``jax.nn.dot_product_attention`` on the same numpy-seeded inputs. The CUDA
kernel itself runs only on a GPU; ``chip_smoke.py`` holds it against
``flash_attention_plain`` there.

Tolerances: 2e-5 in f32 (the same arithmetic, summed in another order) and
3e-2 in bf16 (inputs and output rounded to bf16), as in tests/test_pallas.py.
"""

import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
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


@pytest.mark.parametrize("block", [(128, 128), (64, 32), (300, 7), (64, 64), (128, 64), (64, 16)])
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


@pytest.mark.parametrize("case", [
    "head_dim_stride", "bf16_row_stride", "bf16_offset", "bf16_zero_stride"])
def test_kernel_layout_check(case):
    """What the CUDA kernel cannot read is refused before any launch."""
    if case == "head_dim_stride":
        t = torch.zeros(1, 4, 2, 64).transpose(2, 3)[..., :32]
    elif case == "bf16_row_stride":  # T stride 68: rows not 16-byte aligned
        t = torch.zeros(1, 4, 68, dtype=torch.bfloat16)[..., :64].unflatten(-1, (2, 32))
    elif case == "bf16_offset":  # strides fine, data pointer 2 bytes off
        t = torch.zeros(1, 4, 72, dtype=torch.bfloat16)[..., 1:65].unflatten(-1, (2, 32))
    else:  # one row repeated over T: a zero stride the tensor map cannot take
        t = torch.zeros(1, 1, 2, 32, dtype=torch.bfloat16).expand(1, 4, 2, 32)
    with pytest.raises(DaftValueError):
        fa._check_kernel_layout(t, "q")


@pytest.mark.parametrize("D", [32, 64, 128])
def test_tma_layout_of_fused_qkv_view(D):
    """q, k and v are views into one (B, T, 3*H*D) projection: the tensor map
    steps H by D elements, T by 3*H*D and B by T*3*H*D, each a multiple of 16
    bytes in bf16."""
    B, T, H = 2, 257, 16
    x = torch.zeros(B, T, 3 * H * D, dtype=torch.bfloat16)
    for t in (x[..., i * H * D:(i + 1) * H * D].view(B, T, H, D) for i in range(3)):
        fa._check_kernel_layout(t, "q")
        assert fa.kernel_strides(t) == (T * 3 * H * D, 3 * H * D, D)
        assert all(s * t.element_size() % 16 == 0 for s in fa.kernel_strides(t))


def test_tma_layout_of_contiguous_and_size_one_dims():
    t = torch.zeros(3, 5, 4, 64, dtype=torch.bfloat16)
    assert fa.kernel_strides(t) == (5 * 4 * 64, 4 * 64, 64)
    # A size-1 dim is never stepped over: its stride is replaced by the contiguous one.
    one = torch.zeros(1, 4, 7, 64, dtype=torch.bfloat16).transpose(1, 2)[:, :1]
    assert one.shape == (1, 1, 4, 64)
    assert fa.kernel_strides(one) == (4 * 64, 4 * 64, 7 * 64)
    fa._check_kernel_layout(one, "q")


def test_bf16_kernel_is_tma_and_wgmma():
    """The bf16 path loads through TMA into an mbarrier ring and multiplies
    with wgmma; the mma.sync kernel and its transposed V tile are gone."""
    src = (build.CSRC_DIR / "flash_attention.cu").read_text()
    header = (build.CSRC_DIR / "hopper.cuh").read_text()
    assert "mma.sync" not in src + header and "svt" not in src
    assert "cp.async.bulk.tensor.4d" in header and "mbarrier.try_wait" in header
    assert "wgmma.mma_async" in header
    assert "wgmma_ss<N>" in src and "wgmma_rs<D>" in src
    assert "kStages = " in src and "#include \"hopper.cuh\"" in src


# Mangled as ptxas prints them for sm_90a (the anonymous namespace carries a
# per-file tag), plus a short form and a name that is not mangled.
_ANON = "_ZN51_GLOBAL__N__19600c2d_18_flash_attention_cu_609588cb"


@pytest.mark.parametrize("mangled,name", [
    (_ANON + "19attn_bf16_tma_wgmmaILi32EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16iif",
     "attn_bf16_tma_wgmma<32>"),
    (_ANON + "19attn_bf16_tma_wgmmaILi64EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16iif",
     "attn_bf16_tma_wgmma<64>"),
    (_ANON + "19attn_bf16_tma_wgmmaILi128EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16iif",
     "attn_bf16_tma_wgmma<128>"),
    (_ANON + "15attn_f32_kernelILi64EEEvPKfS2_S2_Pfiii7StridesS3_S3_f", "attn_f32_kernel<64>"),
    ("_ZN12_GLOBAL__N_115attn_f32_kernelILi32EEEvPKfS2_S2_Pfiii7StridesS3_S3_f",
     "attn_f32_kernel<32>"),
    ("_Z6kernelILi2ELb1ELin3EEvv", "kernel<2, 1, -3>"),
    ("daft_plain_c_kernel", "daft_plain_c_kernel"),
])
def test_chip_smoke_kernel_name(mangled, name):
    line = f"ptxas info    : Compiling entry function '{mangled}' for 'sm_90a'"
    assert chip_smoke.kernel_name(line) == name


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setattr(build, "DEFAULT_NVCC", "/nonexistent/bin/nvcc")
    with pytest.raises(build.KernelBuildError, match="nvcc not found"):
        build._nvcc()


def test_kernel_sources_and_library_names():
    assert build.kernel_names() == ["flash_attention"]
    path = build.library_path("flash_attention")
    assert path.parent == build.BUILD_DIR and path.name.startswith("libflash_attention-")


@pytest.mark.parametrize("edit", ["hopper.cuh", "flash_attention.cu"])
def test_library_name_covers_source_and_headers(edit, tmp_path, monkeypatch):
    """An edited shared header builds anew, like an edited source."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, csrc)
    monkeypatch.setattr(build, "CSRC_DIR", csrc)
    before = build.library_path("flash_attention")
    assert build.library_path("flash_attention") == before
    with open(csrc / edit, "a") as f:
        f.write("\n// edited\n")
    after = build.library_path("flash_attention")
    assert after != before and after.name.startswith("libflash_attention-")


def test_module_imports_without_nvcc_or_gpu():
    """Importing the op module builds nothing and needs no GPU."""
    code = ("import daft_tpu_torch.ops.flash_attention as m, daft_tpu_torch.ops.build as b; "
            "assert m.flash_attention.launch_count == 0; assert b._LIBS == {}")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
