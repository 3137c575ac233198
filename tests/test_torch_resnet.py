"""The port's ResNet-18 (daft_tpu_torch/models/resnet.py) against the JAX
package's ``ResNet18``, on the CPU, and the whole image slice: encoded bytes
-> decode -> resize -> ResNet-18 in a batch UDF, through both packages.

The JAX model's variables, with seeded random BatchNorm statistics and
perturbed scales and biases (flax's init leaves mean 0, var 1, scale 1,
bias 0, which would hide a BatchNorm mistake), are carried across as numpy
arrays by ``load_flax_resnet``. In f32 the logits agree within 1e-4 of the
largest logit; in bf16 within cosine 0.999 per row (measured worst case on
these inputs: 0.9999966, largest gap 7.1e-3 on logits up to 1.84; one
summation order apart, a bf16 rounding of an activation can flip).
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import daft_tpu
import daft_tpu_torch
from daft_tpu.models.resnet import ResNetConfig as JaxResNetConfig
from daft_tpu.models.resnet import init_resnet_params as jax_init_resnet_params
from daft_tpu.udf import Udf as JaxUdf
from daft_tpu_torch.errors import DaftValueError
from daft_tpu_torch.models import ResNet18, ResNetConfig, init_resnet_params, load_flax_resnet
from daft_tpu_torch.udf import Udf as TorchUdf

F32_TOL = 1e-4        # of max |logit|
BF16_COSINE_MIN = 0.999
TINY = dict(stage_sizes=(1, 1), num_classes=10, width=16)


def _jax_variables(dtype=jnp.float32, seed: int = 0, **cfg):
    """The JAX ResNet18 and its variables as numpy, with seeded BatchNorm
    statistics and scale/bias perturbed off flax's init."""
    model, variables = jax_init_resnet_params(JaxResNetConfig(dtype=dtype, **(cfg or TINY)),
                                              seed)
    rng = np.random.default_rng(seed + 100)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    stats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])

    def perturb(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = perturb(v)
            elif k == "mean":
                out[k] = rng.normal(0, 0.2, v.shape).astype(np.float32)
            elif k == "var":
                out[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
            elif k in ("scale", "bias"):
                out[k] = (v + rng.normal(0, 0.1, v.shape)).astype(np.float32)
            else:
                out[k] = v
        return out

    return model, {"params": perturb(params), "batch_stats": perturb(stats)}


def _logits_both(dtype_j, dtype_t, pixels: np.ndarray, seed: int = 0):
    model, variables = _jax_variables(dtype_j, seed)
    ref = np.asarray(model.apply(variables, jnp.asarray(pixels)))
    port = load_flax_resnet(ResNet18(ResNetConfig(dtype=dtype_t, **TINY)), variables)
    with torch.no_grad():
        got = port(torch.from_numpy(pixels)).numpy()
    return ref, got


def _cosines(a, b):
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


@pytest.mark.parametrize("size", [32, 37, 64])
@pytest.mark.parametrize("kind", ["uint8", "float32"])
def test_f32_logits_match_flax(size, kind):
    """Odd sizes take the stride-2 convolutions and the 1x1 shortcut through
    flax's SAME padding; float input skips the division by 255."""
    rng = np.random.default_rng(size)
    pixels = rng.integers(0, 256, (4, size, size, 3), dtype=np.uint8)
    if kind == "float32":
        pixels = (pixels / 255.0).astype(np.float32)
    ref, got = _logits_both(jnp.float32, torch.float32, pixels, seed=size)
    assert got.dtype == np.float32 and got.shape == (4, 10)
    assert np.abs(got - ref).max() <= F32_TOL * np.abs(ref).max()
    assert np.array_equal(got.argmax(1), ref.argmax(1))


@pytest.mark.parametrize("size", [32, 48])
def test_bf16_logits_match_flax(size):
    pixels = np.random.default_rng(size).integers(0, 256, (6, size, size, 3), dtype=np.uint8)
    ref, got = _logits_both(jnp.bfloat16, torch.bfloat16, pixels, seed=size + 1)
    assert _cosines(ref, got).min() >= BF16_COSINE_MIN


def test_load_fills_every_parameter_and_statistic_and_refuses_a_missing_key():
    _, variables = _jax_variables()
    model = ResNet18(ResNetConfig(**TINY))
    mapped = {t for t, _ in model.flax_names().values()}
    assert mapped == set(model.state_dict())  # parameters and BatchNorm statistics
    for t in mapped:
        model.state_dict()[t].fill_(float("nan"))
    load_flax_resnet(model, variables)
    assert all(bool(torch.isfinite(v).all()) for v in model.state_dict().values())
    assert model.state_dict()["blocks.1.bn_shortcut.var"].tolist() == \
        variables["batch_stats"]["stage1_block0"]["BatchNorm_2"]["var"].tolist()

    missing = {"params": variables["params"], "batch_stats": dict(variables["batch_stats"])}
    del missing["batch_stats"]["stage0_block0"]
    with pytest.raises(DaftValueError, match="missing"):
        load_flax_resnet(model, missing)
    extra = {**variables, "params": {**variables["params"], "extra": {"kernel": np.ones(3)}}}
    with pytest.raises(DaftValueError, match="unknown"):
        load_flax_resnet(model, extra)
    _, other = _jax_variables(stage_sizes=(1, 1), num_classes=7, width=16)
    with pytest.raises(DaftValueError, match="shape"):
        load_flax_resnet(model, other)


def test_default_config_is_torchvision_resnet18():
    """11,689,512 parameters, the flax model's count (and torchvision's)."""
    shapes = jax.eval_shape(
        lambda: jax_init_resnet_params(JaxResNetConfig(), 0)[1]["params"])
    jax_count = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    port = ResNet18(ResNetConfig(), device="meta")
    assert sum(p.numel() for p in port.parameters()) == jax_count == 11_689_512
    assert all(p.dtype == torch.bfloat16 for n, p in port.named_parameters()
               if n.endswith("weight") and p.dim() == 4)


def test_random_init_is_seeded_and_draws_batchnorm_statistics():
    a = init_resnet_params(ResNetConfig(**TINY), seed=3, device="cpu")
    b = init_resnet_params(ResNetConfig(**TINY), seed=3, device="cpu")
    c = init_resnet_params(ResNetConfig(**TINY), seed=4, device="cpu")
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]), k
    assert not torch.equal(a.stem.weight, c.stem.weight)
    assert a.bn.mean.abs().max() > 0 and not torch.equal(a.bn.var, torch.ones_like(a.bn.var))
    assert a.stem.weight.is_contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        out = a(torch.zeros((2, 32, 32, 3), dtype=torch.uint8))
    assert out.shape == (2, 10) and bool(torch.isfinite(out).all())
    if not torch.cuda.is_available():
        with pytest.raises(DaftValueError, match="no CUDA device"):
            init_resnet_params(ResNetConfig(**TINY))


def _slice_bytes(n: int = 16, seed: int = 0) -> list:
    """Seeded mixed-size JPEG (q 90) and PNG images, gradients plus noise."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        h, w = (int(v) for v in rng.integers(24, 80, 2))
        yy, xx = np.mgrid[0:h, 0:w]
        base = np.stack([(xx * 255 / w + c * 60) % 256 for c in range(2)] + [yy * 255 / h],
                        axis=-1)
        arr = np.clip(base + rng.normal(0, 16, base.shape), 0, 255).astype(np.uint8)
        buf = io.BytesIO()
        if i % 4 == 3:
            Image.fromarray(arr).save(buf, format="PNG")
        else:
            Image.fromarray(arr).save(buf, format="JPEG", quality=90)
        out.append(buf.getvalue())
    return out


def test_decode_resize_resnet_slice_matches_the_jax_package():
    """16 encoded images -> decode -> resize(32, 32) -> the tiny ResNet (f32)
    in a batch UDF of 4 rows, through both packages: resized pixels bit-equal,
    logits at the f32 tolerance, top-1 equal."""
    raw = _slice_bytes()
    model, variables = _jax_variables(jnp.float32, seed=11)
    port = load_flax_resnet(ResNet18(ResNetConfig(dtype=torch.float32, **TINY)), variables)

    def jax_logits(s):
        return np.asarray(model.apply(variables, jnp.asarray(s.to_numpy())))

    @torch.no_grad()
    def port_logits(s):
        return port(torch.from_numpy(np.array(s.to_numpy()))).numpy()

    out = {}
    for pkg, udf, fn in ((daft_tpu, lambda f, dt: JaxUdf(f, dt, batch=True, batch_size=4),
                          jax_logits),
                         (daft_tpu_torch, lambda f, dt: TorchUdf(f, dt, batch=True, batch_size=4),
                          port_logits)):
        logits = udf(fn, pkg.DataType.embedding(pkg.DataType.float32(), 10))
        top1 = udf(lambda s, fn=fn: fn(s).argmax(1).astype(np.int64), pkg.DataType.int64())
        img = pkg.col("b").image.decode(mode="RGB").image.resize(32, 32)
        df = (pkg.from_pydict({"b": raw}).with_column("img", img)
              .with_column("logits", logits(pkg.col("img")))
              .with_column("top1", top1(pkg.col("img"))))
        ctx = (pkg.execution_config_ctx(device="cpu", default_morsel_size=8)
               if pkg is daft_tpu_torch else pkg.execution_config_ctx(default_morsel_size=8))
        with ctx:
            assert repr(df.schema["img"].dtype) == "Image[RGB; 32 x 32]"
            out[pkg] = df.to_pydict()
    j, t = out[daft_tpu], out[daft_tpu_torch]
    pixels = np.asarray(t["img"], dtype=np.uint8)
    assert np.array_equal(pixels, np.asarray(j["img"], dtype=np.uint8))
    ref, got = np.asarray(j["logits"], np.float32), np.asarray(t["logits"], np.float32)
    assert got.shape == (16, 10)
    assert np.abs(got - ref).max() <= F32_TOL * np.abs(ref).max()
    assert t["top1"] == j["top1"] == ref.argmax(1).tolist()
