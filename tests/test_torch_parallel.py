"""The port's mesh and tensor-parallel placement against the JAX package's,
on the CPU.

The mirror of ``tests/test_parallel.py``, with ``visible_devices`` patched to
eight ``torch.device("cpu")`` entries (the JAX package's eight virtual CPU
devices). ``match_partition_rules`` gives, key for key, the JAX package's
specs over the same tiny CLIP weights (its ``PartitionSpec``s turned into
tuples here). A tensor-parallel forward equals the unsharded one: within
2e-2 in bf16 (the JAX test's tolerance), within 1e-5 in f32 (a row shard's
partial products are summed in another order). ``test_graft_entry_dryrun``
and ``test_graft_entry_compiles`` drive ``__graft_entry__.dryrun_multichip``'s
CLIP training step, which waits for ROADMAP A.10.2 (a gradient through
attention on the card), so they have no mirror here.
"""

import dataclasses
import json
import subprocess
import sys

import flax.serialization as fs
import flax.traverse_util as tu
import jax
import numpy as np
import pytest
import torch

from daft_tpu.models.clip import CLIPConfig as JaxCLIPConfig
from daft_tpu.models.clip import init_clip_params
from daft_tpu.parallel.mesh import DEFAULT_TP_RULES as JAX_TP_RULES
from daft_tpu.parallel.mesh import make_mesh as jax_make_mesh
from daft_tpu.parallel.mesh import match_partition_rules as jax_match_partition_rules
from daft_tpu_torch.errors import DaftValueError
from daft_tpu_torch.models.clip import CLIPConfig, CLIPImageEncoder, CLIPModel, init_random_
from daft_tpu_torch.models.clip import load_flax_params
from daft_tpu_torch.models.layers import ShardedLinear
from daft_tpu_torch.parallel import replica
from daft_tpu_torch.parallel.mesh import (
    DEFAULT_TP_RULES,
    flax_shapes,
    make_mesh,
    match_partition_rules,
    shard_module_,
)

BF16_TOL = 2e-2
F32_TOL = 1e-5


@pytest.fixture(autouse=True)
def eight_devices(monkeypatch):
    devices = [torch.device("cpu") for _ in range(8)]
    monkeypatch.setattr(replica, "visible_devices", lambda: list(devices))
    return devices


def _tower(cfg: CLIPConfig, seed: int = 0) -> CLIPImageEncoder:
    enc = CLIPImageEncoder(cfg, device="cpu")
    init_random_(enc, torch.Generator().manual_seed(seed))
    return enc.eval().requires_grad_(False)


# -- the mirrors of tests/test_parallel.py ------------------------------------------
def test_make_mesh():
    mesh = make_mesh({"dp": 2, "tp": 4})
    assert mesh.shape == {"dp": 2, "tp": 4}
    mesh2 = make_mesh({"dp": -1, "tp": 2})
    assert mesh2.shape["dp"] == 4
    with pytest.raises(DaftValueError, match=r"needs 16 devices, have 8"):
        make_mesh({"dp": 4, "tp": 4})


def test_shard_clip_params():
    enc = _tower(CLIPConfig.tiny())
    mesh = make_mesh({"dp": 2, "tp": 2})
    specs = shard_module_(enc, mesh)
    # qkv kernels must be tp-sharded on the output dim
    qkv_specs = [s for name, s in specs.items() if "qkv" in name]
    assert any(s == (None, "tp") for s in qkv_specs)
    assert all(isinstance(b.attn.qkv, ShardedLinear) and len(b.attn.qkv.weights) == 2
               for b in enc.blocks)


def test_sharded_forward_matches_single_device():
    cfg = CLIPConfig.tiny()
    enc = _tower(cfg)
    px = torch.zeros((4, cfg.image_size, cfg.image_size, 3), dtype=torch.uint8)
    with torch.inference_mode():
        ref = enc(px)
    shard_module_(enc, make_mesh({"dp": 2, "tp": 2}))
    with torch.inference_mode():
        out = enc(px)
    np.testing.assert_allclose(ref.numpy(), out.numpy(), rtol=BF16_TOL, atol=BF16_TOL)


# -- the port's own --------------------------------------------------------------
def test_specs_match_the_jax_package_key_for_key():
    """The JAX package's tiny CLIP params over its dp2 x tp4 mesh, and the
    same weights carried into the port's CLIPModel over its own."""
    assert jax.device_count() >= 8
    _, params = init_clip_params(JaxCLIPConfig.tiny(), seed=0)
    jax_mesh = jax_make_mesh({"dp": 2, "tp": 4})
    jax_specs = jax_match_partition_rules(JAX_TP_RULES, params, jax_mesh)
    want = {"/".join(str(getattr(k, "key", k)) for k in path): tuple(spec)
            for path, spec in jax.tree_util.tree_flatten_with_path(jax_specs)[0]}
    flat = {k: np.asarray(v)
            for k, v in tu.flatten_dict(fs.to_state_dict(params), sep="/").items()}
    model = CLIPModel(CLIPConfig.tiny(), device="cpu")
    load_flax_params(model, flat)
    shapes = {"params/" + k: s for k, s in flax_shapes(model).items()}
    assert shapes == {k: tuple(v.shape) for k, v in flat.items()}
    got = match_partition_rules(DEFAULT_TP_RULES, shapes, make_mesh({"dp": 2, "tp": 4}))
    assert got == want
    assert got["params/vision/block_0/attn/qkv/kernel"] == (None, "tp")
    assert got["params/vision/block_0/mlp/fc2/kernel"] == ("tp", None)
    assert got["params/logit_scale"] == ()


def test_rules_drop_axes_that_do_not_divide_and_name_missing_axes():
    shapes = {"a/attn/qkv/kernel": (64, 6), "b/mlp/fc2/kernel": (8, 64), "scalar": (),
              "one/mlp/fc1/kernel": (1, 1), "bias": (6,)}
    mesh = make_mesh({"tp": 4})
    assert match_partition_rules(DEFAULT_TP_RULES, shapes, mesh) == {
        "a/attn/qkv/kernel": (None, None), "b/mlp/fc2/kernel": ("tp", None), "scalar": (),
        "one/mlp/fc1/kernel": (), "bias": (None,)}
    # Without a mesh the rules apply as written.
    assert match_partition_rules(DEFAULT_TP_RULES, shapes)["a/attn/qkv/kernel"] == (None, "tp")
    with pytest.raises(DaftValueError, match="names axis 'tp'"):
        match_partition_rules(DEFAULT_TP_RULES, shapes, make_mesh({"dp": 8}))


def test_shard_module_refuses_what_it_cannot_split():
    enc = _tower(CLIPConfig.tiny())
    with pytest.raises(DaftValueError, match="does not shard"):
        shard_module_(enc, make_mesh({"tp": 2}), [(r".*ln_pre/scale", ("tp",)), (r".*", ())])
    with pytest.raises(DaftValueError, match="does not shard"):
        shard_module_(enc, make_mesh({"dp": 2, "tp": 2}), [(r".*attn/qkv/kernel", ("dp", "tp"))])


def test_tp_1_keeps_every_layer():
    enc = _tower(CLIPConfig.tiny())
    shard_module_(enc, make_mesh({"tp": 1}))
    assert not any(isinstance(m, ShardedLinear) for m in enc.modules())


F32_TINY = dataclasses.replace(CLIPConfig.tiny(), dtype=torch.float32)


@pytest.mark.parametrize("axes", [{"tp": 4}, {"dp": 2, "tp": 4}], ids=["tp4", "dp2_tp4"])
def test_f32_sharded_forward_equals_the_unsharded(monkeypatch, axes):
    from daft_tpu_torch.ai.cuda_provider import CUDACLIPImageEmbedder

    monkeypatch.setattr(CLIPConfig, "tiny", staticmethod(lambda: F32_TINY))
    imgs = np.random.default_rng(0).integers(0, 256, (21, 32, 32, 3), dtype=np.uint8)
    ref = CUDACLIPImageEmbedder("tiny", batch_size=8, device="cpu").embed_image(imgs)
    inst = CUDACLIPImageEmbedder("tiny", batch_size=8, device="cpu", mesh_axes=axes)
    out = inst.embed_image(imgs)
    assert inst.mesh.shape == axes and len(inst.replicas) == axes.get("dp", 1)
    # chunks of 8, 8 and 5 rows, the last padded to 8 (a multiple of dp)
    assert inst.last_forward_stats["chunks"] == 3
    for tower in inst.replicas:
        assert isinstance(tower.blocks[0].mlp.fc2, ShardedLinear)
        assert tower.blocks[0].mlp.fc2.kind == "row" and len(tower.blocks[0].mlp.fc2.weights) == 4
    np.testing.assert_allclose(out, ref, atol=F32_TOL, rtol=F32_TOL)


def test_shard_bytes_split_the_dense_layers():
    from daft_tpu_torch.parallel.mesh import shard_bytes

    enc = _tower(CLIPConfig.tiny())
    whole = sum(p.numel() * p.element_size() for p in enc.parameters())
    shard_module_(enc, make_mesh({"tp": 2}))
    held = shard_bytes(enc, 2)
    assert sum(held) == whole and held[0] > held[1] > 0


def test_new_modules_import_no_jax_and_nothing_of_daft_tpu():
    code = (
        "import json, sys\n"
        "before = set(sys.modules)\n"
        "import daft_tpu_torch.parallel, daft_tpu_torch.parallel.replica\n"
        "import daft_tpu_torch.parallel.mesh, daft_tpu_torch.ops.ring_attention\n"
        "import daft_tpu_torch.perf_report, daft_tpu_torch.tools.ring_world\n"
        "new = set(sys.modules) - before\n"
        "print(json.dumps(sorted(m for m in new if m.split('.')[0] in\n"
        "                        ('jax', 'jaxlib', 'flax', 'optax', 'daft_tpu'))))\n")
    out = subprocess.run([sys.executable, "-c", code], check=True, capture_output=True,
                         text=True, timeout=120)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
