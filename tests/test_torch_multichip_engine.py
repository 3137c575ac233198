"""Multi-device inference through the port's engine, on the CPU.

The mirror of ``tests/test_multichip_engine.py``: ``chips_per_replica``
partitions the visible devices into replica slots, each slot gets a provider
instance of its own, and ``mesh_axes`` splits an instance's tower over its
slot (dp rows, tp shards). ``visible_devices`` is patched to eight
``torch.device("cpu")`` entries, the counterpart of the JAX package's eight
virtual CPU devices (``--xla_force_host_platform_device_count=8``); the
entries are one device, so a slot is told apart from another by the
entries' identity. The engine rows are held against the JAX package's rows
over the same tiny CLIP weights at the bf16 tolerance of
``tests/test_torch_engine.py`` (3e-2); with and without
``chips_per_replica=1`` the port's rows are the same bytes.
"""

import threading

import flax.serialization as fs
import flax.traverse_util as tu
import jax
import numpy as np
import pytest
import torch

import daft_tpu
import daft_tpu_torch
from daft_tpu.functions.ai import embed_image as jax_embed_image
from daft_tpu.models.clip import CLIPConfig as JaxCLIPConfig
from daft_tpu.models.clip import init_clip_params
from daft_tpu_torch import col
from daft_tpu_torch.datatype import DataType
from daft_tpu_torch.errors import DaftValueError
from daft_tpu_torch.functions.ai import embed_image
from daft_tpu_torch.parallel import replica

BF16_TOL = 3e-2
DEVICES = 8


@pytest.fixture
def eight_devices(monkeypatch):
    devices = [torch.device("cpu") for _ in range(DEVICES)]
    monkeypatch.setattr(replica, "visible_devices", lambda: list(devices))
    return devices


def _image_df(n=48, size=224):
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 255, (n, size * size * 3), dtype=np.uint8)
    series = daft_tpu_torch.Series.from_numpy(imgs, "img", DataType.image("RGB", size, size))
    return daft_tpu_torch.from_pydict({"img": series, "i": list(range(n))})


# -- the mirrors of tests/test_multichip_engine.py --------------------------------
def test_replica_slots_partition_devices(eight_devices):
    from daft_tpu_torch.parallel.replica import ReplicaSlots, replica_devices

    slots = ReplicaSlots(4)
    assert slots.num_replicas == 2
    assert all(len(g) == 4 for g in slots.groups)
    assert {id(d) for d in slots.groups[0]}.isdisjoint(id(d) for d in slots.groups[1])
    seen = {}

    def probe():
        devs = replica_devices()
        seen[tuple(id(d) for d in devs)] = True
        return len(devs)

    assert slots.run(probe) == 4
    # outside any scope: all devices
    assert len(replica_devices()) == DEVICES


def test_embed_image_engine_path_dp_tp_mesh(eight_devices):
    """read -> UDFProject(embed_image, chips_per_replica=8, dp x tp mesh) ->
    collect: one replica owning all eight entries, the Dense layers split
    over tp, the chunks over dp."""
    df = _image_df()
    expr = embed_image(col("img"), provider="cuda_random", model="ViT-B/32", batch_size=16,
                       chips_per_replica=8, mesh_axes={"dp": 2, "tp": 4}, device="cpu")
    out = df.with_column("emb", expr).select("i", "emb").to_pydict()
    assert len(out["emb"]) == 48
    assert len(out["emb"][0]) == 512  # ViT-B/32 embed dim
    norms = [float(np.linalg.norm(e)) for e in out["emb"]]
    assert all(abs(n - 1.0) < 1e-2 for n in norms)


def test_embed_image_engine_path_two_replicas(eight_devices):
    """chips_per_replica=4 on eight entries -> 2 concurrent replicas."""
    df = _image_df(n=64)
    expr = embed_image(col("img"), provider="cuda_random", model="ViT-B/32", batch_size=16,
                       chips_per_replica=4, device="cpu")
    out = df.with_column("emb", expr).select("emb").to_pydict()
    assert len(out["emb"]) == 64


def test_params_actually_sharded_on_mesh(eight_devices):
    """Inside a replica scope the provider's tower lives on the scope's
    entries with its qkv split over tp."""
    from daft_tpu_torch.ai.cuda_provider import CUDACLIPImageEmbedder
    from daft_tpu_torch.models.layers import ShardedLinear
    from daft_tpu_torch.parallel.replica import replica_scope

    devs = eight_devices[:4]
    with replica_scope(0, devs):
        emb = CUDACLIPImageEmbedder("ViT-B/32", batch_size=8, mesh_axes={"dp": 1, "tp": 4},
                                    device="cpu")
    assert emb.mesh is not None and emb.mesh.devices.size == 4
    assert [id(d) for d in emb.mesh.devices.flat] == [id(d) for d in devs]
    qkv = [m.attn.qkv for m in emb.encoder.blocks]
    assert qkv and all(isinstance(m, ShardedLinear) and m.kind == "column" for m in qkv)
    assert all(len(m.weights) == 4 and [id(d) for d in m.devices] == [id(d) for d in devs]
               for m in qkv)  # tp actually split it
    assert emb.param_specs["block_0/attn/qkv/kernel"] == (None, "tp")
    # a batch stages and the forward runs
    out = emb.embed_image(np.zeros((8, 224, 224, 3), np.uint8))
    assert out.shape == (8, 512)


def test_chips_per_replica_caps_concurrency(eight_devices):
    """8 entries / chips_per_replica=8 -> exactly one replica slot."""
    from daft_tpu_torch.parallel.replica import ReplicaSlots

    slots = ReplicaSlots(8)
    assert slots.num_replicas == 1
    slots3 = ReplicaSlots(3)  # non-dividing: floor(8/3) = 2 replicas
    assert slots3.num_replicas == 2


# -- the port's own --------------------------------------------------------------
def test_slots_clamp_and_warn_of_stranded_devices(eight_devices, caplog):
    from daft_tpu_torch.parallel.replica import ReplicaSlots

    with caplog.at_level("WARNING", logger="daft_tpu_torch.parallel"):
        assert ReplicaSlots(16).num_replicas == 1
        assert ReplicaSlots(3).num_replicas == 2
    text = caplog.text
    assert "exceeds the 8 visible device(s)" in text
    assert "leaves 2 of 8 devices unused" in text


def test_visible_devices_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DaftValueError, match="no CUDA device is visible"):
        replica.visible_devices()
    with pytest.raises(DaftValueError, match="no CUDA device is visible"):
        replica.ReplicaSlots(1)


@pytest.fixture(scope="module")
def tiny_npz(tmp_path_factory):
    _, params = init_clip_params(JaxCLIPConfig.tiny(), seed=0)
    flat = {k: np.asarray(v) for k, v in tu.flatten_dict(fs.to_state_dict(params), sep="/").items()}
    path = tmp_path_factory.mktemp("ckpt") / "tiny.npz"
    np.savez(path, **flat)
    return str(path)


ROWS, MORSEL, BATCH = 40, 16, 4


def _rows(pkg, embed, path, **options):
    imgs = np.random.default_rng(1).integers(0, 256, (ROWS, 32 * 32 * 3), dtype=np.uint8)
    series = pkg.Series.from_numpy(imgs, "img", pkg.DataType.image("RGB", 32, 32))
    df = pkg.from_pydict({"id": list(range(ROWS)), "img": series})
    expr = embed(pkg.col("img"), model="tiny", weights_path=path, batch_size=BATCH, **options)
    with pkg.execution_config_ctx(default_morsel_size=MORSEL):
        out = df.with_column("emb", expr).select("id", "emb").to_pydict()
    return out["id"], np.asarray(out["emb"], np.float32), expr


@pytest.mark.parametrize("options", [
    {"chips_per_replica": 4},
    {"chips_per_replica": 8, "mesh_axes": {"dp": 2, "tp": 4}},
], ids=["two_replicas", "dp2_tp4"])
def test_engine_rows_match_the_jax_package(eight_devices, tiny_npz, options):
    assert jax.device_count() >= DEVICES
    ref_ids, ref, _ = _rows(daft_tpu, jax_embed_image, tiny_npz, provider="flax",
                            staging_mode="overlap", **options)
    ids, out, expr = _rows(daft_tpu_torch, embed_image, tiny_npz, provider="cuda", device="cpu",
                           **options)
    assert ids == ref_ids == list(range(ROWS))
    assert out.shape == ref.shape == (ROWS, 32)
    np.testing.assert_allclose(out, ref, atol=BF16_TOL, rtol=BF16_TOL)
    instances = expr._expr.udf._instances
    if "mesh_axes" in options:
        assert list(instances) == [0] and instances[0].mesh.shape == {"dp": 2, "tp": 4}
    else:  # three morsels of 16, 16, 8 over two slots of four: dp over each by default
        assert sorted(instances) == [0, 1]
        assert all(inst.mesh.shape == {"dp": 4} for inst in instances.values())


@pytest.mark.parametrize("n_devices", [1, DEVICES])
def test_chips_per_replica_1_gives_the_same_bytes(monkeypatch, tiny_npz, n_devices):
    ids, plain, plain_expr = _rows(daft_tpu_torch, embed_image, tiny_npz, provider="cuda",
                                   device="cpu")
    devices = [torch.device("cpu") for _ in range(n_devices)]
    monkeypatch.setattr(replica, "visible_devices", lambda: list(devices))
    slot_ids, slotted, expr = _rows(daft_tpu_torch, embed_image, tiny_npz, provider="cuda",
                                    device="cpu", chips_per_replica=1)
    assert slot_ids == ids == list(range(ROWS))
    assert slotted.tobytes() == plain.tobytes()
    assert list(plain_expr._expr.udf._instances) == [0]
    assert len(expr._expr.udf._instances) == min(n_devices, 3)  # three morsels


def test_every_morsel_runs_in_a_slot_on_the_udf_pool(eight_devices):
    """At concurrency 1 too, each morsel holds a slot on a UDF pool thread;
    with slots the morsels keep the default size (no dynamic batching)."""
    from daft_tpu_torch.parallel.replica import replica_devices, replica_id
    from daft_tpu_torch.udf import Udf

    seen = []

    def probe(s):
        seen.append((len(s), replica_id(), len(replica_devices()),
                     threading.current_thread().name.startswith("daft-udf")))
        return np.asarray(s.to_pylist()) + 1

    udf = Udf(probe, DataType.int64(), batch=True, chips_per_replica=8, max_concurrency=1)
    df = daft_tpu_torch.from_pydict({"a": list(range(25))})
    with daft_tpu_torch.execution_config_ctx(default_morsel_size=10):
        out = df.select(udf(col("a"))).to_pydict()
    assert out["a"] == [i + 1 for i in range(25)]
    assert seen == [(10, 0, 8, True), (10, 0, 8, True), (5, 0, 8, True)]


def test_mesh_axes_other_than_dp_and_tp_raise(eight_devices):
    from daft_tpu_torch.ai.cuda_provider import CUDACLIPImageEmbedder

    with pytest.raises(DaftValueError, match="takes the axes dp and tp"):
        CUDACLIPImageEmbedder("tiny", mesh_axes={"sp": 8}, device="cpu")
    with pytest.raises(DaftValueError, match="needs 16 devices, have 8"):
        CUDACLIPImageEmbedder("tiny", mesh_axes={"dp": 4, "tp": 4}, device="cpu")
