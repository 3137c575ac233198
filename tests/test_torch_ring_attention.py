"""The port's ring attention over ``torch.distributed``, on the CPU.

The mirror of ``tests/test_ring_attention.py``: where the JAX package shards
the sequence over an eight-device ``sp`` mesh under ``shard_map``, the port
runs a world of four gloo ranks, one process each, joined through a
``FileStore`` (no port is opened), every case in one world
(``daft_tpu_torch.tools.ring_world``). Each result is held against dense
attention in numpy at the JAX test's tolerance (2e-5, 3e-5 for the long
case), and against the JAX package's ``sequence_parallel_attention`` over a
four-device ``sp`` mesh on the same numpy inputs at 3e-5. A one-rank world
runs in the test's own process.
"""

import datetime

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from daft_tpu.ops.ring_attention import sequence_parallel_attention as jax_sequence_parallel
from daft_tpu.parallel.mesh import make_mesh as jax_make_mesh
from daft_tpu_torch.ops.ring_attention import ring_attention, sequence_parallel_attention
from daft_tpu_torch.tools.ring_world import launch

WORLD = 4


def _dense_attention(q, k, v):
    s = np.einsum("btd,bsd->bts", q.astype(np.float64), k) / np.sqrt(q.shape[-1])
    p = np.exp(s - s.max(axis=-1, keepdims=True))
    p /= p.sum(axis=-1, keepdims=True)
    return np.einsum("bts,bsd->btd", p, v).astype(np.float32)


def _cases():
    rng = np.random.default_rng(0)
    dense = tuple(rng.standard_normal((2, 64, 16)).astype(np.float32) for _ in range(3))
    q1 = np.random.default_rng(1).standard_normal((1, 32, 8)).astype(np.float32)
    q2 = np.random.default_rng(2).standard_normal((1, 1024, 8)).astype(np.float32)
    return {"dense": dense, "sharded": (q1, q1, q1), "long": (q2, q2, q2)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cases = _cases()
    return cases, launch(cases, WORLD, tmp_path_factory.mktemp("ring"), timeout=120)


def test_ring_attention_matches_dense(world):
    cases, out = world
    ref = _dense_attention(*cases["dense"])
    for rank in out["dense"]:
        np.testing.assert_allclose(rank["whole"], ref, rtol=2e-5, atol=2e-5)


def test_ring_attention_keeps_the_sequence_sharded(world):
    """Each rank's ``ring_attention`` returns only its own query rows
    ([B, T/n, D]), attended over the whole sequence."""
    cases, out = world
    ref = _dense_attention(*cases["sharded"])
    t = ref.shape[1] // WORLD
    for r, rank in enumerate(out["sharded"]):
        assert rank["local"].shape == (1, t, 8)
        np.testing.assert_allclose(rank["local"], ref[:, r * t:(r + 1) * t],
                                   rtol=2e-5, atol=2e-5)


def test_ring_attention_long_context_memory_shape(world):
    """1024 tokens over four ranks: 256 x 256 logits blocks per step."""
    cases, out = world
    ref = _dense_attention(*cases["long"])
    for rank in out["long"]:
        np.testing.assert_allclose(rank["whole"], ref, rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("case", ["dense", "sharded", "long"])
def test_ring_attention_matches_the_jax_package(world, case):
    assert jax.device_count() >= WORLD
    cases, out = world
    mesh = jax_make_mesh({"sp": WORLD}, jax.devices()[:WORLD])
    q, k, v = (jnp.asarray(a) for a in cases[case])
    ref = np.asarray(jax_sequence_parallel(q, k, v, mesh))
    for rank in out[case]:
        np.testing.assert_allclose(rank["whole"], ref, rtol=0, atol=3e-5)


def test_one_rank_world_is_dense_attention(tmp_path):
    q, k, v = (torch.from_numpy(a) for a in _cases()["dense"])
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        whole = sequence_parallel_attention(q, k, v)
        local = ring_attention(q, k, v)
    finally:
        dist.destroy_process_group()
    ref = _dense_attention(q.numpy(), k.numpy(), v.numpy())
    np.testing.assert_allclose(whole.numpy(), ref, rtol=2e-5, atol=2e-5)
    assert torch.equal(whole, local)


def test_a_world_with_a_failing_rank_raises(tmp_path):
    """A sequence that does not split over the ranks fails every rank, and
    the launcher raises naming them."""
    q = np.zeros((1, 10, 8), np.float32)
    with pytest.raises(RuntimeError, match="rank 0 exited"):
        launch({"odd": (q, q, q)}, 4, tmp_path, timeout=60)
