"""Device mesh and parameter sharding (port of ``daft_tpu/parallel/mesh.py``).

A :class:`Mesh` is a named grid of ``torch.device``s in one process, as JAX's
single-controller ``Mesh`` is: ``make_mesh({"dp": 2, "tp": 4})``. The JAX
package annotates parameters with ``PartitionSpec`` rules and lets XLA insert
the collectives; the port matches the same rules to the same flax-form names
(``block_0/attn/qkv/kernel``, as ``models/layers.py::flax_block_names``
produces them) and gives each tensor-parallel Dense layer one weight shard
per ``tp`` device (``models/layers.py::ShardedLinear``). A spec is a tuple
of axis names or ``None``, one per dimension of the flax array.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
from torch import nn

from daft_tpu_torch.errors import DaftValueError

Spec = Tuple[Optional[str], ...]


class Mesh:
    """A named grid of devices: ``devices`` is a numpy object array whose
    axes are ``axis_names``; ``shape`` maps each name to its size."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, ...]):
        if devices.ndim != len(axis_names):
            raise DaftValueError(f"a mesh of {devices.ndim} dimensions needs as many axis "
                                 f"names, got {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, devices.shape))

    def axis_devices(self, axis: str) -> list:
        """The devices along ``axis``, at index 0 of every other axis."""
        k = self._axis_index(axis)
        grid = np.moveaxis(self.devices, k, 0)
        return [grid[(j,) + (0,) * (grid.ndim - 1)] for j in range(grid.shape[0])]

    def submesh(self, **index: int) -> "Mesh":
        """The mesh with each named axis fixed at its index and dropped."""
        grid, names = self.devices, list(self.axis_names)
        for axis, i in index.items():
            if axis not in names:
                raise DaftValueError(f"the mesh {self.shape} has no axis {axis!r} to fix")
            k = names.index(axis)
            picked = grid[(slice(None),) * k + (i,)]
            if not isinstance(picked, np.ndarray):  # the last axis went: one device
                cell = np.empty((), dtype=object)
                cell[()] = picked
                picked = cell
            grid = picked
            names.pop(k)
        return Mesh(grid, tuple(names))

    def _axis_index(self, axis: str) -> int:
        if axis not in self.axis_names:
            raise DaftValueError(f"the mesh {self.shape} has no axis {axis!r}")
        return self.axis_names.index(axis)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def make_mesh(axes: Dict[str, int], devices: Optional[Sequence] = None) -> Mesh:
    """A mesh with named axes, e.g. ``{"dp": 2, "tp": 4}``, over ``devices``
    (every visible CUDA device by default). An axis size of -1 absorbs the
    remaining devices."""
    if devices is None:
        from daft_tpu_torch.parallel.replica import visible_devices

        devices = visible_devices()
    devices = list(devices)
    names = list(axes.keys())
    sizes = list(axes.values())
    known = math.prod(s for s in sizes if s > 0)
    if -1 in sizes:
        rem = len(devices) // known
        sizes = [rem if s == -1 else s for s in sizes]
    total = math.prod(sizes)
    if total > len(devices):
        raise DaftValueError(
            f"Mesh {dict(zip(names, sizes))} needs {total} devices, have {len(devices)}")
    grid = np.empty(total, dtype=object)
    for i, d in enumerate(devices[:total]):
        grid[i] = d
    return Mesh(grid.reshape(sizes), tuple(names))


# The JAX package's tensor-parallel rules for its transformer stacks: shard
# the wide Dense kernels over "tp", replicate the rest.
DEFAULT_TP_RULES: List[Tuple[str, Spec]] = [
    (r".*attn/qkv/kernel", (None, "tp")),
    (r".*attn/out/kernel", ("tp", None)),
    (r".*mlp/fc1/kernel", (None, "tp")),
    (r".*mlp/fc2/kernel", ("tp", None)),
    (r".*tok_embed/embedding", (None, "tp")),
    (r".*lm_head/kernel", (None, "tp")),
    (r".*proj/kernel", (None, "tp")),
    (r".*patch_embed/kernel", ()),
    (r".*", ()),
]


def _axis_size(mesh: Optional[Mesh], ax) -> int:
    if mesh is None or ax is None:
        return 1
    axes = ax if isinstance(ax, (tuple, list)) else (ax,)
    for a in axes:
        if a not in mesh.shape:
            raise DaftValueError(f"a partition spec names axis {a!r}, which the mesh "
                                 f"{mesh.shape} does not have")
    return math.prod(mesh.shape[a] for a in axes)


def match_partition_rules(rules: Sequence[Tuple[str, Spec]], params: Mapping[str, object],
                          mesh: Optional[Mesh] = None) -> Dict[str, Spec]:
    """Each parameter's spec, by the first rule whose regex its name matches
    (the fmengine / EasyLM pattern). ``params`` maps flax-form names to arrays
    (or shapes) in the flax layout. With ``mesh``, an axis that does not
    divide its dimension is dropped; without it the rules apply as written.
    A scalar or one-element parameter is ``()``."""
    specs = {}
    for name, leaf in params.items():
        shape = tuple(getattr(leaf, "shape", leaf))
        spec: Spec = ()
        if shape and math.prod(shape) != 1:
            for pattern, rule in rules:
                if re.search(pattern, name):
                    padded = tuple(rule) + (None,) * (len(shape) - len(rule))
                    spec = tuple(ax if ax is None or dim % _axis_size(mesh, ax) == 0 else None
                                 for dim, ax in zip(shape, padded))
                    break
        specs[name] = spec
    return specs


def flax_shapes(module: nn.Module) -> Dict[str, tuple]:
    """The shape of each parameter of ``module`` in the flax layout, by its
    flax-form name (``module.flax_names()``): a Dense kernel (in, out), a
    patch conv kernel (p, p, 3, w), the rest as they are."""
    params = dict(module.named_parameters())
    shapes = {}
    for key, (tname, how) in module.flax_names().items():
        shape = tuple(params[tname].shape)
        if how == "dense":
            shape = shape[::-1]
        elif how == "conv":
            w, k = shape
            p = math.isqrt(k // 3)
            shape = (p, p, 3, w)
        shapes[key] = shape
    return shapes


def shard_module_(module: nn.Module, mesh: Mesh,
                  rules: Sequence[Tuple[str, Spec]] = DEFAULT_TP_RULES) -> Dict[str, Spec]:
    """Place ``module`` on ``mesh`` by ``rules``; returns the spec of each
    flax-form name. Every Dense layer whose kernel a spec splits over
    ``tp`` becomes a ``ShardedLinear`` holding one weight shard per device
    along ``tp``: ``(None, "tp")`` splits its outputs (column shards),
    ``("tp", None)`` its inputs (row shards). Everything else lives whole on
    the lead device, the first along ``tp``. Other axes replicate: the module
    is placed on the devices at index 0 along them (a caller wanting a copy
    per ``dp`` row shards one copy per ``mesh.submesh(dp=r)``). A spec that
    shards anything but a Dense kernel, or over any axis but ``tp``, raises;
    so does a rule naming an axis the mesh lacks."""
    from daft_tpu_torch.models.layers import ShardedLinear

    tp_devices = mesh.axis_devices("tp") if "tp" in mesh.shape else [mesh.devices.flat[0]]
    module.to(tp_devices[0])
    specs = match_partition_rules(rules, flax_shapes(module), mesh)
    names = module.flax_names()
    for key, spec in specs.items():
        if all(ax is None for ax in spec):
            continue
        tname, how = names[key]
        owner_name, _, leaf = tname.rpartition(".")
        owner = module.get_submodule(owner_name)
        kinds = {(None, "tp"): "column", ("tp", None): "row"}
        if how != "dense" or leaf != "weight" or not isinstance(owner, nn.Linear) \
                or spec not in kinds:
            raise DaftValueError(f"{key}: spec {spec} splits what the port does not shard "
                                 f"(only a Dense kernel over 'tp', by its inputs or outputs)")
        if mesh.shape["tp"] == 1:
            continue  # one shard is the layer itself
        parent_name, _, attr = owner_name.rpartition(".")
        parent = module.get_submodule(parent_name) if parent_name else module
        setattr(parent, attr, ShardedLinear.from_linear(owner, kinds[spec], tp_devices))
    return specs


def shard_bytes(module: nn.Module, tp: int) -> List[int]:
    """The parameter bytes each of ``tp`` shards of a placed module holds:
    a ``ShardedLinear``'s by shard, everything else on the lead (shard 0)."""
    from daft_tpu_torch.models.layers import ShardedLinear

    held = [0] * tp
    sharded = set()
    for m in module.modules():
        if isinstance(m, ShardedLinear):
            for i, n in enumerate(m.shard_nbytes()):
                held[i] += n
            sharded.update(id(p) for p in m.parameters())
    held[0] += sum(p.numel() * p.element_size() for p in module.parameters()
                   if id(p) not in sharded)
    return held
