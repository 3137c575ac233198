"""Replica slots, the device mesh and tensor-parallel placement (port of
``daft_tpu/parallel/``)."""

from daft_tpu_torch.parallel.mesh import make_mesh, match_partition_rules, shard_module_

__all__ = ["make_mesh", "match_partition_rules", "shard_module_"]
