"""Meshes' sharding rules and the ambient mesh (the port of
`repro.parallel`)."""
from .sharding import PartitionSpec, ShardingRules

__all__ = ["PartitionSpec", "ShardingRules"]
