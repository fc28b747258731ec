"""Parallelism (counterpart of flexflow_tpu/parallel/): the mesh,
sharding views, parallel ops, sequence-parallel attention (the ring and
Ulysses, its shards in one process), and one process per card over the
`data` and `model` axes (spmd.py: the process mesh and its collectives;
shard_rules.py: each op on its shards)."""
