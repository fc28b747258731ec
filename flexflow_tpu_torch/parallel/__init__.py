"""Parallelism (counterpart of flexflow_tpu/parallel/): the mesh,
sharding views, parallel ops, and sequence-parallel attention (the ring
and Ulysses), its shards on one device."""
