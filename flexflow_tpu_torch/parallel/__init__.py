"""Parallelism (counterpart of flexflow_tpu/parallel/): the mesh and
sequence-parallel ring attention, its shards on one device."""
