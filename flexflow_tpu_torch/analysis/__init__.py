"""Analysis data the port's runtime reads (counterpart of
flexflow_tpu/analysis/): the numerics budget catalog."""
