"""Analysis the port's runtime reads (counterpart of
flexflow_tpu/analysis/): the numerics budget catalog and the strategy
consistency checks."""
