"""The reference's example scripts on the port, one per
examples/python/*.py. Each is `python -m flexflow_tpu_torch.examples.NAME
[flags]`, `python -m flexflow_tpu_torch flexflow_tpu_torch/examples/NAME.py
[flags]` or `main(argv)`; flags are the reference's (FFConfig.from_args:
-b, -e, ...), and each runs on the card unless `--device cpu` is given."""
