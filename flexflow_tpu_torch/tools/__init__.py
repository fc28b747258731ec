"""Command-line tools of the port (counterparts of the reference's
tools/): `python -m flexflow_tpu_torch.tools.fftrace` traces, replays and
calibrates the serving tick loop, `python -m
flexflow_tpu_torch.tools.servesearch` searches, simulates, explains and
applies serving strategies."""
