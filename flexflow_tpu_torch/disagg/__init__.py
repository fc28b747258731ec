"""Disaggregated serving (counterpart of flexflow_tpu/disagg/): the
host-memory KV tier behind the page pool's LRU dead list, the
prefill/decode worker split with per-request page adoption through the
tier, and a prefix-affinity router fronting N serving instances."""

from flexflow_tpu_torch.disagg.host_tier import HostTier
from flexflow_tpu_torch.disagg.router import PrefixAffinityRouter
from flexflow_tpu_torch.disagg.workers import DisaggPair, PrefillWorker

__all__ = ["HostTier", "PrefixAffinityRouter", "DisaggPair",
           "PrefillWorker"]
