"""Speculative decoding (serve_generation(paged=True,
speculate=SpecConfig(...))), counterpart of flexflow_tpu/spec.

Layered on flexflow_tpu_torch.paged: a TREE of drafted tokens is verified
in one ragged step instead of one token per step.

  config.py   SpecConfig (drafter choice, tree width/depth)
  drafter.py  drafters: n-gram prompt lookup (zero weights), a draft
              model decoded through FFModel.generate
  tree.py     token-tree trie, ancestor masks, greedy accept
  server.py   SpeculativePagedServer: draft -> tree-verify -> commit

The tree-verify attention is the ragged kernel K3
(csrc/ragged_paged_attention.cu) under the tree's ancestor mask; the step
methods are Executor.verify_fn / paged_commit_fn.
"""

from flexflow_tpu_torch.spec.config import SpecConfig
from flexflow_tpu_torch.spec.drafter import (
    Drafter,
    DraftModelDrafter,
    NgramDrafter,
)
from flexflow_tpu_torch.spec.server import SpeculativePagedServer
from flexflow_tpu_torch.spec.tree import (
    TokenTree,
    accept_greedy,
    ancestor_masks,
    build_tree,
)

__all__ = [
    "SpecConfig",
    "Drafter",
    "NgramDrafter",
    "DraftModelDrafter",
    "SpeculativePagedServer",
    "TokenTree",
    "build_tree",
    "ancestor_masks",
    "accept_greedy",
]
