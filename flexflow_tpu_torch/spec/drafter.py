"""Token drafters behind one interface (counterpart of
flexflow_tpu/spec/drafter.py).

A drafter proposes candidate continuations of a request's committed
context; the tree-verify step scores every proposal in one model forward
and the scheduler keeps the longest verified path. Drafters run on the
host between ticks, so a bad draft costs throughput, never correctness.

  NgramDrafter       prompt lookup: zero extra weights
  DraftModelDrafter  a second (small) compiled FFModel, greedy-decoded
                     through the dense FFModel.generate
"""

from __future__ import annotations

from typing import List

import numpy as np


class Drafter:
    """Interface: propose up to `width` candidate continuations (each at
    most `depth` tokens) of `context` (the request's prompt + generated
    tokens so far, INCLUDING the yet-unverified last sampled token)."""

    def draft(self, context: np.ndarray, width: int,
              depth: int) -> List[np.ndarray]:
        raise NotImplementedError


class NgramDrafter(Drafter):
    """Prompt-lookup decoding: find earlier occurrences of the context's
    trailing n-gram and propose what followed them. Longer matches are
    tried first; among equal-length matches the most RECENT occurrence
    wins. Branches are deduplicated by first token, so the token tree
    branches at the root."""

    def __init__(self, min_n: int = 1, max_n: int = 3):
        if not (1 <= min_n <= max_n):
            raise ValueError(f"need 1 <= min_n <= max_n, got {min_n}..{max_n}")
        self.min_n = int(min_n)
        self.max_n = int(max_n)

    def draft(self, context: np.ndarray, width: int,
              depth: int) -> List[np.ndarray]:
        ctx = np.asarray(context, np.int32).reshape(-1)
        n = len(ctx)
        chains: List[np.ndarray] = []
        seen_first: set = set()
        for ng in range(min(self.max_n, n - 1), self.min_n - 1, -1):
            suffix = ctx[n - ng:]
            # windows[i] == ctx[i:i+ng], one vectorised scan per length
            windows = np.lib.stride_tricks.sliding_window_view(ctx, ng)
            hits = np.nonzero((windows[:n - ng] == suffix).all(axis=1))[0]
            for i in hits[::-1]:  # most recent match first
                cont = ctx[i + ng:i + ng + depth]
                if len(cont) == 0:
                    continue
                first = int(cont[0])
                if first in seen_first:
                    continue
                seen_first.add(first)
                chains.append(np.asarray(cont, np.int32))
                if len(chains) >= width:
                    return chains
        return chains


class DraftModelDrafter(Drafter):
    """Small-draft-model speculation: greedy-decode `depth` tokens from a
    second compiled FFModel (its own executor, its own dense KV caches:
    FFModel.generate), one chain per step; a model drafter expresses
    confidence through depth, not branching. Each draft prefills the
    whole context anew, as the reference's does. Greedy, so its chains
    equal the JAX drafter's on the same weights."""

    def __init__(self, draft_ff):
        if getattr(draft_ff, "_executor", None) is None:
            raise ValueError(
                "DraftModelDrafter needs a COMPILED FFModel (call "
                ".compile() on the draft model first)")
        self.ff = draft_ff

    def draft(self, context: np.ndarray, width: int,
              depth: int) -> List[np.ndarray]:
        ctx = np.asarray(context, np.int32).reshape(1, -1)
        out = self.ff.generate(ctx, max_new_tokens=depth)
        return [np.asarray(out[0], np.int32)]
