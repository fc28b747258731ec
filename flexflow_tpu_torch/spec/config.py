"""Speculative decoding configuration (counterpart of
flexflow_tpu/spec/config.py).

One SpecConfig describes the whole speculation policy: which drafter
proposes tokens, and the token-tree shape (`width` distinct branches,
each up to `depth` tokens deep) the verifier scores in one forward pass.
The tree is padded to a fixed node count (`max_nodes`), so every verify
launch of a server has the same (items, max_nodes) window.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class SpecConfig:
    """Speculation policy for `serve_generation(paged=True, speculate=...)`.

    drafter: "ngram" (prompt lookup, zero extra weights), "model" (a
      second compiled FFModel, `draft_model`), or a
      `flexflow_tpu_torch.spec.drafter.Drafter` instance.
    width: most distinct branches drafted per verify step (the token tree
      branches at the root; chains sharing a prefix merge into a trie).
    depth: most drafted tokens per branch, also the most tokens ACCEPTED
      per step (plus one bonus token from the verifier's own logits, so
      every step emits >= 1 token).
    min_ngram/max_ngram: prompt-lookup match lengths for the "ngram"
      drafter (longest match wins; recency breaks ties).
    """

    drafter: object = "ngram"
    width: int = 2
    depth: int = 4
    min_ngram: int = 1
    max_ngram: int = 3
    draft_model: Optional[object] = None

    def __post_init__(self):
        if self.width < 1:
            raise ValueError(f"width must be >= 1, got {self.width}")
        if self.depth < 1:
            raise ValueError(f"depth must be >= 1, got {self.depth}")
        if not (1 <= self.min_ngram <= self.max_ngram):
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram, got "
                f"{self.min_ngram}..{self.max_ngram}")

    @property
    def max_nodes(self) -> int:
        """The verify step's tree size: the root (the last sampled token,
        whose K/V row the verify step writes) plus up to width x depth
        drafted nodes."""
        return 1 + self.width * self.depth

    def expected_tokens_per_step(self, accept_rate: float) -> float:
        """Expected tokens COMMITTED per verify step when each drafted
        token matches the verifier independently with probability
        `accept_rate`. Depth level i survives iff some branch covers it
        (probability a_w = 1 - (1-a)^width) and its i-1 ancestors
        matched, so

            E = 1 + sum_{i=1..depth} a_w * a^(i-1)

        (the leading 1 is the bonus token: every step emits at least
        one). Monotone in width and depth, saturating at
        1 + a_w / (1-a)."""
        a = min(max(float(accept_rate), 0.0), 1.0)
        if a >= 1.0:
            return 1.0 + float(self.depth)
        a_w = 1.0 - (1.0 - a) ** self.width
        return 1.0 + a_w * sum(a ** (i - 1) for i in range(1, self.depth + 1))

    def build_drafter(self):
        from flexflow_tpu_torch.spec.drafter import (
            DraftModelDrafter,
            Drafter,
            NgramDrafter,
        )

        if isinstance(self.drafter, Drafter):
            return self.drafter
        if self.drafter == "ngram":
            return NgramDrafter(min_n=self.min_ngram, max_n=self.max_ngram)
        if self.drafter == "model":
            if self.draft_model is None:
                raise ValueError(
                    'drafter="model" needs a compiled draft FFModel in '
                    "SpecConfig.draft_model")
            return DraftModelDrafter(self.draft_model)
        raise ValueError(
            f"unknown drafter {self.drafter!r} (want 'ngram', 'model', or "
            "a Drafter instance)")
