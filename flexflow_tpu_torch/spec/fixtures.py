"""Shared speculation fixtures (counterpart of
flexflow_tpu/spec/fixtures.py).

Acceptance numbers need a model whose greedy stream is PREDICTABLE; an
untrained model's argmax walk is arbitrary, so drafts never match. The
fixture here makes prediction exact.
"""

from __future__ import annotations

import torch


@torch.no_grad()
def make_token_cyclic(ff) -> None:
    """Make the next token a function of the CURRENT token alone: zero
    the attention output and MLP down projections in place, so the
    residual stream is the token embedding. Greedy decode then settles
    into a cycle within at most vocab steps, a repetitive stream the
    n-gram drafter predicts once it has repeated once."""
    tr, _ = ff._params
    for nk, ws in tr.items():
        if "wo" in ws:
            ws["wo"].zero_()
        if "_down_" in nk and "kernel" in ws:
            ws["kernel"].zero_()
