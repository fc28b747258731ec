"""Token-tree construction and the greedy accept walk (counterpart of
flexflow_tpu/spec/tree.py; numpy only, the port's own copy).

A verify step scores a TREE of drafted tokens in one forward pass: node 0
is the root (the last sampled token, whose K/V row the verify step
writes), and the drafted chains merge into a trie below it. The tree is
flattened into fixed-size arrays (tokens, parents, depths) padded to
`max_nodes`, plus an ancestor mask. Parents always precede children, so
node j's K/V row lands at cache row `pos + j`, and masks and commits are
index arithmetic.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class TokenTree:
    """Flattened token tree. tokens[0] is the root; padding nodes carry
    token 0, parent -1, depth 0 and valid False."""

    tokens: np.ndarray    # (max_nodes,) int32
    parents: np.ndarray   # (max_nodes,) int32; -1 for root and padding
    depths: np.ndarray    # (max_nodes,) int32
    valid: np.ndarray     # (max_nodes,) bool
    children: List[Dict[int, int]]  # node -> {token: child node}
    n_nodes: int          # live nodes (root + drafted)


def build_tree(root_token: int, chains: Sequence[np.ndarray],
               max_nodes: int,
               max_depth: Optional[int] = None) -> TokenTree:
    """Merge drafted chains into a trie under the root. Chains insert in
    order; shared prefixes share nodes, and insertion stops at
    `max_nodes`. `max_depth` clamps every chain, so a drafter that
    ignores its depth budget costs throughput, never the scheduler."""
    tokens = np.zeros((max_nodes,), np.int32)
    parents = np.full((max_nodes,), -1, np.int32)
    depths = np.zeros((max_nodes,), np.int32)
    valid = np.zeros((max_nodes,), bool)
    tokens[0] = int(root_token)
    valid[0] = True
    children: List[Dict[int, int]] = [dict() for _ in range(max_nodes)]
    n = 1
    for chain in chains:
        chain = np.asarray(chain).reshape(-1)
        if max_depth is not None:
            chain = chain[:max_depth]
        cur = 0
        for t in chain:
            t = int(t)
            nxt = children[cur].get(t)
            if nxt is None:
                if n >= max_nodes:
                    break
                nxt = n
                tokens[nxt] = t
                parents[nxt] = cur
                depths[nxt] = depths[cur] + 1
                valid[nxt] = True
                children[cur][t] = nxt
                n += 1
            cur = nxt
    return TokenTree(tokens, parents, depths, valid, children, n)


def ancestor_masks(parents: np.ndarray) -> np.ndarray:
    """(B, T) parent arrays -> (B, T, T) bool ancestor-or-self masks:
    anc[b, q, k] is True when node k lies on node q's root path (node q
    may attend to node k's K/V row). Parents precede children, so one
    forward sweep closes the relation; a padding node sees only itself."""
    B, T = parents.shape
    anc = np.zeros((B, T, T), bool)
    rows = np.arange(B)
    for j in range(T):
        anc[:, j, j] = True
        p = parents[:, j]
        m = p >= 0
        if m.any():
            anc[m, j] |= anc[rows[m], p[m]]
    return anc


def accept_greedy(tree: TokenTree,
                  preds: np.ndarray) -> Tuple[List[int], List[int]]:
    """Greedy acceptance walk over one slot's per-node argmaxes ((T,)
    int: preds[j] = argmax P(next | committed context, root..node j)).
    From the root, the model's argmax must equal a child's drafted token
    to descend; the first mismatch (or a leaf) emits the argmax as the
    bonus token. Returns (path, emitted) of equal length L: path[i] is the
    tree node whose K/V row commits to cache position pos+i, emitted[i]
    the token at position pos+1+i. Every emitted token is the argmax
    continuation of its own prefix, so the stream equals plain greedy
    decode."""
    path, emitted = [0], []
    cur = 0
    while True:
        pred = int(preds[cur])
        emitted.append(pred)
        nxt = tree.children[cur].get(pred)
        if nxt is None:
            break
        path.append(nxt)
        cur = nxt
    return path, emitted
