"""Speculative continuous batching over the paged KV cache (counterpart
of flexflow_tpu/spec/server.py).

Each decode tick becomes a TREE-VERIFY step: a host-side drafter proposes
a token tree per live greedy slot (spec/drafter.py), one ragged step
scores every node under the tree's ancestor mask (the ragged kernel K3 at
a window of max_nodes rows), and a greedy host-side walk accepts the
longest verified path. Rollback is nearly free on the paged cache: the
accepted path's K/V rows are copied onto the contiguous committed
positions (Executor.paged_commit_fn), `pos` advances by the tokens
emitted, and every rejected row sits past the new write head, where the
position mask hides it.

Tick flow (vs the base scheduler's one-token step):
  1. admit (base policy, but the page gate also covers the tree)
  2. grow pages to cover pos + max_nodes rows (tree scratch included)
  3. draft: trailing-context trees for the live greedy slots
  4. ONE ragged verify launch: a tree item per greedy slot (q_len = its
     real node count), a one-row item per temperature>0 slot, nothing for
     idle or mid-prefill slots
  5. accept: the greedy walk per slot over the per-node argmaxes;
     temperature>0 slots take the root's draw only (exactness under
     sampling needs rejection sampling, which the reference does not
     implement either), so they decode one token a step
  6. commit the accepted rows, advance pos, append tokens, publish the
     committed pages to the prefix cache, finish/free

Greedy output is token-identical to the non-speculative paged path: every
emitted token is the model's argmax continuation of its own committed
prefix.

With megastep_mixed=True every tick is instead one universal megastep
(paged/scheduler.py): greedy slots draft a width-1 chain on the device
from their own committed tokens (the unigram draft of
Executor.paged_mixed_megastep_fn; the host drafter is not consulted),
verify and accept it there, and sampled slots decode one token a tick.
With ragged_pack=False the verify launch carries an item for every slot,
q_len 0 for the idle and mid-prefill ones, as before ragged packing.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from flexflow_tpu_torch import obs
from flexflow_tpu_torch.paged.scheduler import PagedGenerationServer
from flexflow_tpu_torch.serving import _GenRequest, pick_tokens
from flexflow_tpu_torch.spec.config import SpecConfig
from flexflow_tpu_torch.spec.tree import (
    accept_greedy,
    ancestor_masks,
    build_tree,
)


class SpeculativePagedServer(PagedGenerationServer):
    """PagedGenerationServer whose decode tick verifies a drafted token
    tree (serve_generation(paged=True, speculate=SpecConfig(...))). Same
    public surface, admission, preemption and defrag as the paged server;
    only the tick body and the page-budget accounting change."""

    def __init__(self, ff, spec: SpecConfig, slots: int = 4,
                 max_len: int = 512, eos_id: Optional[int] = None,
                 seed: int = 0, page_size: int = 64,
                 num_pages: Optional[int] = None, preemption: bool = True,
                 prefix_cache: bool = True, prefill_chunk: int = 64,
                 ragged_pack: bool = True, megastep_ticks: int = 1,
                 megastep_mixed: bool = False,
                 overlap_dispatch: bool = False, kv_dtype: str = "auto",
                 host_tier=None, kv_quant_canary: Optional[int] = None,
                 request_record_limit: Optional[int] = None,
                 reqlog_capacity: Optional[int] = None, slo=None,
                 slo_dump_dir: Optional[str] = None,
                 serve_strategy=None, defer_start: bool = False):
        if not isinstance(spec, SpecConfig):
            raise TypeError(
                f"speculate must be a SpecConfig, got {type(spec).__name__}")
        self.spec = spec
        self.drafter = spec.build_drafter()
        self._commit = ff.executor.paged_commit_fn
        self.spec_steps = 0
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.spec_emitted = 0
        # the page tables address max_len + max_nodes rows: a verify at a
        # pos close to max_len writes its tree past the committed head
        super().__init__(ff, slots=slots, max_len=max_len, eos_id=eos_id,
                         seed=seed, page_size=page_size,
                         num_pages=num_pages, preemption=preemption,
                         prefix_cache=prefix_cache,
                         table_slack_tokens=spec.max_nodes,
                         prefill_chunk=prefill_chunk,
                         ragged_pack=ragged_pack,
                         megastep_ticks=megastep_ticks,
                         megastep_mixed=megastep_mixed,
                         overlap_dispatch=overlap_dispatch,
                         kv_dtype=kv_dtype, host_tier=host_tier,
                         kv_quant_canary=kv_quant_canary,
                         request_record_limit=request_record_limit,
                         reqlog_capacity=reqlog_capacity, slo=slo,
                         slo_dump_dir=slo_dump_dir,
                         serve_strategy=serve_strategy, defer_start=True)
        # a tick's draft acceptance (accepted / drafted), registered before
        # the loop starts
        self._h_accept = self.registry.histogram("spec_acceptance",
                                                 obs.RATIO_BUCKETS)
        if not defer_start:
            self.start()

    def shape_config(self) -> dict:
        """The paged server's launch knobs plus the verify tree: verify
        launches are (live, max_nodes) windows and the accepted path
        commits (slots, depth + 1) rows."""
        cfg = super().shape_config()
        cfg["spec_max_nodes"] = self.spec.max_nodes
        cfg["spec_depth"] = self.spec.depth
        return cfg

    # -- page accounting: the tree's scratch rows count --------------------

    def _table_rows(self) -> int:
        return self.max_pages_per_seq * self.page_size

    def _peak_rows(self, prompt_len: int, max_new_tokens: int) -> int:
        # the deepest verify runs at pos <= prompt + max_new - 1 and
        # touches max_nodes rows from there
        return min(prompt_len + max_new_tokens - 1 + self.spec.max_nodes,
                   self._table_rows())

    def _admission_pages(self, req: _GenRequest) -> int:
        # admit only when the prompt and the first verify tree fit, so
        # admission cannot preempt on its very first tick
        return self.pool.pages_for(
            min(len(req.seq_tokens()) + self.spec.max_nodes,
                self._table_rows()))

    def _pages_target(self, req: _GenRequest) -> int:
        return min(self.pool.pages_for(req.pos + self.spec.max_nodes),
                   self.max_pages_per_seq)

    # -- metrics -----------------------------------------------------------

    def metrics(self) -> dict:
        m = super().metrics()
        m["speculative"] = {
            "steps": self.spec_steps,
            "draft_tokens": self.spec_drafted,
            "accepted_tokens": self.spec_accepted,
            "emitted_tokens": self.spec_emitted,
            "acceptance_rate": (self.spec_accepted / self.spec_drafted
                                if self.spec_drafted else 0.0),
            "accepted_tokens_per_step": (self.spec_emitted / self.spec_steps
                                         if self.spec_steps else 0.0),
        }
        return m

    # -- universal megastep hooks -------------------------------------------

    def _mixed_spec_slot(self, req) -> bool:
        # greedy slots draft on the device; sampled ones decode a token a
        # tick (exactness under sampling needs rejection sampling)
        return req.temperature <= 0.0

    def _on_mixed_spec_tick(self, req, emitted: int):
        """One drafting slot's fused verify: `emitted` tokens committed
        (the accepted draft prefix and the verifier's token). accepted =
        emitted - 1 undercounts by at most one on a tick cut by max_new
        or an eos, as the reference's does: it deflates acceptance,
        never inflates it."""
        D = max(self._spec_depth, 1)
        accepted = max(emitted - 1, 0)
        self.spec_steps += 1
        self.spec_drafted += D
        self.spec_accepted += accepted
        self.spec_emitted += emitted
        req.spec_steps += 1
        req.spec_drafted += D
        req.spec_accepted += accepted
        req.spec_emitted += emitted
        self._h_accept.observe(accepted / D)

    # -- the speculative tick ----------------------------------------------

    def _loop_body(self, tr, ntr):
        while not self._stop.is_set():
            live = self._tick_prep()
            if live is None:
                continue
            if self._mixed_dispatch(live, tr, ntr):
                continue
            # chunked prefill rides the same tick as in the base loop:
            # mid-prefill slots advance one budgeted chunk, then the
            # decoding slots verify
            pre, live = self._split_live(live)
            if pre:
                self._prefill_tick(pre, tr, ntr)
            if not live:
                continue
            if all(self._active[s].temperature > 0.0 for s in live):
                # nothing to speculate on: sampled requests take one
                # token a step either way, so the plain tick serves them
                self._decode_tick(live, tr, ntr)
                continue
            self._spec_tick(live, tr, ntr)

    def _spec_tick(self, live, tr, ntr):
        t0 = time.monotonic()
        d0, a0, e0 = self.spec_drafted, self.spec_accepted, self.spec_emitted
        T = self.spec.max_nodes
        C = self.spec.depth + 1  # most rows committed a tick (path + bonus)
        # draft: one tree item per live greedy slot; sampled slots skip
        # the drafter (their accept path is the root's draw only). The
        # items are the live slots, or with ragged_pack=False every slot
        # in slot order, the idle and mid-prefill ones q_len-0 fillers
        order = live if self.ragged_pack else list(range(self.slots))
        sp = obs.span("draft").__enter__()
        trees = {}
        parents = []
        for s in live:
            req = self._active[s]
            if req.temperature > 0.0:
                continue
            chains = self.drafter.draft(req.seq_tokens(), self.spec.width,
                                        self.spec.depth)
            tree = build_tree(req.tokens[-1], chains, T,
                              max_depth=self.spec.depth)
            trees[s] = tree
            parents.append(tree.parents)
            drafted = tree.n_nodes - 1
            self.spec_drafted += drafted
            req.spec_drafted += drafted
        if sp:
            sp.set(live=len(live), width=T, drafted=self.spec_drafted - d0)
        sp.__exit__(None, None, None)
        anc = iter(ancestor_masks(np.stack(parents)) if parents else ())
        pos = np.array([self._active[s].pos if self._active[s] else 0
                        for s in range(self.slots)], np.int32)
        # items: a tree (q_len = its real node count; padding nodes are
        # skipped work whose writes land in the null page), one row of
        # the last sampled token for a sampled slot, or a q_len-0 filler
        items = []
        for s in order:
            req = self._active[s]
            if s in trees:
                tree = trees[s]
                items.append((s, req.pos, tree.tokens[:tree.n_nodes],
                              tree.depths, next(anc)))
            elif s in live:
                items.append((s, req.pos, [req.tokens[-1]], None, None))
            else:
                items.append((s, 0, [], None, None))
        sp = obs.span("verify").__enter__()
        if sp:
            sp.set(live=len(live), width=T,
                   pages_in_use=self.pool.pages_in_use)
        probs = self._launch(items, T, tr, ntr)
        self._count_decode_overlap()

        # accept: the per-node argmaxes for the walk and the root rows'
        # draw for sampled slots (scattered back to slot order, so the
        # draw is the slot-shaped one of every other path) are reduced
        # on the device; only (items, max_nodes) + (slots,) ints cross to
        # the host, in one transfer, never the probabilities
        dev = self.device
        idx = torch.from_numpy(np.array(order, np.int64)).to(dev)
        root = probs.new_zeros((self.slots, probs.shape[-1]))
        root[idx] = probs[:, 0, :]
        sampled = pick_tokens(root, self._temps_device(), self._gen)
        back = torch.cat([torch.argmax(probs, dim=-1).to(torch.int32)
                          .reshape(-1), sampled]).cpu().numpy()
        preds = back[:len(order) * T].reshape(len(order), T)
        sampled = back[len(order) * T:]
        sp.__exit__(None, None, None)  # verify: closes at the read back
        item_of = {s: i for i, s in enumerate(order)}
        plans = {}
        for s in live:
            if s in trees:
                path, emitted = accept_greedy(trees[s], preds[item_of[s]])
                plans[s] = (path, emitted[:-1], emitted[-1])
            else:
                plans[s] = ([0], [], int(sampled[s]))
        self._steps += 1
        self.spec_steps += 1

        # commit: the accepted path's rows onto the contiguous committed
        # rows (unused entries copy a row onto itself)
        sp = obs.span("commit").__enter__()
        a1 = self.spec_accepted
        src = np.repeat(pos[:, None], C, axis=1)
        dst = src.copy()
        for s in live:
            req = self._active[s]
            path, verified, bonus = plans[s]
            emitted = verified + [int(bonus)]
            emitted = emitted[:req.max_new - len(req.tokens)]
            if self.eos_id is not None and self.eos_id in emitted:
                emitted = emitted[:emitted.index(self.eos_id) + 1]
            L = len(emitted)
            # accepted = verified draft tokens actually emitted (the
            # max_new / eos cut must not inflate acceptance)
            accepted = min(len(verified), L)
            self.spec_accepted += accepted
            req.spec_accepted += accepted
            src[s, :L] = req.pos + np.asarray(path[:L], np.int32)
            dst[s, :L] = req.pos + np.arange(L, dtype=np.int32)
            req.pos += L
            req.tokens.extend(int(t) for t in emitted)
            self._tokens[s] = emitted[-1]
            req.spec_steps += 1
            req.spec_emitted += L
            self.spec_emitted += L
        src_d = torch.from_numpy(src).to(dev)
        dst_d = torch.from_numpy(dst).to(dev)
        self._caches = self._commit(self._caches, self._tables_device(),
                                    src_d, dst_d)
        if self._caches_ref is not None:
            # the canary's fp32 shadow takes the same accepted-row commit
            self._caches_ref = self._commit(
                self._caches_ref, self._tables_device(), src_d, dst_d)
        for s in live:
            # publish AFTER the commit: only rows below the advanced
            # write head hold committed K/V; the tree's scratch rows past
            # it never reach the prefix cache
            self._publish_prefix(self._active[s], self._active[s].pos)
            self._finish_if_done(s)
        emitted = self.spec_emitted - e0
        if sp:
            sp.set(emitted=emitted, accepted=self.spec_accepted - a1)
        sp.__exit__(None, None, None)
        dt = time.monotonic() - t0
        self._h_tick.observe(dt)
        self._h_tokens.observe(emitted)
        if self.spec_drafted > d0:
            self._h_accept.observe((self.spec_accepted - a0)
                                   / (self.spec_drafted - d0))
        led = obs.ledger()
        if led is not None:
            led.record("verify", dt, batch=len(live), width=T)
