"""Named traffic profiles: the prompt-length / prefix-share / arrival
shapes serving strategies are judged against (counterpart of
flexflow_tpu/search/traffic.py; numpy only, the same draws in the same
order, so a seeded sample is the same prompts in both packages).

A serving strategy is only better or worse *for a workload*: chunked
prefill pays off on long prompts, the prefix cache on shared system
prompts, megasteps on decode-heavy streams. This module gives those
workloads names, so the serving-strategy search (search/servesearch.py),
its tick simulator (search/ticksim.py) and the chip smoke's serving
phase score strategies against the SAME fixtures.

Each profile is both ANALYTIC and SAMPLEABLE: `prompt_stats()` feeds
the search's closed-form tick pricing (mean/p95 prompt length, steady-
state prefix-share rate), `sample(rs, vocab)` draws the concrete
prompts a real server serves, deterministic in the caller's
RandomState.

`RecordedProfile` closes the loop on RECORDED traffic: built from a
request-log export (obs.reqlog), its stats are measured — prompt
moments, prefix share, arrival process, spec acceptance — and its
sample() replays the recorded arrival order and lengths, so
`servesearch search --replay log.jsonl` prices strategies against what
the server actually served instead of a synthetic fixture.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class TrafficSample:
    """One concrete draw of a profile: ready-to-submit prompts plus the
    shared prefix they open with (None when the profile has none)."""

    prompts: List[np.ndarray]
    shared_prefix: Optional[np.ndarray] = None


@dataclasses.dataclass(frozen=True)
class TrafficProfile:
    """One named workload.

    suffix_lens: per-request suffix-length ranges, `[lo, hi)` for
      np.random.randint, CYCLED by request index — ((4, 10), (25, 29))
      alternates short and long prompts, the mixed-length fixture shape.
    shared_prefix_tokens: length of the system prompt every request
      opens with (0 = none); drawn once per sample, prepended to every
      suffix — the prefix cache serves it for the 2nd+ request.
    new_tokens: decode tokens requested per request.
    requests: fixture size — how many prompts one sample draws.
    offered_concurrency: requests in flight at once in steady state (the
      arrival intensity the analytic pricing fills decode launches
      with); the realized bench submits all `requests` and lets slot
      admission impose it.
    """

    name: str
    description: str
    suffix_lens: Tuple[Tuple[int, int], ...] = ((4, 17),)
    shared_prefix_tokens: int = 0
    new_tokens: int = 16
    requests: int = 6
    offered_concurrency: int = 4

    def __post_init__(self):
        if not self.suffix_lens:
            raise ValueError("suffix_lens must have at least one range")
        for lo, hi in self.suffix_lens:
            if not (0 < lo < hi):
                raise ValueError(f"bad suffix range [{lo}, {hi})")

    # -- sampling (the bench / CI path) ---------------------------------

    def sample(self, rs: np.random.RandomState, vocab: int,
               requests: Optional[int] = None) -> TrafficSample:
        """Draw the fixture: the shared prefix first (when any), then per
        request its suffix length, then its tokens — the draw order the
        decode bench has always used, so seeded fixtures stay stable."""
        n = self.requests if requests is None else int(requests)
        prefix = None
        if self.shared_prefix_tokens:
            prefix = rs.randint(0, vocab, (self.shared_prefix_tokens,)) \
                .astype(np.int32)
        prompts = []
        for i in range(n):
            lo, hi = self.suffix_lens[i % len(self.suffix_lens)]
            suffix = rs.randint(0, vocab, (rs.randint(lo, hi),)) \
                .astype(np.int32)
            prompts.append(suffix if prefix is None
                           else np.concatenate([prefix, suffix]))
        return TrafficSample(prompts=prompts, shared_prefix=prefix)

    # -- closed form (the search path) ----------------------------------

    def prompt_stats(self) -> Dict[str, float]:
        """Analytic moments of the prompt distribution:
        mean/p95 total prompt tokens, and the steady-state
        prefix_share_rate — the fraction of prompt tokens the prefix
        cache serves once the shared prefix is resident (the first
        request computes it, the other n-1 share it)."""
        seg_means = [(lo + hi - 1) / 2.0 for lo, hi in self.suffix_lens]
        mean_suffix = sum(seg_means) / len(seg_means)
        p95_suffix = float(max(hi - 1 for _, hi in self.suffix_lens))
        pre = float(self.shared_prefix_tokens)
        n = max(self.requests, 1)
        share = 0.0
        if pre > 0:
            share = pre / (pre + mean_suffix) * (n - 1) / n
        return {
            "mean_prompt_tokens": pre + mean_suffix,
            "p95_prompt_tokens": pre + p95_suffix,
            "prefix_share_rate": share,
            "new_tokens": float(self.new_tokens),
            "offered_concurrency": float(self.offered_concurrency),
        }


class RecordedProfile:
    """A traffic profile measured from a request-log export
    (obs.reqlog) instead of declared in closed form. Same two faces as
    TrafficProfile — `prompt_stats()` for the pricer, `sample()` for
    the bench — but every number comes from the log:

      * prompt moments are the recorded prompt lengths (p95 is
        nearest-rank over the actual lengths, not a range bound);
      * prefix_share_rate is the fraction of prompt tokens the prefix
        cache ACTUALLY served (cached / (cached + computed));
      * new_tokens is the mean recorded decode length;
      * offered_concurrency comes from Little's law over the recorded
        residence times (L = sum(residence) / makespan);
      * measured_acceptance() is the realized spec acceptance rate —
        what the pricer uses instead of the acceptance_rate guess.

    sample() replays the recorded ARRIVAL ORDER (submit-time sorted)
    with each request's recorded prompt length, re-drawing token
    CONTENT from the caller's RandomState — the log never stores raw
    tokens, only lengths and hash chains. A shared prefix is
    re-synthesized from the records' longest common chain prefix (the
    chain hashes name whole page blocks, so the common depth times the
    page size is the shared token count the pool observed)."""

    def __init__(self, records: List[dict], name: str = "replay"):
        if not records:
            raise ValueError("RecordedProfile needs at least one record")
        self.name = str(name)
        self.records = sorted(records, key=lambda r: r["submit_ns"])
        self.requests = len(self.records)
        dts = [int(r.get("decode_tokens", 0)) for r in self.records]
        self.new_tokens = max(1, int(round(sum(dts) / len(dts))))
        # per-request decode budgets in arrival order — fftrace replay
        # re-serves each request with ITS recorded budget, not the mean
        self.new_tokens_per_request = [max(1, d) for d in dts]
        self.offered_concurrency = self._littles_law()

    @classmethod
    def from_reqlog(cls, source, name: Optional[str] = None
                    ) -> "RecordedProfile":
        """Build from a reqlog JSONL export path, a RequestLog, or an
        iterable of record dicts."""
        from flexflow_tpu_torch.obs import reqlog as _reqlog

        if isinstance(source, (str, os.PathLike)):
            records = _reqlog.load_jsonl(source)
            if name is None:
                name = f"replay:{os.path.basename(str(source))}"
        elif hasattr(source, "records"):
            records = source.records()
        else:
            records = list(source)
        return cls(records, name=name if name is not None else "replay")

    # -- measured moments (the pricer path) -----------------------------

    def _littles_law(self) -> float:
        """L = sum(residence time) / makespan, clamped to >= 1 — the
        mean requests in flight the recorded run actually held."""
        sub = [r["submit_ns"] for r in self.records]
        done = [r["done_ns"] for r in self.records]
        makespan_s = (max(done) - min(sub)) / 1e9
        if makespan_s <= 0:
            return float(len(self.records))
        resident_s = sum(d - s for s, d in zip(sub, done)) / 1e9
        return max(1.0, resident_s / makespan_s)

    def prompt_stats(self) -> Dict[str, float]:
        lens = sorted(int(r["prompt_tokens"]) for r in self.records)
        p95 = lens[min(max(1, math.ceil(0.95 * len(lens))), len(lens)) - 1]
        cached = sum(int(r.get("cached_prefill_tokens", 0))
                     for r in self.records)
        computed = sum(int(r.get("prefill_tokens", 0))
                       for r in self.records)
        share = cached / (cached + computed) if cached + computed else 0.0
        return {
            "mean_prompt_tokens": sum(lens) / len(lens),
            "p95_prompt_tokens": float(p95),
            "prefix_share_rate": share,
            "new_tokens": float(self.new_tokens),
            "offered_concurrency": float(self.offered_concurrency),
        }

    def arrival_stats(self) -> Dict[str, float]:
        """The recorded arrival process: makespan, offered rate, and
        interarrival moments (nearest-rank p95)."""
        sub = sorted(r["submit_ns"] for r in self.records)
        makespan_s = (max(r["done_ns"] for r in self.records)
                      - sub[0]) / 1e9
        gaps = sorted((b - a) / 1e9 for a, b in zip(sub, sub[1:]))
        p95_gap = (gaps[min(max(1, math.ceil(0.95 * len(gaps))),
                            len(gaps)) - 1] if gaps else 0.0)
        return {
            "requests": float(len(self.records)),
            "makespan_s": makespan_s,
            "arrival_rate_rps": (len(self.records) / makespan_s
                                 if makespan_s > 0 else 0.0),
            "mean_interarrival_s": (sum(gaps) / len(gaps)
                                    if gaps else 0.0),
            "p95_interarrival_s": p95_gap,
            "offered_concurrency": float(self.offered_concurrency),
        }

    def measured_acceptance(self) -> Optional[float]:
        """Realized spec acceptance (accepted / drafted) over the log,
        or None when the recorded run never drafted — the search falls
        back to its prior only in that case."""
        drafted = sum(int(r.get("spec_draft_tokens", 0))
                      for r in self.records)
        accepted = sum(int(r.get("spec_accepted_tokens", 0))
                       for r in self.records)
        if drafted <= 0:
            return None
        return accepted / drafted

    def _shared_prefix_tokens(self) -> int:
        """Longest common prefix-chain depth across ALL records, in
        tokens: chain entry i names the whole prompt prefix through
        page block i, so a common depth of k means every recorded
        prompt opened with the same k * page_size tokens."""
        chains = [list(r.get("prefix_chain") or []) for r in self.records]
        if len(chains) < 2 or any(not c for c in chains):
            return 0
        depth = 0
        for entries in zip(*chains):
            if len(set(entries)) != 1:
                break
            depth += 1
        page = max(int(r.get("page_size", 0)) for r in self.records)
        # the shared block must leave every prompt a computed suffix
        shortest = min(int(r["prompt_tokens"]) for r in self.records)
        return min(depth * page, max(0, shortest - 1))

    # -- sampling (the bench / replay path) -----------------------------

    def sample(self, rs: np.random.RandomState, vocab: int,
               requests: Optional[int] = None) -> TrafficSample:
        """Replay the recorded arrival order: request i gets a prompt of
        ITS recorded length (cycled when `requests` exceeds the log),
        opening with one re-drawn shared prefix when the records' hash
        chains prove the recorded prompts shared one. Same draw order
        discipline as TrafficProfile.sample (prefix first, then each
        suffix), deterministic in `rs`."""
        n = self.requests if requests is None else int(requests)
        shared = self._shared_prefix_tokens()
        prefix = None
        if shared:
            prefix = rs.randint(0, vocab, (shared,)).astype(np.int32)
        prompts = []
        for i in range(n):
            total = int(self.records[i % self.requests]["prompt_tokens"])
            suffix = rs.randint(0, vocab, (max(1, total - shared),)) \
                .astype(np.int32)
            prompts.append(suffix if prefix is None
                           else np.concatenate([prefix, suffix]))
        return TrafficSample(prompts=prompts, shared_prefix=prefix)


# ---------------------------------------------------------------------------
# The named profiles. Factories (not constants) because the interesting
# lengths scale with serving config — the system prompt spans two pages,
# the long mixed prompts need >= 2 prefill chunks — exactly as the bench
# fixtures always computed them.


def smoke_profile(requests: int = 6, new_tokens: int = 16,
                  offered_concurrency: int = 4) -> TrafficProfile:
    """Uniform short prompts — the plain decode fixture."""
    return TrafficProfile(
        name="smoke",
        description="uniform short prompts (4..16 tokens), decode-heavy",
        suffix_lens=((4, 17),),
        new_tokens=new_tokens, requests=requests,
        offered_concurrency=offered_concurrency)


def shared_system_prompt_profile(page_size: int = 8, requests: int = 6,
                                 new_tokens: int = 16,
                                 offered_concurrency: int = 4
                                 ) -> TrafficProfile:
    """Every request opens with the same two-page system prompt; short
    user turns follow. The prefix cache serves the bulk of 2nd+ prefill
    (the decode bench's fixture)."""
    sys_len = 2 * int(page_size)
    return TrafficProfile(
        name="shared-system-prompt",
        description=(f"{sys_len}-token shared system prompt + "
                     "4..16-token user turns"),
        suffix_lens=((4, 17),),
        shared_prefix_tokens=sys_len,
        new_tokens=new_tokens, requests=requests,
        offered_concurrency=offered_concurrency)


def mixed_length_profile(page_size: int = 8,
                         prefill_chunk: Optional[int] = None,
                         requests: int = 6, new_tokens: int = 16,
                         offered_concurrency: int = 4) -> TrafficProfile:
    """Alternating short prompts (decode almost immediately) and long
    prompts needing >= 2 prefill chunks — the ragged-packing A/B
    fixture. `prefill_chunk` defaults to 3 pages, the bench's
    chunking."""
    chunk = 3 * int(page_size) if prefill_chunk is None else int(prefill_chunk)
    return TrafficProfile(
        name="mixed-length",
        description=(f"alternating 4..9-token and {chunk}+1..{chunk}+4-"
                     f"token prompts, chunked at {chunk}"),
        suffix_lens=((4, 10), (chunk + 1, chunk + 5)),
        new_tokens=new_tokens, requests=requests,
        offered_concurrency=offered_concurrency)


def long_context_summarization_profile(page_size: int = 8,
                                       requests: int = 6,
                                       new_tokens: int = 8,
                                       offered_concurrency: int = 3
                                       ) -> TrafficProfile:
    """Production shape #1 (ROADMAP): summarization — prompts several
    pages deep (3..5 pages), short generated summaries, no shared
    prefix. Prefill-dominated: chunked prefill and ragged packing earn
    their keep, megasteps matter less."""
    P = int(page_size)
    return TrafficProfile(
        name="long-context-summarization",
        description=(f"{3 * P}..{5 * P}-token documents, "
                     f"{new_tokens}-token summaries, prefill-heavy"),
        suffix_lens=((3 * P, 5 * P + 1),),
        new_tokens=new_tokens, requests=requests,
        offered_concurrency=offered_concurrency)


def agentic_multiturn_profile(page_size: int = 8, requests: int = 6,
                              new_tokens: int = 16,
                              offered_concurrency: int = 4
                              ) -> TrafficProfile:
    """Production shape #2 (ROADMAP): agentic many-turn — every call
    re-sends a DEEP shared context (system prompt + accumulated tool
    transcript, 4 pages) plus a tiny fresh turn. The prefix cache
    serves nearly the whole prompt from the 2nd request on; decode
    dominates the computed work."""
    P = int(page_size)
    return TrafficProfile(
        name="agentic-multiturn",
        description=(f"{4 * P}-token shared agent context + 1..{P}-token "
                     "turns, deep prefix reuse, decode-heavy"),
        suffix_lens=((2, P + 1),),
        shared_prefix_tokens=4 * P,
        new_tokens=new_tokens, requests=requests,
        offered_concurrency=offered_concurrency)


PROFILES = {
    "smoke": smoke_profile,
    "shared-system-prompt": shared_system_prompt_profile,
    "mixed-length": mixed_length_profile,
    "long-context-summarization": long_context_summarization_profile,
    "agentic-multiturn": agentic_multiturn_profile,
}


def get_profile(name, **overrides) -> TrafficProfile:
    """Resolve a profile by name (with factory kwargs), or pass a
    TrafficProfile — or a RecordedProfile, returned as-is — through
    (a TrafficProfile is optionally re-parameterized via
    dataclasses.replace on field names)."""
    if isinstance(name, RecordedProfile):
        if overrides:
            raise ValueError(
                "a RecordedProfile is measured, not parameterized — "
                f"cannot override {sorted(overrides)}")
        return name
    if isinstance(name, TrafficProfile):
        return dataclasses.replace(name, **overrides) if overrides else name
    try:
        factory = PROFILES[name]
    except KeyError:
        raise KeyError(
            f"unknown traffic profile {name!r} (have {sorted(PROFILES)})"
        ) from None
    return factory(**overrides)
