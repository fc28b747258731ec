"""The port's decode megastep (serve_generation(paged=True,
megastep_ticks=N)) held to the JAX reference, on the CPU.

The contract is the reference's (tests/test_megastep.py): running up to N
decode ticks per host round trip is a pure dispatch fusion, so greedy
tokens equal the JAX paged server's (the identity and the chunked-prefill
scenarios) and the port's one-tick loop's (the break scenarios; the
one-tick loop is held to the JAX server in test_torch_paged_server.py),
and
fixed-seed sampled tokens equal the port's one-tick loop's (the
generator advances once a tick on both; torch.Generator is not
jax.random, so sampled tokens match JAX in distribution only). The
megastep hands control back to the host after a finish, before a page
boundary and at the tick limit, and the pool's invariants hold at every
resume. Tolerance: none, tokens are compared exactly (fp32, the same
weights in both packages).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from flexflow_tpu import FFConfig as JFFConfig  # noqa: E402
from flexflow_tpu import FFModel as JFFModel  # noqa: E402
from flexflow_tpu import LossType  # noqa: E402
from flexflow_tpu.ffconst import DataType as JDataType  # noqa: E402
from flexflow_tpu.models.llama import LlamaConfig as JLlamaConfig  # noqa: E402
from flexflow_tpu.models.llama import build_llama as jbuild_llama  # noqa: E402
from flexflow_tpu_torch import DataType, FFConfig, FFModel  # noqa: E402
from flexflow_tpu_torch.models.llama import LlamaConfig, build_llama  # noqa: E402
from flexflow_tpu_torch.paged.scheduler import PagedGenerationServer  # noqa: E402
from flexflow_tpu_torch.runtime.weights import params_from_numpy  # noqa: E402
from flexflow_tpu_torch.spec import SpecConfig  # noqa: E402

VOCAB = 512


@pytest.fixture(scope="module")
def lm():
    """(JAX model, port model carrying the JAX weights): the tiny GQA
    Llama of tests/test_megastep.py (vocab 512, dim 64, 2 layers, 4/2
    heads, fp32, seed 7)."""
    kw = dict(vocab_size=VOCAB, dim=64, layers=2, heads=4, kv_heads=2,
              hidden=128, rope_theta=10000.0)
    jff = JFFModel(JFFConfig(batch_size=1, seed=7))
    jbuild_llama(jff, JLlamaConfig(**kw), batch_size=1, seq_len=8,
                 dtype=JDataType.FLOAT)
    jff.compile(loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY)
    tff = FFModel(FFConfig(batch_size=1, seed=7, device="cpu"))
    build_llama(tff, LlamaConfig(**kw), batch_size=1, seq_len=8,
                dtype=DataType.FLOAT)
    jtr, jntr = jff._params
    tff.compile(params=params_from_numpy(
        {k: {n: np.asarray(a) for n, a in w.items()} for k, w in jtr.items()},
        {k: {n: np.asarray(a) for n, a in w.items()}
         for k, w in jntr.items()}, device="cpu"))
    return jff, tff


def _prompts(seed, lens):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, VOCAB, (n,)).astype(np.int32) for n in lens]


def _serve(ff, prompts, new, temperature=0.0, **kw):
    """Submit every prompt before the loop starts (defer_start), so the
    schedule is a function of the tokens alone; return (tokens,
    metrics)."""
    server = ff.serve_generation(paged=True, defer_start=True, **kw)
    try:
        news = new if isinstance(new, list) else [new] * len(prompts)
        futs = [server.submit(p, max_new_tokens=n, temperature=temperature)
                for p, n in zip(prompts, news)]
        server.start()
        got = [np.asarray(f.result(timeout=120)) for f in futs]
        m = server.metrics()
    finally:
        server.stop()
    assert m["pages_in_use"] == 0
    server.pool.check_invariants(owners={})
    return got, m


@pytest.fixture(scope="module")
def reference_tokens(lm):
    """The JAX paged server's greedy tokens for the identity scenario of
    tests/test_megastep.py:40 (3 prompts, 12 new, slots 4, page 4)."""
    jff, _ = lm
    got, _ = _serve(jff, _prompts(0, (3, 6, 5)), 12, slots=4, max_len=64,
                    page_size=4)
    return got


@pytest.mark.parametrize("n_ticks", [1, 4, 8])
def test_megastep_greedy_identity_vs_reference(lm, reference_tokens,
                                               n_ticks):
    """Greedy tokens through megastep_ticks in {1, 4, 8} equal the JAX
    paged server's exactly; N > 1 pays fewer host round trips than it
    decodes tokens, and every megastep records its break reason."""
    _, tff = lm
    got, m = _serve(tff, _prompts(0, (3, 6, 5)), 12, slots=4, max_len=64,
                    page_size=4, megastep_ticks=n_ticks)
    for w, g in zip(reference_tokens, got):
        np.testing.assert_array_equal(g, w)
    ms = m["megastep"]
    assert ms["ticks_max"] == n_ticks and ms["decode_tokens"] > 0
    if n_ticks > 1:
        assert ms["host_roundtrips"] < ms["decode_tokens"]
        assert sum(ms["breaks"].values()) == ms["dispatches"] >= 1
        assert ms["wasted_ticks"] == 0  # no eos: every enqueued tick ran
    else:
        assert ms["dispatches"] == 0


@pytest.mark.parametrize("n_ticks", [4, 8])
def test_megastep_temperature_identity_fixed_seed(lm, n_ticks):
    """Fixed-seed temperature sampling does not depend on how many ticks
    fuse into a dispatch: pick_tokens draws once a tick on both paths."""
    _, tff = lm
    p = _prompts(1, (5,))
    outs = {n: _serve(tff, p, 14, temperature=0.8, slots=4, max_len=64,
                      page_size=8, seed=11, megastep_ticks=n)[0][0]
            for n in (1, n_ticks)}
    np.testing.assert_array_equal(outs[1], outs[n_ticks])


def test_megastep_page_boundary_break(lm):
    """page_size 4 breaks a megastep at least every 4 fused ticks: the
    tokens equal the one-tick loop's and no megastep runs past a
    page."""
    _, tff = lm
    p = _prompts(2, (5,))
    want, _ = _serve(tff, p, 16, slots=2, max_len=64, page_size=4)
    got, m = _serve(tff, p, 16, slots=2, max_len=64, page_size=4,
                    megastep_ticks=8)
    np.testing.assert_array_equal(got[0], want[0])
    assert m["megastep"]["breaks"]["page"] > 0
    assert m["megastep"]["decode_tokens"] <= 4 * m["megastep"][
        "host_roundtrips"]


def test_megastep_length_finish_and_staggered_finishes(lm):
    """max_new below the megastep width finishes mid-megastep (a finish
    break); staggered max_new across concurrent requests finishes slots
    at different ticks while others keep decoding. Every stream equals
    the one-tick loop's."""
    _, tff = lm
    prompts = _prompts(5, (3, 5, 4, 6))
    new = [3, 7, 12, 5]
    want, _ = _serve(tff, prompts, new, slots=4, max_len=64, page_size=4)
    got, m = _serve(tff, prompts, new, slots=4, max_len=64, page_size=4,
                    megastep_ticks=8)
    for w, g, n in zip(want, got, new):
        np.testing.assert_array_equal(g, w)
        assert len(g) == n
    assert m["requests_served"] == len(prompts)
    assert m["megastep"]["breaks"]["finish"] > 0


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_megastep_stop_token_mid_megastep(lm, temperature):
    """An eos sampled mid-megastep ends the stream where the one-tick loop
    ends it; the ticks enqueued past it are predicated off and counted,
    and the generator is set back, so a later sampled request still
    matches the one-tick loop token for token."""
    _, tff = lm
    p = _prompts(4, (5,))
    stream, _ = _serve(tff, p, 10, temperature=temperature, slots=1,
                       max_len=64, page_size=16, seed=3)
    # the stream's 4th token (its first occurrence ends it): a finish
    # on a tick before the 8-tick megastep's last
    eos = int(stream[0][3])
    stop = list(stream[0]).index(eos) + 1
    got, ms = {}, {}
    for n in (1, 8):
        # a second prompt, served after the first in the same loop, reads
        # the generator where the first left it
        got[n], m = _serve(tff, p + _prompts(6, (4,)), [10, 6],
                           temperature=temperature, slots=1, max_len=64,
                           page_size=16, seed=3, eos_id=eos,
                           megastep_ticks=n)
        ms[n] = m["megastep"]
    for a, b in zip(got[1], got[8]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[8][0], stream[0][:stop])
    assert ms[8]["breaks"]["finish"] > 0
    assert ms[8]["wasted_ticks"] > 0


def test_megastep_pool_invariants_at_every_resume(lm):
    """The pool's invariants hold after every megastep's replay, under
    page pressure that forces growth and preemption between megasteps;
    tokens equal the one-tick loop's."""
    _, tff = lm
    resumes = []

    class CheckedServer(PagedGenerationServer):
        def _on_megastep_resume(self):
            owners = {s: list(self._active[s].pages)
                      for s in self._admit_order
                      if self._active[s] is not None
                      and self._active[s].pages}
            self.pool.check_invariants(owners=owners)
            resumes.append(len(owners))

    prompts = _prompts(6, (3, 6, 5, 4))
    want, _ = _serve(tff, prompts, 10, slots=3, max_len=64, page_size=4,
                     num_pages=24)
    server = CheckedServer(tff, slots=3, max_len=64, page_size=4,
                           num_pages=24, megastep_ticks=8)
    try:
        got = [f.result(timeout=120) for f in
               [server.submit(p, max_new_tokens=10) for p in prompts]]
    finally:
        server.stop()
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert resumes
    server.pool.check_invariants(owners={})


def test_megastep_rejects_invalid_configs(lm):
    """The reference's invalid configurations raise its ValueErrors:
    megastep_ticks below 1, a megastep without paged, a plain megastep
    with speculate, overlap_dispatch without the mixed megastep, the
    mixed megastep without paged. The combinations the mixed megastep
    makes valid (speculate with megastep_ticks > 1, overlap_dispatch)
    build their server."""
    _, tff = lm
    with pytest.raises(ValueError, match="megastep_ticks"):
        tff.serve_generation(max_len=64, megastep_ticks=0, paged=True)
    with pytest.raises(ValueError, match="paged"):
        tff.serve_generation(max_len=64, megastep_ticks=8, paged=False)
    with pytest.raises(ValueError, match="speculate"):
        tff.serve_generation(max_len=64, megastep_ticks=8, paged=True,
                             speculate=SpecConfig(width=2, depth=3))
    with pytest.raises(ValueError, match="megastep_mixed"):
        tff.serve_generation(max_len=64, megastep_ticks=8, paged=True,
                             overlap_dispatch=True)
    with pytest.raises(ValueError, match="paged"):
        tff.serve_generation(max_len=64, megastep_ticks=8,
                             megastep_mixed=True)
    for kw in ({"megastep_mixed": True, "overlap_dispatch": True},
               {"megastep_mixed": True,
                "speculate": SpecConfig(width=2, depth=3)}):
        server = tff.serve_generation(max_len=64, megastep_ticks=8,
                                      paged=True, defer_start=True, **kw)
        server.stop()
        assert server.megastep_mixed and server.megastep_ticks == 8


def test_megastep_with_chunked_prefill_mixed_batch(lm):
    """A long prompt prefilling chunk by chunk beside short prompts that
    decode: ticks with a chunk in flight take the one-tick path, the
    pure-decode ticks megasteps, and every stream equals the JAX
    server's."""
    jff, tff = lm
    rs = np.random.RandomState(8)
    long_p = rs.randint(0, VOCAB, (24,)).astype(np.int32)
    shorts = [rs.randint(0, VOCAB, (n,)).astype(np.int32) for n in (3, 5)]
    prompts = [shorts[0], long_p, shorts[1]]
    kw = dict(slots=3, max_len=64, page_size=4, prefill_chunk=6)
    want, _ = _serve(jff, prompts, 8, **kw)
    got, m = _serve(tff, prompts, 8, megastep_ticks=8, **kw)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert m["megastep"]["dispatches"] > 0
    assert m["prefill_ticks"] > 0
