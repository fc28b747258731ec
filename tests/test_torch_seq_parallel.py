"""`seq` across processes on the CPU: the port's ring and Ulysses between
four gloo ranks, held to the JAX package on the same mesh.

The protocol is tests/test_torch_distributed.py's: one group of four
ranks (tests/torch_dist_worker.py, which imports no JAX) serves this
module; the test process runs the JAX references on the 8 CPU devices
tests/conftest.py sets up and writes their initial weights and the
batches (made from a numpy seed) to a temp npz. The JAX runs start at
once on a pool of threads; a case's ranks start training as soon as its
npz is written and train while its JAX run trains (`_Group.submit` /
`wait`).

The model is a causal GQA Llama (4 heads over 2 kv heads, head dim 8; 2
over 1 for the Ulysses fallback; 6 over 3 for kv heads that do not split
over `model`), one layer, whose local sequence is 16 tokens a rank on
every mesh: not a multiple of 128 (the port's ring has no length gate).
Each JAX run trains one model on its mesh in one mode (the ring; or
Ulysses, which the JAX package runs as all-to-alls around local flash
attention, or as its ring where the heads do not split), and the port's
runs on that mesh are held to its losses, parameters and predict (CASES).
Adam runs at lr 1e-4 within tests/test_align.py's fp32 bar, as in
tests/test_torch_distributed.py.
"""

import json
from concurrent.futures import (
    FIRST_COMPLETED,
    Future,
    ThreadPoolExecutor,
    wait,
)

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from test_torch_distributed import (  # noqa: E402
    ATOL,
    LR,
    RTOL,
    STEPS,
    WORLD,
    _flat,
    _Group,
    _np_tree,
    _tokens,
)

from flexflow_tpu import FFConfig as JFFConfig  # noqa: E402
from flexflow_tpu import FFModel as JFFModel  # noqa: E402
from flexflow_tpu.ffconst import DataType as JDataType  # noqa: E402
from flexflow_tpu.ffconst import LossType as JLossType  # noqa: E402
from flexflow_tpu.models import llama as jllama  # noqa: E402
from flexflow_tpu.runtime import optimizer as jopt  # noqa: E402


SP = dict(vocab_size=64, dim=32, layers=1, heads=4, kv_heads=2, hidden=64,
          rope_theta=10000.0)
# 1 local head at model 2 does not split over seq 2: Ulysses falls back to
# the ring, whose 1 kv head does not split over model 2 (ring_repeats_kv)
SP_FALLBACK = dict(SP, heads=2, kv_heads=1)
# 3 kv heads do not split over model 2: without a seq axis each rank
# projects the kv head of each of its 3 q heads (ring_repeats_kv)
SP_KV3 = dict(SP, dim=48, heads=6, kv_heads=3)
BATCH, S_LOC, NEW = 4, 16, 4
MESHES = {"d2s2": {"data": 2, "seq": 2}, "s2m2": {"seq": 2, "model": 2},
          "s4": {"seq": 4}, "d2m2": {"data": 2, "model": 2}}


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    g = _Group(tmp_path_factory.mktemp("seq_ranks"))
    try:
        yield g
    finally:
        g.close()


def _seq(mesh):
    """The global sequence: S_LOC tokens a position of `seq`."""
    return S_LOC * mesh.get("seq", 1)


def _jax_model(mesh, cfg, mode):
    jff = JFFModel(JFFConfig(batch_size=BATCH, seed=3, mesh_shape=mesh))
    c = jllama.LlamaConfig(**cfg)
    jllama.build_llama(jff, c, seq_len=_seq(mesh), dtype=JDataType.FLOAT,
                       use_ring_attention=True, seq_mode=mode)
    jff.compile(optimizer=jopt.AdamOptimizer(lr=LR),
                loss_type=JLossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                strategy=jllama.llama_tp_strategy(
                    c, seq_parallel="seq" in mesh))
    return jff


def _save_case(path, jff, seq, seed):
    """The JAX model's initial weights, STEPS batches and a prompt, from
    a numpy seed, to `path`."""
    rs = np.random.RandomState(seed)
    tr, ntr = map(_np_tree, jff._params)
    arrays = {**_flat(tr, "tr"), **_flat(ntr, "ntr")}
    vocab = SP["vocab_size"]
    for i in range(STEPS):
        arrays[f"x0_{i}"], arrays[f"y_{i}"] = _tokens(rs, vocab, BATCH, seq)
    arrays["prompt"] = rs.randint(0, vocab, (BATCH, 8)).astype(np.int32)
    np.savez(path, **arrays)
    return arrays


def _args(path, mesh, cfg, mode, sync="psum"):
    return dict(model="llama", cfg=cfg, batch=BATCH, seq=_seq(mesh),
                mesh=mesh, sync=sync, data=path, lr=LR, steps=STEPS,
                n_inputs=1, ring=True, seq_mode=mode,
                seq_parallel="seq" in mesh)


def _jax_train(jff, arrays):
    step = jff.executor.train_step()
    jtr, jntr = jff._params
    jos = jff._opt_state
    losses = []
    for i in range(STEPS):
        jtr, jntr, jos, m = step(jtr, jntr, jos, jax.random.key(i),
                                 jnp.asarray(arrays[f"y_{i}"]),
                                 jnp.asarray(arrays[f"x0_{i}"]))
        losses.append(float(m["loss"]))
    jff._params = (jtr, jntr)
    return losses, _np_tree(jtr)


# the JAX runs: mesh, mode, config; each writes its initial weights and
# batches, then (before its steps donate the weights) predicts and
# generates on them, trains, and predicts on the trained weights
REFS = {
    "d2s2_ring": ("d2s2", "ring", SP),
    "s2m2_ring": ("s2m2", "ring", SP),
    "s4_ring": ("s4", "ring", SP),
    "s4_ulysses": ("s4", "ulysses", SP),
    "s2m2_ulysses_fallback": ("s2m2", "ulysses", SP_FALLBACK),
    "d2m2_kv_whole": ("d2m2", "ring", SP_KV3),
}
GENERATES = ("d2s2_ring", "s2m2_ring")
# runs that only predict on their initial weights (no train step compiled)
PREDICTS_ONLY = ("d2m2_kv_whole",)
# the port's runs: the JAX run each is held to, and its mode. Ulysses on
# data 2 x seq 2 and seq 2 x model 2 is held to the JAX ring on the same
# mesh (exact attention either way; one XLA compile fewer each)
CASES = {
    "d2s2_ring": ("d2s2_ring", "ring"),
    "d2s2_ulysses": ("d2s2_ring", "ulysses"),
    "s2m2_ring": ("s2m2_ring", "ring"),
    "s2m2_ulysses": ("s2m2_ring", "ulysses"),
    "s4_ring": ("s4_ring", "ring"),
    "s4_ulysses": ("s4_ulysses", "ulysses"),
    "s2m2_ulysses_fallback": ("s2m2_ulysses_fallback", "ulysses"),
}


def _reference(tmp, key, written: Future):
    mesh_name, mode, cfg = REFS[key]
    mesh = MESHES[mesh_name]
    path = str(tmp / f"{key}.npz")
    jff = _jax_model(mesh, cfg, mode)
    arrays = _save_case(path, jff, _seq(mesh), seed=len(key))
    written.set_result(path)
    run = dict(path=path, mesh=mesh, first_predict=jff.predict(
        arrays["x0_0"]))
    if key in PREDICTS_ONLY:
        return run
    tokens = jff.generate(arrays["prompt"], NEW) if key in GENERATES \
        else None
    losses, params = _jax_train(jff, arrays)
    return dict(run, tokens=tokens, losses=losses, params=params,
                predict=jff.predict(arrays["x0_0"]))


class _Refs:
    """Every JAX run of the module, started at once on a pool of threads
    (their XLA compiles overlap each other and the ranks' work).
    `written(key)` waits for a run's npz, `refs[key]` for the whole run."""

    def __init__(self, tmp, pool):
        self.npz = {k: Future() for k in REFS}
        self.runs = {k: pool.submit(_reference, tmp, k, self.npz[k])
                     for k in REFS}

    def written(self, key):
        wait([self.npz[key], self.runs[key]], return_when=FIRST_COMPLETED)
        if not self.npz[key].done():
            self.runs[key].result()  # it failed before writing: its error
        return self.npz[key].result()

    def __getitem__(self, key):
        return self.runs[key].result()


@pytest.fixture(scope="module")
def refs(group, tmp_path_factory):
    with ThreadPoolExecutor(4) as pool:
        yield _Refs(tmp_path_factory.mktemp("jax_sp"), pool)


def _check_run(group, name, losses, params, predict):
    got = group.npz(name)
    for r in range(WORLD):
        np.testing.assert_allclose(group.json(name, r)["losses"], losses,
                                   rtol=RTOL, atol=ATOL,
                                   err_msg=f"losses of rank {r}")
    for k, w in params.items():
        for n, a in w.items():
            np.testing.assert_allclose(got[f"tr/{k}/{n}"], a, rtol=RTOL,
                                       atol=ATOL, err_msg=(k, n))
    np.testing.assert_allclose(got["predict"], predict, rtol=RTOL, atol=ATOL)


def _check_calls(group, name, mesh, cfg, ring: bool):
    """Each rank's kernel-wrapper calls over the STEPS train steps: under
    the ring K5 folds and K4's dq and dk/dv once for each block its own
    query block sees (seq position + 1, causal), nothing gathered; under
    Ulysses one flash attention (forward) a layer and step, and no K5."""
    coord = {}
    for r in range(WORLD):
        rest = r
        for ax in reversed([a for a in ("data", "seq", "model")
                            if mesh.get(a, 1) > 1]):
            coord[r, ax] = rest % mesh[ax]
            rest //= mesh[ax]
    for r in range(WORLD):
        calls = group.json(name, r)["calls"]
        want = {}
        if ring:
            blocks = STEPS * cfg["layers"] * (coord.get((r, "seq"), 0) + 1)
            want = {"flash_bh_fwd_carry": blocks, "flash_bh_dq": blocks,
                    "flash_bh_dkv": blocks}
        else:
            want = {"flash_attention": STEPS * cfg["layers"]}
        assert calls == want, (r, calls)
        b = BATCH // mesh.get("data", 1)
        assert group.json(name, r)["local_batch"] == [[b, S_LOC]]


@pytest.mark.parametrize("case", list(CASES))
def test_seq_parallel_training_matches_jax(group, refs, case):
    """Ring and Ulysses, with `seq` a process axis: three Adam steps in
    fp32 on the mesh, then predict, against the JAX package on the same
    mesh; each rank's kernel calls are those of its own blocks. The
    fallback case (2 heads over 1 kv head at seq 2 x model 2) takes the
    ring, its kv head whole on every rank (shard_rules._rank_kv). The
    ranks train while the JAX run does."""
    key, mode = CASES[case]
    mesh_name, _, cfg = REFS[key]
    mesh = MESHES[mesh_name]
    name = group.submit("train", **_args(refs.written(key), mesh, cfg,
                                         mode))
    try:
        ref = refs[key]
    finally:
        group.wait(name)
    _check_run(group, name, ref["losses"], ref["params"], ref["predict"])
    _check_calls(group, name, mesh, cfg,
                 mode == "ring" or cfg is SP_FALLBACK)


def test_kv_heads_whole_without_seq_match_jax(group, refs):
    """A ring Llama whose 3 kv heads do not split over model 2, on data 2
    x model 2 (no seq axis): wk and wv stay whole and each rank projects
    the kv head of each of its 3 q heads (0, 0, 1 on the first model
    rank, 1, 2, 2 on the second), so predict is the JAX package's on the
    same mesh, through one flash attention a rank. Training on whole kv
    heads is held to JAX by the Ulysses fallback case."""
    ref = refs["d2m2_kv_whole"]
    name = group.run("predict", **_args(ref["path"], ref["mesh"], SP_KV3,
                                        "ring"))
    np.testing.assert_allclose(group.npz(name)["predict"],
                               ref["first_predict"], rtol=RTOL, atol=ATOL)
    for r in range(WORLD):
        assert group.json(name, r)["calls"] == {"flash_attention": 1}, r


def test_zero1_under_seq_equals_psum(group, refs):
    """param_sync=SHARDED on data 2 x seq 2: the optimizer state cut over
    data x seq (a quarter of every leaf with a dim 4 divides), and the
    losses and parameters those of PSUM and of the JAX package."""
    ref = refs["d2s2_ring"]
    args = _args(ref["path"], ref["mesh"], SP, "ring")
    psum = group.run("train", **args)
    zero = group.run("train", **dict(args, sync="sharded"))
    _check_run(group, zero, ref["losses"], ref["params"], ref["predict"])
    a, b = group.npz(psum), group.npz(zero)
    for k in a.files:
        np.testing.assert_allclose(b[k], a[k], rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    for r in range(WORLD):
        got = group.json(zero, r)
        np.testing.assert_allclose(got["losses"],
                                   group.json(psum, r)["losses"], rtol=1e-6)
        whole = group.json(psum, r)["param_shapes"]
        assert set(got["opt_m_shapes"]) == set(whole)
        for k, shape in whole.items():
            m = got["opt_m_shapes"][k]
            if any(s % 4 == 0 for s in shape):
                assert np.prod(m) * 4 == np.prod(shape), k
            else:
                assert m == shape, k


def test_rope_takes_each_ranks_global_positions(group, refs):
    """On seq 4 the ring's predict is the JAX package's only because
    each rank rotates its block at its global positions (apply_rope's
    pos_offset = seq index x 16): with the offset dropped, the first
    block still matches and every later one does not."""
    ref = refs["s4_ring"]
    want = ref["first_predict"]
    args = _args(ref["path"], ref["mesh"], SP, "ring")
    got = group.npz(group.run("predict", **args))["predict"]
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)
    bad = group.npz(group.run("predict", drop_rope_offset=True,
                              **args))["predict"]
    np.testing.assert_allclose(bad[:, :S_LOC], want[:, :S_LOC], rtol=RTOL,
                               atol=1e-6)
    for j in range(1, 4):
        blk = slice(j * S_LOC, (j + 1) * S_LOC)
        assert np.abs(bad[:, blk] - want[:, blk]).max() > 1e-3, j


@pytest.mark.parametrize("mesh_name", ["d2s2", "s2m2"])
def test_generate_on_a_seq_mesh_matches_jax(group, refs, mesh_name):
    """generate on a process mesh with `seq` (the caches replicated over
    it, cut on the rows and the kv heads) is token-identical to the JAX
    package's on the same mesh (tests/test_decode_sp_pp.py's bar), on
    every rank."""
    ref = refs[f"{mesh_name}_ring"]
    name = group.run("generate", new=NEW,
                     **_args(ref["path"], ref["mesh"], SP, "ring"))
    for r in range(WORLD):
        np.testing.assert_array_equal(group.json(name, r)["tokens"],
                                      ref["tokens"])


def test_search_on_a_seq_mesh_gives_every_rank_one_program(group, refs):
    """compile(search_budget=) on data 2 x seq 2 with a ring Llama: rank
    0 searches, every rank takes its strategy (byte-equal JSON on every
    rank, on the same graph), and one fit step runs on it."""
    ref = refs["d2s2_ring"]
    name = group.run("search", search_budget=2,
                     **_args(ref["path"], ref["mesh"], SP, "ring"))
    first = group.json(name)
    assert json.loads(first["strategy"])
    for r in range(1, WORLD):
        other = group.json(name, r)
        for key in ("strategy", "nodes", "loss"):
            assert other[key] == first[key], key
    assert first["samples"] == BATCH
    assert np.isfinite(first["loss"])


def test_process_axes_is_one_rule_both_ways():
    """parallel/mesh.process_axes: on a world of 1 `seq` stays in the
    process (the one-card ring) and `data` / `model` above 1 are process
    axes (which check_world refuses there); on a world above 1 every axis
    above 1 among data, seq and model is one, in canonical order, and
    their product is the world size."""
    from flexflow_tpu_torch.parallel.mesh import process_axes, process_count

    assert process_axes({"seq": 4}, 1) == ()
    assert process_axes({"data": 2, "seq": 2}, 1) == ("data",)
    assert process_axes({"seq": 4}, 4) == ("seq",)
    assert process_axes({"model": 2, "seq": 2, "data": 1}, 4) \
        == ("seq", "model")
    assert process_axes({"data": 2, "seq": 2, "model": 2}, 8) \
        == ("data", "seq", "model")
    assert process_count({"data": 2, "seq": 2}, 1) == 2
    assert process_count({"data": 2, "seq": 2}, 4) == 4
