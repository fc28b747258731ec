"""One process per card on the CPU: the port's `data` and `model` mesh
axes over four gloo ranks, held to the JAX package on the same mesh.

The test process runs the JAX reference on the 8 CPU devices
tests/conftest.py sets up and writes its initial weights and the batches
to a temp npz. One group of four port ranks (tests/torch_dist_worker.py,
which imports no JAX) serves the whole module: each test sends it a task
and reads what each rank wrote. Every mesh runs on the same four ranks,
each on a new process mesh over the world. gloo's timeout is 60 s and
every task is killed, with all its ranks, after 120 s.

Adam runs at lr 1e-4: its update m / sqrt(v) has about the same size
whatever the gradient's, so a weight whose tiny gradient changes sign
between steps turns a 1e-6 gradient difference into an lr-sized one
(tests/test_torch_training.py, test_head_dim_128_train_steps_match_jax_
pallas); lr 1e-4 keeps that inside the fp32 bar of tests/test_align.py.
"""

import json
import os
import select
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from flexflow_tpu import FFConfig as JFFConfig  # noqa: E402
from flexflow_tpu import FFModel as JFFModel  # noqa: E402
from flexflow_tpu.ffconst import DataType as JDataType  # noqa: E402
from flexflow_tpu.ffconst import LossType as JLossType  # noqa: E402
from flexflow_tpu.ffconst import OpType as JOpType  # noqa: E402
from flexflow_tpu.models import bert as jbert  # noqa: E402
from flexflow_tpu.models import llama as jllama  # noqa: E402
from flexflow_tpu.models import nmt as jnmt  # noqa: E402
from flexflow_tpu.runtime import checkpoint as jckpt  # noqa: E402
from flexflow_tpu.runtime import loss as jloss  # noqa: E402
from flexflow_tpu.runtime import optimizer as jopt  # noqa: E402

from flexflow_tpu_torch import (  # noqa: E402
    AdamOptimizer,
    DataType,
    FFConfig,
    FFModel,
    LossType,
)
from flexflow_tpu_torch.models import bert as tbert  # noqa: E402
from flexflow_tpu_torch.models import llama as tllama  # noqa: E402
from flexflow_tpu_torch.models import nmt as tnmt  # noqa: E402
from flexflow_tpu_torch.parallel.sharding import view_to_json  # noqa: E402
from flexflow_tpu_torch.runtime import checkpoint as tckpt  # noqa: E402

WORKER = os.path.join(os.path.dirname(__file__), "torch_dist_worker.py")
WORLD = 4
TASK_TIMEOUT_S = 120
# the fp32 bar of tests/test_align.py
RTOL, ATOL = 1e-4, 1e-5
LR = 1e-4
STEPS = 3

LLAMA = dict(vocab_size=256, dim=64, layers=2, heads=8, kv_heads=4,
             hidden=128, rope_theta=10000.0)
LLAMA_BATCH, LLAMA_SEQ = 8, 16
# head dim 64: the attention takes K4's route (its plain version here)
BERT = dict(vocab_size=64, hidden=128, layers=2, heads=2, intermediate=256,
            num_classes=4, dropout=0.0)
BERT_BATCH, BERT_SEQ = 4, 8
NMT = dict(src_vocab=96, tgt_vocab=88, embed_dim=16, hidden=24, layers=2)
NMT_BATCH, NMT_SEQ = 4, 6
TP = {"data": 2, "model": 2}


class _Group:
    """Four worker ranks over gloo, fed tasks on stdin."""

    def __init__(self, tmp):
        self.tmp = str(tmp)
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        self.logs = [open(os.path.join(self.tmp, f"rank{r}.log"), "w")
                     for r in range(WORLD)]
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        self.procs = []
        for r in range(WORLD):
            env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(WORLD),
                       LOCAL_RANK=str(r), MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                       PYTHONPATH=repo)
            self.procs.append(subprocess.Popen(
                [sys.executable, WORKER], env=env, stdin=subprocess.PIPE,
                stdout=subprocess.PIPE, stderr=self.logs[r], text=True,
                bufsize=1))
        self.n = 0
        self.pending = None

    def run(self, task, **args):
        """Run `task` on every rank; returns the task's name (its files
        are <name>_rank<r>.npz / .json under self.tmp)."""
        return self.wait(self.submit(task, **args))

    def submit(self, task, **args):
        """Send `task` to every rank without waiting for it, so the test
        process can work meanwhile; `wait` collects the replies. One task
        at a time: a reply line read ahead into a pipe's buffer would
        not wake select."""
        assert self.pending is None, f"{self.pending} still runs"
        self.pending = task
        self.n += 1
        name = f"{task}{self.n}"
        args.update(out=self.tmp, name=name)
        line = json.dumps({"task": task, "args": args}) + "\n"
        for p in self.procs:
            p.stdin.write(line)
            p.stdin.flush()
        return name

    def wait(self, name):
        """Every rank's reply to the task `name`, the one submitted."""
        task, self.pending = self.pending, None
        deadline = time.monotonic() + TASK_TIMEOUT_S
        replies = [None] * WORLD
        while any(r is None for r in replies):
            left = deadline - time.monotonic()
            pending = [p.stdout for p, r in zip(self.procs, replies)
                       if r is None]
            ready, _, _ = select.select(pending, [], [], max(left, 0))
            if not ready:
                self.kill()
                pytest.fail(f"{task}: the ranks did not answer within "
                            f"{TASK_TIMEOUT_S} s{self._tails()}")
            for f in ready:
                r = [p.stdout for p in self.procs].index(f)
                got = f.readline()
                if not got:
                    self.kill()
                    pytest.fail(f"{task}: rank {r} exited{self._tails()}")
                replies[r] = json.loads(got)
        errors = [f"rank {r}:\n{x['error']}" for r, x in enumerate(replies)
                  if not x["ok"]]
        if errors:
            pytest.fail(f"{task} failed\n" + "\n".join(errors))
        return name

    def npz(self, name, rank=0):
        return np.load(os.path.join(self.tmp, f"{name}_rank{rank}.npz"))

    def json(self, name, rank=0):
        with open(os.path.join(self.tmp, f"{name}_rank{rank}.json")) as f:
            return json.load(f)

    def _tails(self):
        out = []
        for r, log in enumerate(self.logs):
            log.flush()
            with open(log.name) as f:
                out.append(f"\n--- rank {r} ---\n" + f.read()[-2000:])
        return "".join(out)

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()

    def close(self):
        for p in self.procs:
            if p.poll() is None:
                try:
                    p.stdin.write("quit\n")
                    p.stdin.flush()
                except OSError:
                    pass
        deadline = time.monotonic() + 20
        for p in self.procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                pass
        self.kill()
        for log in self.logs:
            log.close()


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    g = _Group(tmp_path_factory.mktemp("ranks"))
    try:
        yield g
    finally:
        g.close()


# ---------------------------------------------------------------------------
# the JAX references, one per model, on the same mesh


def _np_tree(tree):
    return {k: {n: np.array(a, copy=True) for n, a in w.items()}
            for k, w in tree.items()}


def _flat(tree, prefix):
    return {f"{prefix}/{k}/{n}": a for k, w in tree.items()
            for n, a in w.items()}


def _jax_run(path, build, strategy_fn, batch, inputs, labels):
    """A JAX model on {"data": 2, "model": 2} under its strategy: its
    initial weights and the batches go to `path`; returns the losses of
    STEPS Adam steps and the final parameters."""
    jff = JFFModel(JFFConfig(batch_size=batch, seed=3, mesh_shape=TP))
    cfg = build(jff)
    jff.compile(optimizer=jopt.AdamOptimizer(lr=LR),
                loss_type=JLossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                strategy=strategy_fn(cfg))
    tr, ntr = map(_np_tree, jff._params)
    arrays = {**_flat(tr, "tr"), **_flat(ntr, "ntr")}
    for i in range(STEPS):
        for j, x in enumerate(inputs[i]):
            arrays[f"x{j}_{i}"] = x
        arrays[f"y_{i}"] = labels[i]
    np.savez(path, **arrays)
    step = jff.executor.train_step()
    jtr, jntr = jff._params
    jos = jff._opt_state
    losses = []
    for i in range(STEPS):
        jtr, jntr, jos, m = step(jtr, jntr, jos, jax.random.key(i),
                                 jnp.asarray(labels[i]),
                                 *[jnp.asarray(x) for x in inputs[i]])
        losses.append(float(m["loss"]))
    return losses, _np_tree(jtr)


def _tokens(rs, vocab, batch, seq):
    x = rs.randint(0, vocab, (batch, seq)).astype(np.int32)
    return x, np.roll(x, -1, axis=1).astype(np.int32)


@pytest.fixture(scope="module")
def jax_llama(tmp_path_factory):
    rs = np.random.RandomState(0)
    batches = [_tokens(rs, LLAMA["vocab_size"], LLAMA_BATCH, LLAMA_SEQ)
               for _ in range(STEPS)]
    path = str(tmp_path_factory.mktemp("jax") / "llama.npz")

    def build(jff):
        cfg = jllama.LlamaConfig(**LLAMA)
        jllama.build_llama(jff, cfg, seq_len=LLAMA_SEQ,
                           dtype=JDataType.FLOAT)
        return cfg

    losses, params = _jax_run(path, build, jllama.llama_tp_strategy,
                              LLAMA_BATCH, [[x] for x, _ in batches],
                              [y for _, y in batches])
    return path, losses, params


def _check(group, name, want_losses, want_params):
    got = group.npz(name)
    for r in range(WORLD):
        np.testing.assert_allclose(group.json(name, r)["losses"],
                                   want_losses, rtol=RTOL, atol=ATOL,
                                   err_msg=f"losses of rank {r}")
    for k, w in want_params.items():
        for n, a in w.items():
            np.testing.assert_allclose(got[f"tr/{k}/{n}"], a, rtol=RTOL,
                                       atol=ATOL, err_msg=(k, n))


def _llama_args(path, mesh, sync="psum", remat="none"):
    return dict(model="llama", cfg=LLAMA, batch=LLAMA_BATCH, seq=LLAMA_SEQ,
                mesh=mesh, sync=sync, data=path, lr=LR, steps=STEPS,
                n_inputs=1, remat=remat)


def _one_process_llama(params):
    """The port on one process with `params` (the ranks' gathered
    trainable tree), compiled as the ranks' model is."""
    from flexflow_tpu_torch import MetricsType
    from flexflow_tpu_torch.runtime.weights import params_from_numpy

    ff = FFModel(FFConfig(batch_size=LLAMA_BATCH, seed=3, device="cpu"))
    tllama.build_llama(ff, tllama.LlamaConfig(**LLAMA), seq_len=LLAMA_SEQ,
                       dtype=DataType.FLOAT)
    ff.compile(optimizer=AdamOptimizer(lr=LR),
               metrics=[MetricsType.ACCURACY,
                        MetricsType.SPARSE_CATEGORICAL_CROSSENTROPY],
               params=params_from_numpy(params, {}, "cpu"))
    return ff


def _tree_of(npz, prefix):
    out = {}
    for k in npz.files:
        if k.startswith(prefix + "/"):
            _, nk, wn = k.split("/", 2)
            out.setdefault(nk, {})[wn] = npz[k]
    return out


@pytest.mark.parametrize(
    "mesh, remat", [({"data": 4}, "none"), ({"model": 4}, "none"),
                    (TP, "none"), (TP, "hidden")],
    ids=["data4", "model4", "data2_model2", "data2_model2_remat_hidden"])
def test_llama_tp_strategy_matches_jax(group, jax_llama, mesh, remat):
    """Tiny Llama (8 heads, 4 kv heads) under llama_tp_strategy, three
    Adam steps on each mesh (and under remat="hidden", whose groups run
    on the ranks' pieces): every rank's losses and the gathered
    parameters within the fp32 bar of the JAX run on data 2 x model 2,
    and each step's metrics the global batch's (the first step's those
    of the one-process port's eval on the initial weights; the logits
    stay cut on the vocabulary under model). Then predict gives every
    rank the whole output and eval the global batch's metrics, each the
    one-process port's on those parameters."""
    path, losses, params = jax_llama
    name = group.run("train", **_llama_args(path, mesh, remat=remat))
    _check(group, name, losses, params)
    got = group.npz(name)
    trained = _tree_of(got, "tr")
    one = _one_process_llama(trained)
    x, y = np.load(path)["x0_0"], np.load(path)["y_0"]
    first = _one_process_llama(_tree_of(np.load(path), "tr")).eval(
        x, y, verbose=False)
    for r in range(WORLD):
        sm = group.json(name, r)["step_metrics"]
        np.testing.assert_allclose([m["sparse_cce"] for m in sm], losses,
                                   rtol=RTOL, atol=ATOL)
        assert sm[0]["correct"] == pytest.approx(first.train_correct,
                                                 abs=1e-6)
    np.testing.assert_allclose(got["predict"], one.predict(x), rtol=RTOL,
                               atol=1e-6)
    want = one.eval(x, y, verbose=False)
    for r in range(WORLD):
        meta = group.json(name, r)
        assert meta["predict_sum"] == group.json(name)["predict_sum"]
        assert meta["eval"]["all"] == want.train_all == LLAMA_BATCH
        assert meta["eval"]["correct"] == pytest.approx(want.train_correct,
                                                        abs=1e-6)
        np.testing.assert_allclose(meta["eval"]["sparse_cce"],
                                   want.sparse_cce_loss, rtol=RTOL)
    heads = mesh.get("model", 1)
    shapes = group.json(name, 1)["param_shapes"]
    (wq,) = [v for k, v in shapes.items() if k.startswith("l0_attn_")
             and k.endswith("/wq")]
    assert wq == [LLAMA["dim"], LLAMA["heads"] // heads,
                  LLAMA["dim"] // LLAMA["heads"]]


def test_zero1_matches_psum_and_cuts_the_adam_state(group, jax_llama):
    """param_sync=SHARDED at data 4 (ZeRO-1): the same losses and
    parameters, and each rank's Adam state holds a quarter of the rows
    of every leaf with a dim 4 divides."""
    path, losses, params = jax_llama
    name = group.run("train", **_llama_args(path, {"data": 4}, "sharded"))
    _check(group, name, losses, params)
    for r in range(WORLD):
        m = group.json(name, r)["opt_m_shapes"]
        whole = group.json(name, r)["param_shapes"]
        assert set(m) == set(whole)
        for k, shape in whole.items():
            if any(s % 4 == 0 for s in shape):
                assert np.prod(m[k]) * 4 == np.prod(shape), k
            else:
                assert m[k] == shape, k


def test_bert_attribute_parallel_matches_jax(group, tmp_path):
    """Tiny BERT (head dim 64) under bert_attribute_parallel_strategy at
    data 2 x model 2 against the JAX run on the same mesh."""
    rs = np.random.RandomState(1)
    xs = [[rs.randint(0, BERT["vocab_size"], (BERT_BATCH, BERT_SEQ))
           .astype(np.int32)] for _ in range(STEPS)]
    ys = [rs.randint(0, BERT["num_classes"], (BERT_BATCH, 1))
          .astype(np.int32) for _ in range(STEPS)]
    path = str(tmp_path / "bert.npz")

    def build(jff):
        cfg = jbert.BertConfig(**BERT)
        jbert.build_bert(jff, cfg, seq_len=BERT_SEQ, dtype=JDataType.FLOAT)
        return cfg

    losses, params = _jax_run(path, build,
                              jbert.bert_attribute_parallel_strategy,
                              BERT_BATCH, xs, ys)
    name = group.run("train", model="bert", cfg=BERT, batch=BERT_BATCH,
                     seq=BERT_SEQ, mesh=TP, data=path, lr=LR, steps=STEPS,
                     n_inputs=1)
    _check(group, name, losses, params)


def test_nmt_dp_strategy_matches_jax(group, tmp_path):
    """Tiny LSTM NMT under nmt_dp_strategy (batch over data, the
    vocabulary projection over model) against the JAX run."""
    rs = np.random.RandomState(2)
    xs, ys = [], []
    for _ in range(STEPS):
        src = rs.randint(0, NMT["src_vocab"], (NMT_BATCH, NMT_SEQ))
        tgt = rs.randint(0, NMT["tgt_vocab"], (NMT_BATCH, NMT_SEQ))
        xs.append([src.astype(np.int32), tgt.astype(np.int32)])
        ys.append(np.roll(tgt, -1, axis=1).astype(np.int32))
    path = str(tmp_path / "nmt.npz")

    def build(jff):
        cfg = jnmt.NMTConfig(**NMT)
        jnmt.build_nmt(jff, cfg, src_len=NMT_SEQ, tgt_len=NMT_SEQ)
        return cfg

    losses, params = _jax_run(path, build, jnmt.nmt_dp_strategy, NMT_BATCH,
                              xs, ys)
    name = group.run("train", model="nmt", cfg=NMT, batch=NMT_BATCH,
                     seq=NMT_SEQ, mesh=TP, data=path, lr=LR, steps=STEPS,
                     n_inputs=2)
    _check(group, name, losses, params)


# ---------------------------------------------------------------------------
# units


_OPS = {
    "repartition": (JOpType.REPARTITION, dict(dim=1, axes=["model"]),
                    [["data"], [], []]),
    "combine": (JOpType.COMBINE, dict(dim=2, axes=["model"]),
                [["data"], [], ["model"]]),
    "replicate": (JOpType.REPLICATE, dict(axes=["data"]),
                  [["data"], [], []]),
    "reduction": (JOpType.REDUCTION, dict(axes=["model"]),
                  [[], ["model"], []]),
    "all_to_all": (JOpType.ALL_TO_ALL, dict(src=1, dst=2, axes=["model"]),
                   [["data"], ["model"], []]),
    # the cut moves whole from dim 1 to dim 2: one all-to-all each way
    "all_to_all_moved": (JOpType.ALL_TO_ALL,
                         dict(src=1, dst=2, axes=["model"]),
                         [[], ["model"], []]),
    "fused": (JOpType.FUSED_PARALLEL,
              dict(steps=[["combine", 0, ["data"]],
                          ["repartition", 2, ["data", "model"]]]),
              [["data"], [], []]),
}


def _jax_parallel_op(kind, attrs, x, cot):
    """The JAX package's lowering of the op on its data 2 x model 2 mesh:
    (output, input gradient)."""
    from flexflow_tpu.ops.registry import LowerCtx, get_lowering
    from flexflow_tpu.parallel import parallel_ops as P
    from flexflow_tpu.parallel.mesh import make_mesh

    op, a, _ = _OPS[kind]
    jattrs = {
        "repartition": lambda: P.RepartitionAttrs(a["dim"], tuple(a["axes"])),
        "combine": lambda: P.CombineAttrs(a["dim"], tuple(a["axes"])),
        "replicate": lambda: P.ReplicateAttrs(tuple(a["axes"])),
        "reduction": lambda: P.ReductionAttrs(None, tuple(a["axes"])),
        "all_to_all": lambda: P.AllToAllAttrs(a["src"], a["dst"],
                                              tuple(a["axes"])),
        "fused": lambda: P.FusedParallelOpAttrs(tuple(
            (k, d, tuple(ax)) for k, d, ax in a["steps"])),
    }[kind.replace("_moved", "")]()
    mesh = make_mesh(TP)
    lower = get_lowering(op)

    def f(v):
        return lower(jattrs, [v], {}, LowerCtx(mesh=mesh))[0]

    y, vjp = jax.vjp(jax.jit(f), jnp.asarray(x))
    (dx,) = vjp(jnp.asarray(cot))
    return np.asarray(y), np.asarray(dx)


@pytest.mark.parametrize("kind", sorted(_OPS))
def test_parallel_op_matches_the_jax_lowering(group, tmp_path, kind):
    """Each parallel op on data 2 x model 2: this rank's pieces, gathered,
    are the JAX lowering's output and input gradient, and the output is
    cut as the lowering constrains it."""
    _, attrs, src = _OPS[kind]
    rs = np.random.RandomState(3)
    x = rs.standard_normal((4, 4, 8)).astype(np.float32)
    cot = rs.standard_normal((4, 4, 8)).astype(np.float32)
    path = str(tmp_path / "op.npz")
    np.savez(path, x=x, cot=cot)
    name = group.run("parallel_op", op=kind.replace("_moved", ""),
                     attrs=attrs, src_spec=src, mesh=TP, data=path)
    want_y, want_dx = _jax_parallel_op(kind, attrs, x, cot)
    got = group.npz(name)
    np.testing.assert_allclose(got["y"], want_y, rtol=0, atol=0)
    np.testing.assert_allclose(got["dx"], want_dx, rtol=0, atol=0)
    layout = group.json(name)["layout"]
    whole = {"combine": [[], [], []], "replicate": [[], [], []],
             "reduction": [[], [], []],
             "repartition": [[], ["model"], []],
             "all_to_all": [[], [], ["model"]],
             "all_to_all_moved": [[], [], ["model"]],
             "fused": [[], [], ["data", "model"]]}[kind]
    assert layout == whole


def test_vocab_sharded_cross_entropy_matches_the_unsharded_one(group,
                                                              tmp_path):
    """Logits cut over data (rows) and model (vocabulary): the loss and
    the gradient are the unsharded fused cross-entropy's (the JAX
    package's here)."""
    rs = np.random.RandomState(4)
    logits = (3 * rs.standard_normal((4, 3, 10))).astype(np.float32)
    labels = rs.randint(0, 10, (4, 3)).astype(np.int32)
    path = str(tmp_path / "ce.npz")
    np.savez(path, logits=logits, labels=labels)
    name = group.run("ce", mesh=TP, data=path)
    lt = JLossType.SPARSE_CATEGORICAL_CROSSENTROPY
    want, grad = jax.value_and_grad(
        lambda lg: jloss.compute_loss(lt, lg, jnp.asarray(labels), False))(
        jnp.asarray(logits))
    got = group.npz(name)
    np.testing.assert_allclose(got["loss"], float(want), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(got["grad"], np.asarray(grad), rtol=1e-6,
                               atol=1e-7)
    for r in range(WORLD):
        assert group.json(name, r)["loss"] == group.json(name)["loss"]


def test_vocab_sharded_accuracy_takes_the_first_maximum(group, tmp_path):
    """Accuracy of logits cut over data (rows) and model (vocabulary),
    without gathering them: the global batch's correct count, with the
    prediction the first index of a row's maximum, as argmax takes it,
    where the maximum stands in both vocabulary blocks."""
    rs = np.random.RandomState(5)
    logits = (3 * rs.standard_normal((4, 3, 10))).astype(np.float32)
    pred = logits.argmax(-1)
    # a tie across the two blocks: the row's maximum copied into the
    # other block, before or after the first
    for b, t in ((0, 0), (1, 2), (2, 1), (3, 0)):
        j = pred[b, t]
        logits[b, t, (j + 5) % 10] = logits[b, t, j]
    pred = logits.argmax(-1)
    labels = rs.randint(0, 10, (4, 3)).astype(np.int32)
    labels[:, :2] = pred[:, :2]
    labels[1, 2] = (pred[1, 2] + 5) % 10  # the later maximum: wrong
    path = str(tmp_path / "acc.npz")
    np.savez(path, logits=logits, labels=labels)
    name = group.run("accuracy", mesh=TP, data=path)
    want = float((pred == labels).mean() * 4)
    assert want > 0
    for r in range(WORLD):
        assert group.json(name, r)["correct"] == pytest.approx(want,
                                                               abs=1e-6)


def test_search_strategy_is_rank_0s_on_every_rank(group, jax_llama):
    """compile(search_budget=8, validate_top_k=2) at data 4: rank 0 runs
    the substitution search (which rewrites the graph here: gate and up
    merge), every rank takes its candidates and times them, and rank 0's
    pick wins on every rank: every rank's strategy JSON is byte-equal to
    rank 0's, on the same graph; then one fit step runs on it from data
    loaders. (At data 2 x model 2 the search itself takes some 18 s of
    this CPU.)"""
    path, _, _ = jax_llama
    name = group.run("search", model="llama", cfg=LLAMA, batch=LLAMA_BATCH,
                     seq=LLAMA_SEQ, mesh={"data": 4}, data=path,
                     search_budget=8, validate_top_k=2)
    first = group.json(name)
    assert json.loads(first["strategy"])
    assert first["timed"] >= 2 and first["picked"] is not None
    for r in range(1, WORLD):
        other = group.json(name, r)
        for key in ("strategy", "nodes", "picked", "timed", "loss"):
            assert other[key] == first[key], key
    assert first["samples"] == LLAMA_BATCH
    assert np.isfinite(first["loss"])


def test_four_rank_checkpoint_restores_in_both_packages(group, jax_llama,
                                                         tmp_path):
    """A 4-rank npz save (rank 0 writes the gathered leaves) restores into
    the one-card port and into the JAX package, leaf for leaf equal to
    the gathered parameters."""
    path, _, _ = jax_llama
    ckpt = str(tmp_path / "ck")
    name = group.run("checkpoint", model="llama", cfg=LLAMA,
                     batch=LLAMA_BATCH, seq=LLAMA_SEQ, mesh=TP, data=path,
                     lr=LR, ckpt=ckpt)
    want = group.npz(name)
    tff = FFModel(FFConfig(batch_size=LLAMA_BATCH, device="cpu"))
    tllama.build_llama(tff, tllama.LlamaConfig(**LLAMA), seq_len=LLAMA_SEQ,
                       dtype=DataType.FLOAT)
    tff.compile(optimizer=AdamOptimizer(lr=LR))
    tckpt.restore_checkpoint(ckpt, tff)
    jff = JFFModel(JFFConfig(batch_size=LLAMA_BATCH, num_devices=1))
    jllama.build_llama(jff, jllama.LlamaConfig(**LLAMA), seq_len=LLAMA_SEQ,
                       dtype=JDataType.FLOAT)
    jff.compile(optimizer=jopt.AdamOptimizer(lr=LR),
                loss_type=JLossType.SPARSE_CATEGORICAL_CROSSENTROPY)
    jckpt.restore_checkpoint(ckpt, jff)
    assert tff._step_count == 1
    for k, w in tff._params[0].items():
        for n, t in w.items():
            np.testing.assert_array_equal(t.numpy(), want[f"tr/{k}/{n}"])
            np.testing.assert_array_equal(np.asarray(jff._params[0][k][n]),
                                          want[f"tr/{k}/{n}"])
    with open(os.path.join(ckpt, "strategy.json")) as f:
        saved = json.load(f)
    want_views = tllama.llama_tp_strategy(tllama.LlamaConfig(**LLAMA))
    assert saved["l0_attn"] == json.loads(json.dumps(
        view_to_json(want_views["l0_attn"])))


# ---------------------------------------------------------------------------
# refusals


def test_process_mesh_refusals(group):
    """On the four ranks: a mesh whose data x seq x model is not the world
    size raises ValueError naming both; what stays of queue 1 item 12
    raises and names it: the pipe, expert and data_sub axes, and the
    batch server, the dense and the paged generation servers of a model
    compiled on a mesh of several processes (a ring Llama on data 2 x seq
    2; generate itself runs there: tests/test_torch_seq_parallel.py)."""
    name = group.run("refusals", cfg=LLAMA)
    got = group.json(name)
    assert "spans 2 processes" in got["world"]
    assert "world size is 4" in got["world"]
    assert "spans 8 processes" in got["world_seq"]
    for what, part in (("pipe", "`pipe` axis"), ("expert", "`expert` axis"),
                       ("data_sub", "`data_sub` axis")):
        assert part in got[what]
        assert "queue 1 item 12)" in got[what]
    for what in ("serve", "serve_generation", "paged"):
        assert "serving on a mesh above 1" in got[what]
        assert "queue 1 item 12)" in got[what]


def test_unported_axes_and_modes_are_refused_by_part():
    """What stays of item 12 raises, each naming its part: the pipe,
    expert and data_sub axes, and the pipeline and expert strategies; in
    one process a data x model of 2, with `seq` beside it or not, is not
    the world size (ValueError), while `seq` alone is the one-card ring
    (tests/test_torch_ring.py)."""
    from flexflow_tpu_torch.models.mixtral import (
        MixtralConfig,
        mixtral_ep_strategy,
    )

    for shape, part in (({"pipe": 2}, "`pipe` axis"),
                        ({"expert": 2}, "`expert` axis"),
                        ({"data_sub": 2}, "`data_sub` axis")):
        with pytest.raises(NotImplementedError,
                           match=r"queue 1 item 12\)") as e:
            FFConfig(device="cpu", mesh_shape=shape)
        assert part in str(e.value)
    assert FFConfig(device="cpu", mesh_shape={"seq": 4}).mesh_shape
    with pytest.raises(NotImplementedError, match="`pipe` axis"):
        tllama.llama_pp_strategy(tllama.LlamaConfig(**LLAMA))
    with pytest.raises(NotImplementedError, match="`expert` axis"):
        mixtral_ep_strategy(MixtralConfig.tiny())
    for shape in ({"data": 2}, {"model": 2}, {"data": 2, "model": 2},
                  {"data": 2, "seq": 2}, {"seq": 2, "model": 2}):
        with pytest.raises(ValueError, match="world size is 1"):
            FFConfig(device="cpu", mesh_shape=shape)
    with pytest.raises(ValueError, match="world size is 1"):
        FFConfig(device="cpu", num_devices=2)


def test_strategies_are_the_references():
    """llama_tp_strategy (with and without seq_parallel),
    bert_attribute_parallel_strategy and nmt_dp_strategy give the JAX
    package's views, view for view."""
    pairs = (
        (tllama.llama_tp_strategy(tllama.LlamaConfig(**LLAMA)),
         jllama.llama_tp_strategy(jllama.LlamaConfig(**LLAMA))),
        (tllama.llama_tp_strategy(tllama.LlamaConfig(**LLAMA),
                                  seq_parallel=True),
         jllama.llama_tp_strategy(jllama.LlamaConfig(**LLAMA),
                                  seq_parallel=True)),
        (tbert.bert_attribute_parallel_strategy(tbert.BertConfig(**BERT)),
         jbert.bert_attribute_parallel_strategy(jbert.BertConfig(**BERT))),
        (tnmt.nmt_dp_strategy(tnmt.NMTConfig(**NMT)),
         jnmt.nmt_dp_strategy(jnmt.NMTConfig(**NMT))))
    from flexflow_tpu.parallel.sharding import view_to_json as jview

    for got, want in pairs:
        assert sorted(got) == sorted(want)
        for k in want:
            assert view_to_json(got[k]) == jview(want[k]), k
