"""One rank of the port's multi-process CPU tests
(tests/test_torch_distributed.py).

Started four times by the test module with RANK, WORLD_SIZE, MASTER_ADDR
and MASTER_PORT in its environment; joins a gloo process group and then
runs tasks read from stdin, one JSON line each ({"task": name, "args":
{...}}), answering each with one JSON line on stdout ({"ok": true} or
{"ok": false, "error": traceback}). Each rank writes what it computed
under args["out"] as <name>_rank<r>.npz / .json. The line "quit" ends the
process. It imports torch and the port only, never JAX.
"""

import json
import os
import sys
import traceback

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from flexflow_tpu_torch import (  # noqa: E402
    AdamOptimizer,
    DataType,
    FFConfig,
    FFModel,
    LossType,
    MetricsType,
)
from flexflow_tpu_torch.ffconst import ParamSyncType  # noqa: E402
from flexflow_tpu_torch.runtime import distributed as dist  # noqa: E402
from flexflow_tpu_torch.runtime.weights import params_from_numpy  # noqa: E402

RANK = int(os.environ["RANK"])

# calls of the attention kernels' wrappers on this rank (their plain
# versions here), by name: K5's fold and K4's dq and dk/dv as the ring
# calls them, and the flash attention Ulysses calls
CALLS = {}


def _count_calls():
    from flexflow_tpu_torch.ops import ring_flash, torch_ops

    def counted(mod, name):
        fn = getattr(mod, name)

        def wrapper(*a, **kw):
            CALLS[name] = CALLS.get(name, 0) + 1
            return fn(*a, **kw)

        setattr(mod, name, wrapper)

    for name in ("flash_bh_fwd_carry", "flash_bh_dq", "flash_bh_dkv"):
        counted(ring_flash, name)
    counted(torch_ops, "flash_attention")


def _tree(npz, prefix):
    out = {}
    for k in npz.files:
        if k.startswith(prefix + "/"):
            _, nk, wn = k.split("/", 2)
            out.setdefault(nk, {})[wn] = npz[k]
    return out


def _flat(tree, prefix):
    return {f"{prefix}/{nk}/{wn}": t.detach().float().cpu().numpy()
            for nk, ws in tree.items() for wn, t in ws.items()}


def _save(args, name, arrays=None, meta=None):
    base = os.path.join(args["out"], f"{name}_rank{RANK}")
    if arrays is not None:
        np.savez(base + ".npz", **arrays)
    if meta is not None:
        with open(base + ".json", "w") as f:
            json.dump(meta, f, sort_keys=True)


def _model(args):
    """The model `args` names, built on this rank's mesh."""
    kind = args["model"]
    cfg = FFConfig(batch_size=args["batch"], seed=3, device="cpu",
                   mesh_shape=args.get("mesh"),
                   param_sync=ParamSyncType(args.get("sync", "psum")),
                   search_budget=args.get("search_budget", 0),
                   validate_top_k=args.get("validate_top_k", 0),
                   remat=args.get("remat", "none"))
    ff = FFModel(cfg)
    strategy = None
    if kind == "llama":
        from flexflow_tpu_torch.models.llama import (
            LlamaConfig,
            build_llama,
            llama_tp_strategy,
        )

        mc = LlamaConfig(**args["cfg"])
        build_llama(ff, mc, seq_len=args["seq"], dtype=DataType.FLOAT,
                    use_ring_attention=args.get("ring", False),
                    seq_mode=args.get("seq_mode", "ring"))
        strategy = llama_tp_strategy(
            mc, seq_parallel=args.get("seq_parallel", False))
    elif kind == "bert":
        from flexflow_tpu_torch.models.bert import (
            BertConfig,
            bert_attribute_parallel_strategy,
            build_bert,
        )

        mc = BertConfig(**args["cfg"])
        build_bert(ff, mc, seq_len=args["seq"], dtype=DataType.FLOAT)
        strategy = bert_attribute_parallel_strategy(mc)
    elif kind == "nmt":
        from flexflow_tpu_torch.models.nmt import (
            NMTConfig,
            build_nmt,
            nmt_dp_strategy,
        )

        mc = NMTConfig(**args["cfg"])
        build_nmt(ff, mc, src_len=args["seq"], tgt_len=args["seq"])
        strategy = nmt_dp_strategy(mc)
    if args.get("search_budget"):
        strategy = None
    return ff, strategy


def task_train(args):
    """Compile the model from the weights in args["data"], run its train
    steps on the batches there, save the losses, the whole parameters and
    (each rank) the shapes of its optimizer state."""
    data = np.load(args["data"])
    ff, strategy = _model(args)
    params = params_from_numpy(_tree(data, "tr"), _tree(data, "ntr"), "cpu")
    ff.compile(optimizer=AdamOptimizer(lr=args["lr"]),
               loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=[MetricsType.ACCURACY,
                        MetricsType.SPARSE_CATEGORICAL_CROSSENTROPY],
               strategy=strategy, params=params)
    ex = ff.executor
    tr, ntr = ff._params
    opt = ff._opt_state
    losses, step_metrics = [], []
    CALLS.clear()
    for i in range(args["steps"]):
        xs = [data[f"x{j}_{i}"] for j in range(args["n_inputs"])]
        *bx, by = [torch.from_numpy(a) for a in
                   ex.local_batch(xs + [data[f"y_{i}"]], labels=True)]
        tr, ntr, opt, m = ex.train_step(tr, ntr, opt, by, *bx)
        losses.append(float(m["loss"]))
        step_metrics.append({"correct": float(m["accuracy_correct"]),
                             "sparse_cce": float(m["sparse_cce_loss"])})
    ff._params, ff._opt_state = (tr, ntr), opt
    calls = dict(CALLS)
    full = ex.gather_params(tr)
    state = {f"{nk}/{wn}": list(t.shape)
             for nk, ws in opt.get("m", {}).items() for wn, t in ws.items()}
    local = {f"{nk}/{wn}": list(t.shape)
             for nk, ws in tr.items() for wn, t in ws.items()}
    # predict and eval on the first batch: the whole output and the
    # global batch's metrics on every rank
    xs = [data[f"x{j}_0"] for j in range(args["n_inputs"])]
    out = ff.predict(xs if len(xs) > 1 else xs[0])
    pm = ff.eval(xs if len(xs) > 1 else xs[0], data["y_0"], verbose=False)
    arrays = {**_flat(full, "tr"), "predict": out}
    _save(args, args["name"], arrays if RANK == 0 else None,
          {"losses": losses, "step_metrics": step_metrics,
           "opt_m_shapes": state, "param_shapes": local,
           "predict_sum": float(np.float64(out).sum()),
           "eval": {"correct": pm.train_correct, "all": pm.train_all,
                    "sparse_cce": pm.sparse_cce_loss},
           "calls": calls, "local_batch": [list(a.shape) for a in
                                           ex.local_batch([xs[0]])]})


def task_predict(args):
    """Compile the model from the weights in args["data"] and save its
    predict on the first batch, whole on every rank, and the kernel
    wrappers' calls of that one forward. With args["drop_rope_offset"]
    the ring's RoPE ignores the rank's sequence offset (a check that a
    test notices its loss)."""
    from flexflow_tpu_torch.parallel import ring

    data = np.load(args["data"])
    ff, strategy = _model(args)
    ff.compile(loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
               strategy=strategy, params=params_from_numpy(
                   _tree(data, "tr"), _tree(data, "ntr"), "cpu"))
    CALLS.clear()
    rope = ring.apply_rope
    if args.get("drop_rope_offset"):
        # every rank rotates its block as if it began the sequence
        ring.apply_rope = lambda x, theta, pos_offset=0: rope(x, theta)
    try:
        out = ff.predict(data["x0_0"])
    finally:
        ring.apply_rope = rope
    _save(args, args["name"], {"predict": out} if RANK == 0 else None,
          {"calls": dict(CALLS),
           "predict_sum": float(np.float64(out).sum())})


def task_generate(args):
    """Compile the model from the weights in args["data"] and save the
    greedy tokens of generate on its prompt (every rank)."""
    data = np.load(args["data"])
    ff, strategy = _model(args)
    ff.compile(loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
               strategy=strategy, params=params_from_numpy(
                   _tree(data, "tr"), _tree(data, "ntr"), "cpu"))
    toks = ff.generate(data["prompt"], args["new"])
    _save(args, args["name"], meta={"tokens": toks.tolist()})


def task_search(args):
    """compile(search_budget=..., validate_top_k=...) on the mesh: save
    this rank's strategy JSON and the playoff's pick, then one fit step
    from data loaders (each rank copies its rows)."""
    ff, _ = _model(args)
    ff.compile(optimizer=AdamOptimizer(lr=1e-4),
               loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=[MetricsType.SPARSE_CATEGORICAL_CROSSENTROPY])
    strategy = dist.strategy_to_json(
        {n.name: n.sharding for n in ff.graph.nodes
         if n.sharding is not None})
    data = np.load(args["data"])
    m = ff.fit(dataloaders=[ff.create_data_loader(None, data["x0_0"]),
                            ff.create_data_loader(None, data["y_0"])],
               verbose=False)
    picked = getattr(ff, "strategy_validation", {})
    _save(args, args["name"], meta={
        "strategy": json.dumps(strategy, sort_keys=True),
        "nodes": [n.name for n in ff.executor.topo],
        "picked": picked.get("picked_modeled_rank"),
        "timed": len(picked.get("timed_ms", [])),
        "loss": m.sparse_cce_loss, "samples": m.train_all})


def task_checkpoint(args):
    """Train one step, save a checkpoint (rank 0 writes), and save the
    whole parameters for the test to hold the checkpoint to."""
    from flexflow_tpu_torch.runtime.checkpoint import save_checkpoint

    data = np.load(args["data"])
    ff, strategy = _model(args)
    params = params_from_numpy(_tree(data, "tr"), _tree(data, "ntr"), "cpu")
    ff.compile(optimizer=AdamOptimizer(lr=args["lr"]),
               loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
               strategy=strategy, params=params)
    ff.fit(data["x0_0"], data["y_0"], verbose=False)
    save_checkpoint(args["ckpt"], ff)
    full = ff.executor.gather_params(ff._params[0])
    _save(args, args["name"], _flat(full, "tr") if RANK == 0 else None)


def task_parallel_op(args):
    """One parallel op's forward and backward on this rank's pieces: the
    whole output and input gradient, gathered, on rank 0."""
    from flexflow_tpu_torch.ffconst import OpType
    from flexflow_tpu_torch.ops.registry import LowerCtx
    from flexflow_tpu_torch.parallel import parallel_ops as P
    from flexflow_tpu_torch.parallel import shard_rules, spmd
    from flexflow_tpu_torch.parallel.mesh import make_mesh
    from flexflow_tpu_torch.parallel.sharding import prune_spec
    from flexflow_tpu_torch.pcg.graph import Node
    from flexflow_tpu_torch.pcg.tensor import ParallelDim, ParallelTensorShape

    data = np.load(args["data"])
    mesh = make_mesh(args["mesh"])
    pm = spmd.ProcessMesh(mesh.axes)
    kind = args["op"]
    a = args["attrs"]
    attrs = {
        "repartition": lambda: P.RepartitionAttrs(a["dim"], tuple(a["axes"])),
        "combine": lambda: P.CombineAttrs(a["dim"], tuple(a["axes"])),
        "replicate": lambda: P.ReplicateAttrs(tuple(a["axes"])),
        "reduction": lambda: P.ReductionAttrs(None, tuple(a["axes"])),
        "all_to_all": lambda: P.AllToAllAttrs(a["src"], a["dst"],
                                              tuple(a["axes"])),
        "fused": lambda: P.FusedParallelOpAttrs(tuple(
            (k, d, tuple(ax)) for k, d, ax in a["steps"])),
    }[kind]()
    op = {"repartition": OpType.REPARTITION, "combine": OpType.COMBINE,
          "replicate": OpType.REPLICATE, "reduction": OpType.REDUCTION,
          "all_to_all": OpType.ALL_TO_ALL,
          "fused": OpType.FUSED_PARALLEL}[kind]
    x_full = torch.from_numpy(data["x"])
    shape = ParallelTensorShape(tuple(ParallelDim(s) for s in x_full.shape))
    node = Node(1, op, attrs, kind, outputs=(shape,))

    def prune(spec, shp):
        s = prune_spec(spec, tuple(shp), mesh) or ()
        return tuple(tuple(x) for x in s) + tuple(
            () for _ in range(len(shp) - len(s)))

    src = prune(tuple(tuple(x) for x in args["src_spec"]), x_full.shape)
    x = pm.shard(x_full, src).clone().requires_grad_()
    (y,), (lay,) = shard_rules.run_node(
        node, [x], [src], [tuple(x_full.shape)], {}, {}, {}, pm,
        LowerCtx(device=torch.device("cpu"), mesh=mesh), False, prune)
    cot = pm.shard(torch.from_numpy(data["cot"]), lay)
    y.backward(cot)
    # every rank takes part in the gathers; rank 0 writes them
    whole = {"y": pm.gather(y.detach(), lay).numpy(),
             "dx": pm.gather(x.grad, src).numpy()}
    _save(args, args["name"], whole if RANK == 0 else None,
          {"layout": [list(d) for d in lay], "local": list(y.shape)})


def task_ce(args):
    """The vocabulary-cut cross-entropy (logits cut over data on the
    rows and over model on the vocabulary): loss and gradient, whole."""
    from flexflow_tpu_torch.parallel import spmd
    from flexflow_tpu_torch.runtime.loss import sharded_loss

    data = np.load(args["data"])
    pm = spmd.ProcessMesh(args["mesh"])
    layout = (("data",), (), ("model",))
    logits = pm.shard(torch.from_numpy(data["logits"]), layout).clone()
    logits.requires_grad_()
    labels = pm.shard(torch.from_numpy(data["labels"]), (("data",), ()))
    loss, _, _ = sharded_loss(LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                              logits, layout, labels, False, pm, ("data",))
    loss.backward()
    whole = {"loss": loss.detach().numpy(),
             "grad": pm.gather(logits.grad, layout).numpy()}
    _save(args, args["name"], whole if RANK == 0 else None,
          {"loss": float(loss)})


def task_accuracy(args):
    """The accuracy of logits cut over data (rows) and model (vocabulary)
    without gathering them: the global batch's correct count on every
    rank."""
    from flexflow_tpu_torch.parallel import spmd
    from flexflow_tpu_torch.runtime.metrics import vocab_sharded_step_metrics

    data = np.load(args["data"])
    pm = spmd.ProcessMesh(args["mesh"])
    logits = pm.shard(torch.from_numpy(data["logits"]),
                      (("data",), (), ("model",)))
    labels = pm.shard(torch.from_numpy(data["labels"]), (("data",), ()))
    m = vocab_sharded_step_metrics([MetricsType.ACCURACY], logits, labels,
                                   None, pm, ("model",))
    correct = pm.all_reduce(m["accuracy_correct"], ("data",))
    _save(args, args["name"], meta={"correct": float(correct)})


def task_refusals(args):
    """What a process mesh refuses: a mesh whose data x seq x model is
    not the world size, the axes not ported, and serving on a mesh above
    1. Saves the messages."""
    out = {}
    for key, shape in (("world", {"data": 2}),
                       ("world_seq", {"data": 2, "seq": 4})):
        try:
            FFConfig(device="cpu", mesh_shape=shape)
        except ValueError as e:
            out[key] = str(e)
    for key, shape in (("pipe", {"pipe": 4}), ("expert", {"expert": 4}),
                       ("data_sub", {"data": 2, "data_sub": 2})):
        try:
            FFConfig(device="cpu", mesh_shape=shape)
        except NotImplementedError as e:
            out[key] = str(e)
    from flexflow_tpu_torch.models.llama import (
        LlamaConfig,
        build_llama,
        llama_tp_strategy,
    )

    ff = FFModel(FFConfig(batch_size=4, device="cpu",
                          mesh_shape={"data": 2, "seq": 2}))
    mc = LlamaConfig(**args["cfg"])
    build_llama(ff, mc, seq_len=8, dtype=DataType.FLOAT,
                use_ring_attention=True)
    ff.compile(loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
               strategy=llama_tp_strategy(mc, seq_parallel=True))
    for name, call in (
            ("serve", lambda: ff.serve(batch_sizes=(4,), warmup=False)),
            ("serve_generation",
             lambda: ff.serve_generation(slots=1, max_len=16)),
            ("paged", lambda: ff.serve_generation(slots=1, max_len=16,
                                                  paged=True))):
        try:
            call()
        except NotImplementedError as e:
            out[name] = str(e)
    _save(args, args["name"], meta=out)


TASKS = {"train": task_train, "predict": task_predict,
         "generate": task_generate, "search": task_search,
         "checkpoint": task_checkpoint, "parallel_op": task_parallel_op,
         "ce": task_ce, "accuracy": task_accuracy,
         "refusals": task_refusals}


def main():
    dist.initialize(device="cpu", timeout_s=60)
    _count_calls()
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        if line == "quit":
            break
        req = json.loads(line)
        try:
            TASKS[req["task"]](req["args"])
            reply = {"ok": True}
        except Exception:
            reply = {"ok": False, "error": traceback.format_exc()}
        sys.stdout.write(json.dumps(reply) + "\n")
        sys.stdout.flush()
    dist.shutdown()


if __name__ == "__main__":
    main()
