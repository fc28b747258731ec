"""DLRM builder (counterpart of flexflow_tpu/models/dlrm.py): summed
embedding bags and a bottom MLP concatenated into a top MLP with a
sigmoid output, the same calls in the same order as the reference."""

from __future__ import annotations

from typing import Sequence

from flexflow_tpu_torch.ffconst import ActiMode, AggrMode, DataType
from flexflow_tpu_torch.model import FFModel, Tensor


def _mlp(ff: FFModel, t: Tensor, dims: Sequence[int], name: str,
         final_act: ActiMode = ActiMode.RELU) -> Tensor:
    for i, d in enumerate(dims):
        act = final_act if i == len(dims) - 1 else ActiMode.RELU
        t = ff.dense(t, d, act, name=f"{name}{i}")
    return t


def build_dlrm(ff: FFModel, num_sparse: int = 8, vocab: int = 1000000,
               embed_dim: int = 64, dense_dim: int = 13,
               bag_size: int = 1,
               bot_mlp: Sequence[int] = (512, 256, 64),
               top_mlp: Sequence[int] = (512, 256, 1),
               batch_size: int = None) -> Tensor:
    """Embedding-heavy recommender (sigmoid CTR output; trained with MSE
    like the reference example)."""
    b = batch_size or ff.config.batch_size
    dense_in = ff.create_tensor((b, dense_dim), DataType.FLOAT, name="dense_input")
    x = _mlp(ff, dense_in, list(bot_mlp)[:-1] + [embed_dim], "bot")
    feats = [x]
    for i in range(num_sparse):
        ids = ff.create_tensor((b, bag_size), DataType.INT32, name=f"sparse{i}")
        e = ff.embedding(ids, vocab, embed_dim, AggrMode.SUM, name=f"emb{i}")
        feats.append(e)
    t = ff.concat(feats, axis=1, name="interact")
    t = _mlp(ff, t, list(top_mlp), "top", final_act=ActiMode.SIGMOID)
    return t
