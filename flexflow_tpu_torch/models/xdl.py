"""XDL builder (counterpart of flexflow_tpu/models/xdl.py): many small
summed embeddings concatenated with the dense input into a dense stack,
the same calls in the same order as the reference."""

from __future__ import annotations

from typing import Sequence

from flexflow_tpu_torch.ffconst import ActiMode, AggrMode, DataType
from flexflow_tpu_torch.model import FFModel, Tensor


def build_xdl(ff: FFModel, num_sparse: int = 16, vocab: int = 100000,
              embed_dim: int = 16, dense_dim: int = 16,
              mlp_dims: Sequence[int] = (512, 256, 128, 1),
              batch_size: int = None) -> Tensor:
    b = batch_size or ff.config.batch_size
    parts = []
    for i in range(num_sparse):
        ids = ff.create_tensor((b, 1), DataType.INT32, name=f"sparse_{i}")
        # SUM aggregation collapses the bag dim to (b, embed_dim) directly
        # (same pattern as the DLRM builder — no reshape node needed)
        parts.append(ff.embedding(ids, vocab, embed_dim, AggrMode.SUM,
                                  name=f"emb_{i}"))
    dense_in = ff.create_tensor((b, dense_dim), DataType.FLOAT,
                                name="dense_input")
    parts.append(dense_in)
    t = ff.concat(parts, axis=1, name="cat")
    for i, d in enumerate(mlp_dims[:-1]):
        t = ff.dense(t, d, ActiMode.RELU, name=f"mlp{i}")
    t = ff.dense(t, mlp_dims[-1], ActiMode.SIGMOID, name="ctr")
    return t
