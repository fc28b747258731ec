"""Framework-wide enums (counterpart of flexflow_tpu/ffconst.py).

The same names and values as the JAX package, so graphs built by either
package describe the same operators; DataType carries a torch dtype in
place of a jnp dtype.
"""

from __future__ import annotations

import enum

import torch

_TORCH_DTYPES = {
    "bool": torch.bool,
    "int32": torch.int32,
    "int64": torch.int64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
}


class DataType(enum.Enum):
    BOOL = "bool"
    INT32 = "int32"
    INT64 = "int64"
    HALF = "float16"
    BFLOAT16 = "bfloat16"
    FLOAT = "float32"
    DOUBLE = "float64"

    @property
    def torch_dtype(self) -> torch.dtype:
        return _TORCH_DTYPES[self.value]

    @property
    def size_bytes(self) -> int:
        return self.torch_dtype.itemsize


class _Coercible:
    """Mixin for enums the layer builders accept as enum | str | None:
    attrs always carry the enum, so lowerings compare against members."""

    @classmethod
    def coerce(cls, value):
        if value is None and hasattr(cls, "NONE"):
            return cls.NONE
        if isinstance(value, cls):
            return value
        return cls(str(value).lower())


class ActiMode(_Coercible, enum.Enum):
    NONE = "none"
    RELU = "relu"
    SIGMOID = "sigmoid"
    TANH = "tanh"
    GELU = "gelu"
    SILU = "silu"


class AggrMode(_Coercible, enum.Enum):
    """Embedding aggregation (reference: AGGR_MODE_{NONE,SUM,AVG})."""

    NONE = "none"
    SUM = "sum"
    AVG = "avg"


class LossType(enum.Enum):
    CATEGORICAL_CROSSENTROPY = "categorical_crossentropy"
    SPARSE_CATEGORICAL_CROSSENTROPY = "sparse_categorical_crossentropy"
    MEAN_SQUARED_ERROR_AVG_REDUCE = "mean_squared_error_avg_reduce"
    MEAN_SQUARED_ERROR_SUM_REDUCE = "mean_squared_error_sum_reduce"
    IDENTITY = "identity"


class OpType(enum.Enum):
    """Operator types: the PCG node vocabulary, with the JAX package's
    values. Only the ops of the Llama serving path have lowerings in the
    port so far (ops/torch_ops.py); the rest are named so graphs and
    hashes line up with the reference."""

    INPUT = "input"
    WEIGHT = "weight"
    NOOP = "noop"
    CONV2D = "conv2d"
    LINEAR = "linear"
    EMBEDDING = "embedding"
    BATCH_MATMUL = "batch_matmul"
    MULTIHEAD_ATTENTION = "multihead_attention"
    RING_ATTENTION = "ring_attention"
    ELEMENT_BINARY = "element_binary"
    ELEMENT_UNARY = "element_unary"
    RESHAPE = "reshape"
    FLAT = "flat"
    TRANSPOSE = "transpose"
    REVERSE = "reverse"
    CONCAT = "concat"
    SPLIT = "split"
    POOL2D = "pool2d"
    BATCH_NORM = "batch_norm"
    LAYER_NORM = "layer_norm"
    RMS_NORM = "rms_norm"
    SOFTMAX = "softmax"
    DROPOUT = "dropout"
    CAST = "cast"
    GATHER = "gather"
    REDUCE_SUM = "reduce_sum"
    MEAN = "mean"
    LSTM = "lstm"
    TOPK = "topk"
    GROUP_BY = "group_by"
    AGGREGATE = "aggregate"
    AGGREGATE_SPEC = "aggregate_spec"
    CACHE = "cache"
    EXPERTS = "experts"
    FUSED = "fused"
    REPARTITION = "repartition"
    COMBINE = "combine"
    REPLICATE = "replicate"
    REDUCTION = "reduction"
    ALL_TO_ALL = "all_to_all"
    FUSED_PARALLEL = "fused_parallel"
    PIPELINE = "pipeline"
    LOSS = "loss"
    METRICS = "metrics"
