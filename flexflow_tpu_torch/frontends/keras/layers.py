"""Keras-style layers (reference python/flexflow/keras/layers/*): thin
declarative records applied to an FFModel at compile time."""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

from flexflow_tpu_torch.ffconst import ActiMode, DataType, PoolType

_ACT = {
    None: ActiMode.NONE,
    "linear": ActiMode.NONE,
    "relu": ActiMode.RELU,
    "sigmoid": ActiMode.SIGMOID,
    "tanh": ActiMode.TANH,
    "gelu": ActiMode.GELU,
    "silu": ActiMode.SILU,
}


def _resolve_act(activation):
    """-> (fused ActiMode, needs_softmax). Softmax is not a fused activation
    in the op library; it becomes a trailing softmax op."""
    if activation == "softmax":
        return ActiMode.NONE, True
    if activation not in _ACT:
        raise ValueError(f"unsupported Keras activation {activation!r}")
    return _ACT[activation], False


class Layer:
    name: Optional[str] = None

    def apply(self, ff, *tensors):
        raise NotImplementedError


@dataclasses.dataclass
class KTensor:
    """Symbolic tensor for the functional API."""

    layer: "Layer"
    inputs: Tuple["KTensor", ...] = ()
    shape: Optional[Tuple[int, ...]] = None

    def __call__(self, *a, **k):  # pragma: no cover
        raise TypeError("KTensor is not callable")


def Input(shape: Sequence[int], dtype: DataType = DataType.FLOAT,
          name: Optional[str] = None) -> KTensor:
    lay = _InputLayer(tuple(shape), dtype, name)
    return KTensor(lay, (), tuple(shape))


@dataclasses.dataclass
class _InputLayer(Layer):
    shape: Tuple[int, ...]
    dtype: DataType = DataType.FLOAT
    name: Optional[str] = None

    def apply(self, ff, batch_size):
        return ff.create_tensor((batch_size, *self.shape), self.dtype,
                                name=self.name or "input")


class _CallableLayer(Layer):
    def __call__(self, *inputs):
        ins = []
        for i in inputs:
            if isinstance(i, (list, tuple)):
                ins.extend(i)
            else:
                ins.append(i)
        return KTensor(self, tuple(ins))


@dataclasses.dataclass
class Dense(_CallableLayer):
    units: int
    activation: Optional[str] = None
    use_bias: bool = True
    kernel_initializer: Optional[object] = None
    name: Optional[str] = None

    def apply(self, ff, x):
        act, softmax = _resolve_act(self.activation)
        y = ff.dense(x, self.units, act, self.use_bias,
                     kernel_initializer=self.kernel_initializer, name=self.name)
        return ff.softmax(y) if softmax else y


@dataclasses.dataclass
class Conv2D(_CallableLayer):
    filters: int
    kernel_size: Union[int, Tuple[int, int]] = 3
    strides: Union[int, Tuple[int, int]] = 1
    padding: Union[str, int] = "valid"
    activation: Optional[str] = None
    use_bias: bool = True
    name: Optional[str] = None

    def apply(self, ff, x):
        k = self.kernel_size if isinstance(self.kernel_size, tuple) else (self.kernel_size,) * 2
        s = self.strides if isinstance(self.strides, tuple) else (self.strides,) * 2
        if self.padding == "same":
            p = (k[0] // 2, k[1] // 2)
        elif self.padding == "valid":
            p = (0, 0)
        else:
            p = (self.padding, self.padding)
        act, softmax = _resolve_act(self.activation)
        y = ff.conv2d(x, self.filters, k[0], k[1], s[0], s[1], p[0], p[1],
                      act, use_bias=self.use_bias, name=self.name)
        return ff.softmax(y) if softmax else y


@dataclasses.dataclass
class MaxPooling2D(_CallableLayer):
    pool_size: Union[int, Tuple[int, int]] = 2
    strides: Optional[Union[int, Tuple[int, int]]] = None
    name: Optional[str] = None
    _pool_type = PoolType.MAX

    def apply(self, ff, x):
        k = self.pool_size if isinstance(self.pool_size, tuple) else (self.pool_size,) * 2
        s = self.strides or k
        s = s if isinstance(s, tuple) else (s,) * 2
        return ff.pool2d(x, k[0], k[1], s[0], s[1], pool_type=self._pool_type,
                         name=self.name)


@dataclasses.dataclass
class AveragePooling2D(MaxPooling2D):
    _pool_type = PoolType.AVG


@dataclasses.dataclass
class Flatten(_CallableLayer):
    name: Optional[str] = None

    def apply(self, ff, x):
        return ff.flat(x, name=self.name)


@dataclasses.dataclass
class Dropout(_CallableLayer):
    rate: float = 0.5
    name: Optional[str] = None

    def apply(self, ff, x):
        return ff.dropout(x, self.rate, name=self.name)


@dataclasses.dataclass
class Embedding(_CallableLayer):
    input_dim: int
    output_dim: int
    name: Optional[str] = None

    def apply(self, ff, x):
        return ff.embedding(x, self.input_dim, self.output_dim, name=self.name)


@dataclasses.dataclass
class Activation(_CallableLayer):
    activation: str = "relu"
    name: Optional[str] = None

    def apply(self, ff, x):
        if self.activation == "softmax":
            return ff.softmax(x, name=self.name)
        fn = {"relu": ff.relu, "sigmoid": ff.sigmoid, "tanh": ff.tanh,
              "gelu": ff.gelu, "silu": ff.silu}[self.activation]
        return fn(x, name=self.name)


@dataclasses.dataclass
class Concatenate(_CallableLayer):
    axis: int = -1
    name: Optional[str] = None

    def apply(self, ff, *xs):
        return ff.concat(list(xs), self.axis, name=self.name)


@dataclasses.dataclass
class Add(_CallableLayer):
    name: Optional[str] = None

    def apply(self, ff, a, b):
        return ff.add(a, b, name=self.name)
