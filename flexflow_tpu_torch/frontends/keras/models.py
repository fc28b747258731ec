"""Keras-style Sequential / functional Model (reference
python/flexflow/keras/models/base_model.py:31: compile :128, fit :198)."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.ffconst import LossType, MetricsType
from flexflow_tpu_torch.frontends.keras.layers import KTensor, Layer, _InputLayer
from flexflow_tpu_torch.model import FFModel
from flexflow_tpu_torch.runtime.optimizer import AdamOptimizer, Optimizer, SGDOptimizer

_LOSSES = {
    "sparse_categorical_crossentropy": LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
    "categorical_crossentropy": LossType.CATEGORICAL_CROSSENTROPY,
    "mean_squared_error": LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
    "mse": LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
}

_METRICS = {
    "accuracy": MetricsType.ACCURACY,
    "sparse_categorical_crossentropy": MetricsType.SPARSE_CATEGORICAL_CROSSENTROPY,
    "categorical_crossentropy": MetricsType.CATEGORICAL_CROSSENTROPY,
    "mean_squared_error": MetricsType.MEAN_SQUARED_ERROR,
    "mse": MetricsType.MEAN_SQUARED_ERROR,
    "mean_absolute_error": MetricsType.MEAN_ABSOLUTE_ERROR,
}

_OPTS = {
    "sgd": lambda: SGDOptimizer(lr=0.01),
    "adam": lambda: AdamOptimizer(lr=0.001),
}


class _BaseModel:
    def __init__(self, config: Optional[FFConfig] = None):
        self.config = config or FFConfig()
        self.ffmodel: Optional[FFModel] = None
        self._loss = None
        self._metrics: List[MetricsType] = []
        self._optimizer: Optional[Optimizer] = None

    def _build(self, batch_size: int):
        raise NotImplementedError

    def compile(self, optimizer="sgd", loss="sparse_categorical_crossentropy",
                metrics: Sequence[str] = ()):
        if isinstance(optimizer, str):
            optimizer = _OPTS[optimizer.lower()]()
        self._optimizer = optimizer
        self._loss = _LOSSES[loss] if isinstance(loss, str) else loss
        self._metrics = [_METRICS[m] if isinstance(m, str) else m for m in metrics]
        # always measure the loss itself so History/EarlyStopping see a
        # real "loss" value (keras semantics)
        loss_metric = {
            LossType.SPARSE_CATEGORICAL_CROSSENTROPY:
                MetricsType.SPARSE_CATEGORICAL_CROSSENTROPY,
            LossType.CATEGORICAL_CROSSENTROPY:
                MetricsType.CATEGORICAL_CROSSENTROPY,
            LossType.MEAN_SQUARED_ERROR_AVG_REDUCE:
                MetricsType.MEAN_SQUARED_ERROR,
            LossType.MEAN_SQUARED_ERROR_SUM_REDUCE:
                MetricsType.MEAN_SQUARED_ERROR,
        }.get(self._loss)
        if loss_metric is not None and loss_metric not in self._metrics:
            self._metrics.append(loss_metric)
        self.ffmodel = self._build(self.config.batch_size)
        self.ffmodel.compile(optimizer=self._optimizer, loss_type=self._loss,
                             metrics=self._metrics)
        return self

    def fit(self, x, y, epochs: int = 1, batch_size: Optional[int] = None,
            verbose: bool = True, callbacks: Sequence = ()):
        """Training loop with callback hooks (reference base_model.py:198).
        Always returns a History callback (keras convention)."""
        from flexflow_tpu_torch.frontends.keras.callbacks import (
            EarlyStopping, History,
        )

        history = next((c for c in callbacks if isinstance(c, History)), None)
        if history is None:
            history = History()
            callbacks = list(callbacks) + [history]
        for cb in callbacks:
            cb.model = self
            cb.on_train_begin()
        for epoch in range(epochs):
            for cb in callbacks:
                cb.on_epoch_begin(epoch)
            pm = self.ffmodel.fit(x, y, epochs=1, batch_size=batch_size,
                                  verbose=verbose)
            n = max(pm.train_all, 1)
            loss_field = {
                LossType.SPARSE_CATEGORICAL_CROSSENTROPY: pm.sparse_cce_loss,
                LossType.CATEGORICAL_CROSSENTROPY: pm.cce_loss,
                LossType.MEAN_SQUARED_ERROR_AVG_REDUCE: pm.mse_loss,
                LossType.MEAN_SQUARED_ERROR_SUM_REDUCE: pm.mse_loss,
            }.get(self._loss, pm.sparse_cce_loss)
            logs = {"loss": loss_field / n}
            if MetricsType.ACCURACY in self._metrics:
                logs["accuracy"] = pm.train_correct / n
            for cb in callbacks:
                cb.on_epoch_end(epoch, logs)
            if any(getattr(cb, "stop_training", False) for cb in callbacks):
                break
        for cb in callbacks:
            cb.on_train_end()
        return history

    def evaluate(self, x, y, batch_size: Optional[int] = None, verbose: bool = True):
        return self.ffmodel.eval(x, y, batch_size=batch_size, verbose=verbose)

    def predict(self, x, batch_size: Optional[int] = None):
        return self.ffmodel.predict(x, batch_size=batch_size)

    def summary(self) -> str:
        if self.ffmodel is None:
            return "<uncompiled>"
        lines = ["Layer (type)              Output shape"]
        for n in self.ffmodel.graph.topo_order():
            shape = str(n.outputs[0]) if n.outputs else "-"
            lines.append(f"{n.name:<25} {shape}")
        return "\n".join(lines)


class Sequential(_BaseModel):
    """reference keras Sequential (models/base_model.py)"""

    def __init__(self, layers: Optional[Sequence[Layer]] = None,
                 config: Optional[FFConfig] = None):
        super().__init__(config)
        self.layers: List[Layer] = list(layers or [])

    def add(self, layer: Layer):
        self.layers.append(layer)

    def _build(self, batch_size: int) -> FFModel:
        ff = FFModel(self.config)
        if not isinstance(self.layers[0], _InputLayer):
            raise ValueError("Sequential model must start with an Input layer "
                             "(use keras.Input(shape))")
        t = self.layers[0].apply(ff, batch_size)
        for lay in self.layers[1:]:
            t = lay.apply(ff, t)
        return ff

    def add_input(self, shape, **kw):
        from flexflow_tpu_torch.frontends.keras.layers import _InputLayer

        self.layers.insert(0, _InputLayer(tuple(shape), **kw))


class Model(_BaseModel):
    """Functional API: Model(inputs=[...], outputs=out_ktensor)."""

    def __init__(self, inputs: Union[KTensor, Sequence[KTensor]], outputs: KTensor,
                 config: Optional[FFConfig] = None):
        super().__init__(config)
        self.inputs = [inputs] if isinstance(inputs, KTensor) else list(inputs)
        self.outputs = outputs

    def _build(self, batch_size: int) -> FFModel:
        ff = FFModel(self.config)
        cache: Dict[int, object] = {}

        def lower(kt: KTensor):
            if id(kt) in cache:
                return cache[id(kt)]
            if isinstance(kt.layer, _InputLayer):
                t = kt.layer.apply(ff, batch_size)
            else:
                ins = [lower(i) for i in kt.inputs]
                t = kt.layer.apply(ff, *ins)
            cache[id(kt)] = t
            return t

        for i in self.inputs:
            lower(i)
        lower(self.outputs)
        return ff
