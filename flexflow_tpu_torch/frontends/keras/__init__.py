"""Keras-style frontend (reference python/flexflow/keras/).

Sequential and functional models whose layers record into an FFModel at
compile time; optimizer/loss/metric string names map like tf.keras.
"""

from flexflow_tpu_torch.frontends.keras.layers import (
    Activation,
    Add,
    Concatenate,
    Conv2D,
    Dense,
    Dropout,
    Embedding,
    Flatten,
    Input,
    MaxPooling2D,
    AveragePooling2D,
)
from flexflow_tpu_torch.frontends.keras.models import Model, Sequential

__all__ = [
    "Sequential",
    "Model",
    "Input",
    "Dense",
    "Conv2D",
    "MaxPooling2D",
    "AveragePooling2D",
    "Flatten",
    "Dropout",
    "Embedding",
    "Concatenate",
    "Add",
    "Activation",
]

from flexflow_tpu_torch.frontends.keras import callbacks, datasets, optimizers  # noqa: E402

__all__ += ["callbacks", "datasets", "optimizers"]
