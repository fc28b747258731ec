"""keras-style optimizer constructors (reference
python/flexflow/keras/optimizers.py): thin names over the runtime
optimizers, keras argument spellings accepted."""

from __future__ import annotations

from flexflow_tpu_torch.runtime.optimizer import AdamOptimizer, SGDOptimizer


def SGD(learning_rate: float = 0.01, momentum: float = 0.0,
        nesterov: bool = False, weight_decay: float = 0.0) -> SGDOptimizer:
    return SGDOptimizer(lr=learning_rate, momentum=momentum,
                        nesterov=nesterov, weight_decay=weight_decay)


def Adam(learning_rate: float = 0.001, beta_1: float = 0.9,
         beta_2: float = 0.999, epsilon: float = 1e-7) -> AdamOptimizer:
    return AdamOptimizer(lr=learning_rate, beta1=beta_1, beta2=beta_2,
                         epsilon=epsilon)
