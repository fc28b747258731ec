"""Keras-style callbacks (counterpart of
flexflow_tpu/frontends/keras/callbacks.py; the reference's
python/flexflow/keras/callbacks.py:
Callback/History/LearningRateScheduler/EarlyStopping surface).

Driven by the keras models' fit(): one framework epoch per iteration with
on_epoch_begin/end hooks; logs carry loss/accuracy from PerfMetrics.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


class Callback:
    model = None  # set by fit()

    def on_train_begin(self, logs: Optional[Dict] = None):
        pass

    def on_train_end(self, logs: Optional[Dict] = None):
        pass

    def on_epoch_begin(self, epoch: int, logs: Optional[Dict] = None):
        pass

    def on_epoch_end(self, epoch: int, logs: Optional[Dict] = None):
        pass


class History(Callback):
    """Records per-epoch logs (reference keras History)."""

    def __init__(self):
        self.history: Dict[str, List[float]] = {}
        self.epoch: List[int] = []

    def on_epoch_end(self, epoch, logs=None):
        self.epoch.append(epoch)
        for k, v in (logs or {}).items():
            self.history.setdefault(k, []).append(v)


class EarlyStopping(Callback):
    """Stop when a monitored metric stops improving."""

    def __init__(self, monitor: str = "loss", min_delta: float = 0.0,
                 patience: int = 0, mode: str = "auto"):
        self.monitor = monitor
        self.min_delta = abs(min_delta)
        self.patience = patience
        self.mode = mode
        self.best: Optional[float] = None
        self.wait = 0
        self.stopped_epoch = 0
        self.stop_training = False

    def _better(self, cur: float, best: float) -> bool:
        if self.mode == "max" or (self.mode == "auto" and "acc" in self.monitor):
            return cur > best + self.min_delta
        return cur < best - self.min_delta

    def on_epoch_end(self, epoch, logs=None):
        cur = (logs or {}).get(self.monitor)
        if cur is None:
            return
        if self.best is None or self._better(cur, self.best):
            self.best = cur
            self.wait = 0
            return
        self.wait += 1
        if self.wait > self.patience:
            self.stopped_epoch = epoch
            self.stop_training = True


class LearningRateScheduler(Callback):
    """schedule(epoch, lr) -> new lr, set on the model's optimizer before
    the epoch (the reference's per-epoch lr update); the next step
    updates with it."""

    def __init__(self, schedule):
        self.schedule = schedule

    def on_epoch_begin(self, epoch, logs=None):
        ff = self.model.ffmodel
        opt = ff._optimizer
        new_lr = float(self.schedule(epoch, opt.lr))
        if new_lr != opt.lr:
            ff._optimizer = dataclasses.replace(opt, lr=new_lr)
            ff.executor.optimizer = ff._optimizer


class ModelCheckpoint(Callback):
    """Periodic checkpoint via the runtime checkpoint module."""

    def __init__(self, filepath: str, save_freq: int = 1):
        self.filepath = filepath
        self.save_freq = save_freq

    def on_epoch_end(self, epoch, logs=None):
        if (epoch + 1) % self.save_freq == 0:
            from flexflow_tpu_torch.runtime.checkpoint import save_checkpoint

            save_checkpoint(self.filepath.format(epoch=epoch),
                            self.model.ffmodel)
