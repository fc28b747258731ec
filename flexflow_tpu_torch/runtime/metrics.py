"""Training metrics (counterpart of flexflow_tpu/runtime/metrics.py).

`compute_step_metrics` gives each batch's metrics as 0-d tensors on the
device, with no host sync; `vocab_sharded_step_metrics` gives those of
logits cut on the vocabulary over a process mesh, without gathering
them; `PerfMetrics` is the host-side accumulator that fit() fills once
per epoch and eval() once per batch.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Sequence

import torch

from flexflow_tpu_torch.ffconst import LossType, MetricsType

LOSS_KEYS = ("cce_loss", "sparse_cce_loss", "mse_loss", "rmse_loss",
             "mae_loss")
# the metrics vocab_sharded_step_metrics computes
VOCAB_SHARDED_METRICS = frozenset({
    MetricsType.ACCURACY, MetricsType.SPARSE_CATEGORICAL_CROSSENTROPY})


@dataclasses.dataclass
class PerfMetrics:
    """Host-side accumulator (the reference's PerfMetrics struct)."""

    train_all: int = 0
    train_correct: float = 0
    cce_loss: float = 0.0
    sparse_cce_loss: float = 0.0
    mse_loss: float = 0.0
    rmse_loss: float = 0.0
    mae_loss: float = 0.0
    start_time: float = dataclasses.field(default_factory=time.time)

    def update(self, step_metrics: Dict[str, float], batch: int):
        self.train_all += batch
        if "accuracy_correct" in step_metrics:
            self.train_correct += float(step_metrics["accuracy_correct"])
        for k in LOSS_KEYS:
            if k in step_metrics:
                setattr(self, k,
                        getattr(self, k) + float(step_metrics[k]) * batch)

    def report(self, measured: Sequence[MetricsType]) -> str:
        out = [f"samples={self.train_all}"]
        n = max(self.train_all, 1)
        if MetricsType.ACCURACY in measured:
            out.append(f"accuracy={100.0 * self.train_correct / n:.2f}%")
        if MetricsType.SPARSE_CATEGORICAL_CROSSENTROPY in measured:
            out.append(f"sparse_cce={self.sparse_cce_loss / n:.4f}")
        if MetricsType.CATEGORICAL_CROSSENTROPY in measured:
            out.append(f"cce={self.cce_loss / n:.4f}")
        if MetricsType.MEAN_SQUARED_ERROR in measured:
            out.append(f"mse={self.mse_loss / n:.4f}")
        if MetricsType.ROOT_MEAN_SQUARED_ERROR in measured:
            out.append(f"rmse={self.rmse_loss / n:.4f}")
        if MetricsType.MEAN_ABSOLUTE_ERROR in measured:
            out.append(f"mae={self.mae_loss / n:.4f}")
        elapsed = max(time.time() - self.start_time, 1e-9)
        out.append(f"throughput={self.train_all / elapsed:.1f} samples/s")
        return " ".join(out)


@torch.no_grad()
def compute_step_metrics(measured: Sequence[MetricsType],
                         loss_type: LossType, logits, labels,
                         last_op_is_softmax: bool = True
                         ) -> Dict[str, torch.Tensor]:
    """Per-batch metric values on the device (means over the batch; the
    accumulator re-weights by batch size)."""
    out: Dict[str, torch.Tensor] = {}
    lf = logits.float()
    sparse = loss_type == LossType.SPARSE_CATEGORICAL_CROSSENTROPY
    batch = labels.shape[0]
    if sparse:
        if lf.ndim > 2:  # per-token LM metrics
            lf = lf.reshape(-1, lf.shape[-1])
            lbl = labels.reshape(-1).long()
        else:
            lbl = labels.reshape(labels.shape[0], -1)[:, 0].long()
    for m in measured:
        if m == MetricsType.ACCURACY:
            pred = torch.argmax(lf, dim=-1)
            truth = lbl if sparse else torch.argmax(labels, dim=-1)
            # per-token accuracy averaged over each sample's tokens, so
            # the accumulator counts samples
            out["accuracy_correct"] = (pred == truth).float().mean() * batch
        elif m == MetricsType.SPARSE_CATEGORICAL_CROSSENTROPY:
            if last_op_is_softmax:
                ll = torch.gather(lf, 1, lbl[:, None])[:, 0]
                out["sparse_cce_loss"] = -torch.mean(
                    torch.log(torch.clamp(ll, min=1e-30)))
            else:  # fused log-softmax on raw logits (matches loss.py)
                lse = torch.logsumexp(lf, dim=-1)
                tgt = torch.gather(lf, 1, lbl[:, None])[:, 0]
                out["sparse_cce_loss"] = torch.mean(lse - tgt)
        elif m == MetricsType.CATEGORICAL_CROSSENTROPY:
            logp = (torch.log(torch.clamp(lf, min=1e-30))
                    if last_op_is_softmax else torch.log_softmax(lf, dim=-1))
            out["cce_loss"] = -torch.mean(
                torch.sum(labels.float() * logp, dim=-1))
        elif m == MetricsType.MEAN_SQUARED_ERROR:
            out["mse_loss"] = torch.mean(torch.square(lf - labels.float()))
        elif m == MetricsType.ROOT_MEAN_SQUARED_ERROR:
            out["rmse_loss"] = torch.sqrt(
                torch.mean(torch.square(lf - labels.float())))
        elif m == MetricsType.MEAN_ABSOLUTE_ERROR:
            out["mae_loss"] = torch.mean(torch.abs(lf - labels.float()))
    return out


@torch.no_grad()
def vocab_sharded_step_metrics(measured: Sequence[MetricsType], logits,
                               labels, loss, pm, axes
                               ) -> Dict[str, torch.Tensor]:
    """compute_step_metrics of raw logits cut over `axes` on the
    vocabulary (this rank's block is [index * V/m, (index + 1) * V/m)),
    for this rank's rows, under the fused sparse cross-entropy `loss`
    (the global batch's mean of the same logits, runtime/loss.py's
    _VocabShardedCE), which is that metric's value. The prediction is
    the argmax over the whole vocabulary: each row's largest logit
    all-reduced (max), then the least index that holds it (min), the
    first as torch.argmax takes it. Only VOCAB_SHARDED_METRICS."""
    import torch.distributed as dist

    out: Dict[str, torch.Tensor] = {}
    lf = logits.float()
    batch = labels.shape[0]
    if lf.ndim > 2:
        lf = lf.reshape(-1, lf.shape[-1])
        lbl = labels.reshape(-1).long()
    else:
        lbl = labels.reshape(labels.shape[0], -1)[:, 0].long()
    v_loc = lf.shape[-1]
    for m in measured:
        if m == MetricsType.ACCURACY:
            best, idx = lf.max(dim=-1)
            # not in place: `best` is compared with the maximum below
            top = pm.all_reduce(best, axes, op=dist.ReduceOp.MAX)
            first = torch.where(best == top, idx + pm.index(axes) * v_loc,
                                torch.full_like(idx, v_loc * pm.degree(axes)))
            pred = pm.all_reduce(first, axes, op=dist.ReduceOp.MIN,
                                 inplace=True)
            out["accuracy_correct"] = (pred == lbl).float().mean() * batch
        elif m == MetricsType.SPARSE_CATEGORICAL_CROSSENTROPY:
            out["sparse_cce_loss"] = loss
        else:
            raise ValueError(f"{m} needs the whole vocabulary")
    return out
