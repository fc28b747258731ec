"""Loss functions (counterpart of flexflow_tpu/runtime/loss.py).

`compute_loss` returns the scalar mean loss and autograd derives
dLoss/dLogit. Sparse cross-entropy on raw logits (the graph's final
Softmax skipped and fused into the loss) is `_FusedSparseCE`, with a
hand-written backward, as the reference's `_fused_sparse_ce` custom VJP:
plain torch ops, as the reference's are jnp.
"""

from __future__ import annotations

import torch

from flexflow_tpu_torch.ffconst import LossType


class _FusedSparseCE(torch.autograd.Function):
    """mean(logsumexp(logits) - logits[target]) over (N, V) logits.

    The residuals are the logits in their own dtype (typically bf16) plus
    a per-row fp32 logsumexp, never an fp32 copy or a log-softmax; the
    backward is (softmax - onehot) / N in the logits' dtype (the
    reference's analytic softmax gradient)."""

    @staticmethod
    def forward(ctx, logits, labels):
        # clamp once so the forward gather and the backward one-hot agree
        # on the target index even for out-of-range labels
        labels = labels.long().clamp(0, logits.shape[-1] - 1)
        lf = logits.float()
        lse = torch.logsumexp(lf, dim=-1)
        tgt = torch.gather(lf, 1, labels[:, None])[:, 0]
        ctx.save_for_backward(logits, labels, lse)
        return torch.mean(lse - tgt)

    @staticmethod
    def backward(ctx, gbar):
        logits, labels, lse = ctx.saved_tensors
        n = logits.shape[0]
        d = torch.exp(logits.float() - lse[:, None])
        d[torch.arange(n, device=d.device), labels] -= 1.0
        d *= gbar / n
        return d.to(logits.dtype), None


def _flatten_sparse(logits, labels):
    """(b, ..., V) logits with (b, ...) labels -> (N, V), (N,) for the
    per-token LM loss; (b, V) logits keep the first label column."""
    if logits.ndim > 2:
        return (logits.reshape(-1, logits.shape[-1]),
                labels.reshape(-1).long())
    return logits, labels.reshape(labels.shape[0], -1)[:, 0].long()


def compute_loss(loss_type: LossType, logits, labels,
                 last_op_is_softmax: bool = True):
    """Scalar mean loss. `logits` is the final op's output: probabilities
    when `last_op_is_softmax`, otherwise raw logits with the softmax
    fused into the loss as a log-softmax."""
    b = logits.shape[0]
    lf = logits.float()
    if loss_type == LossType.SPARSE_CATEGORICAL_CROSSENTROPY:
        logits, labels = _flatten_sparse(logits, labels)
        if last_op_is_softmax:
            ll = torch.gather(logits.float(), 1, labels[:, None])[:, 0]
            return -torch.mean(torch.log(torch.clamp(ll, min=1e-30)))
        return _FusedSparseCE.apply(logits, labels)
    if loss_type == LossType.CATEGORICAL_CROSSENTROPY:
        logp = (torch.log(torch.clamp(lf, min=1e-30)) if last_op_is_softmax
                else torch.log_softmax(lf, dim=-1))
        return -torch.mean(torch.sum(labels.float() * logp, dim=-1))
    if loss_type == LossType.MEAN_SQUARED_ERROR_AVG_REDUCE:
        return torch.mean(torch.square(lf - labels.float()))
    if loss_type == LossType.MEAN_SQUARED_ERROR_SUM_REDUCE:
        return torch.sum(torch.square(lf - labels.float())) / b
    if loss_type == LossType.IDENTITY:
        return torch.mean(lf * labels.float())
    raise ValueError(f"unknown loss {loss_type}")
