"""Loss functions (counterpart of flexflow_tpu/runtime/loss.py).

`compute_loss` returns the scalar mean loss and autograd derives
dLoss/dLogit. Sparse cross-entropy on raw logits (the graph's final
Softmax skipped and fused into the loss) is `_FusedSparseCE`, with a
hand-written backward, as the reference's `_fused_sparse_ce` custom VJP:
plain torch ops, as the reference's are jnp.

On a process mesh (`sharded_loss`) the loss is the mean over the global
batch: each rank's rows (and, with the sequence cut over `seq`, its
tokens) summed and divided by the global count, then all-reduced over
the batch's and the sequence's axes. The logits keep their sequence
cut: nothing gathers them. Logits cut on the vocabulary take
`_VocabShardedCE`: the row max and the sum of exponentials are
all-reduced over the vocabulary's axes, the label's logit comes from the
rank that owns it, and the backward stays local.
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


class _VocabShardedCE(torch.autograd.Function):
    """sum(logsumexp(logits) - logits[target]) / n_total over (N, V/m)
    pieces of logits cut over `axes` (this rank's vocabulary block is
    [index * V/m, (index + 1) * V/m)); the same residuals and backward as
    _FusedSparseCE, on the rank's block."""

    @staticmethod
    def forward(ctx, logits, labels, pm, axes, n_total):
        import torch.distributed as dist

        v_loc = logits.shape[-1]
        labels = labels.long().clamp(0, v_loc * pm.degree(axes) - 1)
        lf = logits.float()
        m = pm.all_reduce(lf.amax(dim=-1), axes, op=dist.ReduceOp.MAX,
                          inplace=True)
        s = pm.all_reduce(torch.exp(lf - m[:, None]).sum(dim=-1), axes,
                          inplace=True)
        lse = m + torch.log(s)
        local = labels - pm.index(axes) * v_loc
        own = (local >= 0) & (local < v_loc)
        local = local.clamp(0, v_loc - 1)
        tgt = torch.gather(lf, 1, local[:, None])[:, 0] * own
        tgt = pm.all_reduce(tgt, axes, inplace=True)
        ctx.save_for_backward(logits, local, own, lse)
        ctx.n_total = n_total
        return torch.sum(lse - tgt) / n_total

    @staticmethod
    def backward(ctx, gbar):
        logits, local, own, lse = ctx.saved_tensors
        d = torch.exp(logits.float() - lse[:, None])
        rows = torch.arange(d.shape[0], device=d.device)
        d[rows, local] -= own.float()
        d *= gbar / ctx.n_total
        return d.to(logits.dtype), None, None, None, None


def sharded_loss(loss_type: LossType, logits, layout, labels,
                 last_op_is_softmax: bool, pm, batch_axes, seq_axes=()):
    """compute_loss on a process mesh: `logits` is this rank's piece,
    laid out as `layout`; `labels` are the rank's piece (cut over
    `batch_axes` on dim 0, and over `seq_axes` on dim 1 for (b, s, V)
    logits). Returns (loss, logits, their layout): the loss is the global
    mean, the same on every rank; the logits come back laid out with the
    batch over `batch_axes`, the sequence over `seq_axes`, the
    vocabulary cut as it was for a fused sparse cross-entropy and whole
    otherwise."""
    from flexflow_tpu_torch.parallel import spmd

    nd = logits.ndim
    fused = (loss_type == LossType.SPARSE_CATEGORICAL_CROSSENTROPY
             and not last_op_is_softmax and nd >= 2)
    v_axes = pm.keep(layout[-1]) if fused else ()
    seq_axes = tuple(seq_axes) if nd >= 3 else ()
    target = [tuple(batch_axes)] + [()] * (nd - 1)
    if seq_axes:
        target[1] = seq_axes
    if nd >= 2:
        target[-1] = v_axes
    target = tuple(target)
    logits = spmd.redistribute(logits, pm, layout, target)
    deg = pm.degree(pm.keep(batch_axes)) * pm.degree(pm.keep(seq_axes))
    if v_axes:
        lg, lb = _flatten_sparse(logits, labels)
        loss = _VocabShardedCE.apply(lg, lb, pm, v_axes, lg.shape[0] * deg)
    else:
        loss = compute_loss(loss_type, logits, labels,
                            last_op_is_softmax) / deg
    return (spmd.all_reduce(loss, pm, pm.live(tuple(batch_axes) + seq_axes)),
            logits, target)


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
