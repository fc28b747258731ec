"""The zoo's CNNs with BatchNorm against the JAX package's on the CPU:
ResNet-50 and ResNeXt-50 at 64x64 and Inception-v3 at 107x107, batch 4,
10 classes, the JAX model's weights carried over: the same predictions (BatchNorm on its running statistics), then
one SGD step at lr 1 (training BatchNorm on the batch's statistics) to
the same loss, the same parameters and the same moved running
statistics, within TOL (tests/torch_parity.py). The graphs at the
published sizes are compared in test_torch_zoo.py.

The sizes keep every training BatchNorm's statistics over at least 16
values a channel (the last stage at 2x2): over the 2 values of a batch
of 2 at 1x1, (x - mean) / sqrt(var + eps) is +-1 for any two inputs and
amplifies their fp32 rounding without bound, in both packages.

The trainable leaves after the step are held by the direction of their
update (cosine >= UPDATE_COS), not within TOL: the fp32 gradients of a
randomly initialised 50-layer BatchNorm net are ill-conditioned. At
ResNet-50, 64x64, batch 16, against a float64 evaluation of the same
graph, PyTorch's own fp32 gradients are off by up to 14% of a leaf's
largest entry (median 1.4%) with oneDNN's convolutions and up to 14%
(median 3.8%) with its native ones, and the two fp32 runs differ from
each other by up to 24%; the port against the reference at batch 4:
2.7% of the gradients' norm, every leaf's cosine >= 0.9994 (Inception-v3
at 107x107: >= 0.9985)."""
UPDATE_COS = 0.995

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from flexflow_tpu import models as jmodels  # noqa: E402
from flexflow_tpu_torch import LossType  # noqa: E402
from flexflow_tpu_torch import models as tmodels  # noqa: E402
from torch_parity import check_forward_and_step, model_pair  # noqa: E402

CASES = {"build_resnet50": 64, "build_resnext50": 64,
         "build_inception_v3": 107}
BATCH = 4


@pytest.mark.parametrize("builder", sorted(CASES))
def test_cnn_forward_and_train_step_match_reference(monkeypatch, builder):
    """...and the running statistics moved: after the step every
    BatchNorm's running mean differs from its initial zeros."""
    size = CASES[builder]

    def make(pkg):
        return lambda ff: getattr(pkg, builder)(
            ff, batch_size=BATCH, classes=10, image_size=size)

    jff, tff = model_pair(monkeypatch, make(jmodels), make(tmodels), BATCH,
                          LossType.SPARSE_CATEGORICAL_CROSSENTROPY)
    rs = np.random.RandomState(2)
    x = rs.randn(BATCH, 3, size, size).astype(np.float32)
    y = rs.randint(0, 10, BATCH).astype(np.int32)
    before, after = check_forward_and_step(jff, tff, [x], y,
                                           update_cos=UPDATE_COS)
    bns = [k for k in after if "running_mean" in after[k]]
    assert len(bns) > 50
    for k in bns:
        assert not np.array_equal(after[k]["running_mean"].numpy(),
                                  before[k]["running_mean"].numpy()), k
