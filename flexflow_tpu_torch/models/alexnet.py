"""AlexNet builders (counterpart of flexflow_tpu/models/alexnet.py): the
229x229 ImageNet-shaped net and the 32x32 CIFAR-10 variant, NCHW, the
same calls in the same order as the reference."""

from __future__ import annotations

from flexflow_tpu_torch.ffconst import ActiMode, DataType
from flexflow_tpu_torch.model import FFModel, Tensor


def build_alexnet(ff: FFModel, batch_size: int = None, classes: int = 10) -> Tensor:
    b = batch_size or ff.config.batch_size
    t = ff.create_tensor((b, 3, 229, 229), DataType.FLOAT, name="input")
    t = ff.conv2d(t, 64, 11, 11, 4, 4, 2, 2, ActiMode.RELU, name="conv1")
    t = ff.pool2d(t, 3, 3, 2, 2, name="pool1")
    t = ff.conv2d(t, 192, 5, 5, 1, 1, 2, 2, ActiMode.RELU, name="conv2")
    t = ff.pool2d(t, 3, 3, 2, 2, name="pool2")
    t = ff.conv2d(t, 384, 3, 3, 1, 1, 1, 1, ActiMode.RELU, name="conv3")
    t = ff.conv2d(t, 256, 3, 3, 1, 1, 1, 1, ActiMode.RELU, name="conv4")
    t = ff.conv2d(t, 256, 3, 3, 1, 1, 1, 1, ActiMode.RELU, name="conv5")
    t = ff.pool2d(t, 3, 3, 2, 2, name="pool3")
    t = ff.flat(t, name="flat")
    t = ff.dense(t, 4096, ActiMode.RELU, name="fc6")
    t = ff.dense(t, 4096, ActiMode.RELU, name="fc7")
    t = ff.dense(t, classes, name="fc8")
    return ff.softmax(t, name="softmax")


def build_alexnet_cifar10(ff: FFModel, batch_size: int = None) -> Tensor:
    """CIFAR-10-sized variant (32x32 inputs, the bootcamp demo's data)."""
    b = batch_size or ff.config.batch_size
    t = ff.create_tensor((b, 3, 32, 32), DataType.FLOAT, name="input")
    t = ff.conv2d(t, 64, 5, 5, 1, 1, 2, 2, ActiMode.RELU, name="conv1")
    t = ff.pool2d(t, 3, 3, 2, 2, name="pool1")
    t = ff.conv2d(t, 192, 5, 5, 1, 1, 2, 2, ActiMode.RELU, name="conv2")
    t = ff.pool2d(t, 3, 3, 2, 2, name="pool2")
    t = ff.conv2d(t, 384, 3, 3, 1, 1, 1, 1, ActiMode.RELU, name="conv3")
    t = ff.conv2d(t, 256, 3, 3, 1, 1, 1, 1, ActiMode.RELU, name="conv4")
    t = ff.conv2d(t, 256, 3, 3, 1, 1, 1, 1, ActiMode.RELU, name="conv5")
    t = ff.pool2d(t, 3, 3, 2, 2, name="pool3")
    t = ff.flat(t, name="flat")
    t = ff.dense(t, 1024, ActiMode.RELU, name="fc6")
    t = ff.dense(t, 1024, ActiMode.RELU, name="fc7")
    t = ff.dense(t, 10, name="fc8")
    return ff.softmax(t, name="softmax")
