"""ResNet-50 builder (counterpart of flexflow_tpu/models/resnet.py):
bottleneck blocks of 1x1 -> 3x3 -> 1x1 convolutions with BatchNorm,
NCHW, the same calls in the same order as the reference."""

from __future__ import annotations

from flexflow_tpu_torch.ffconst import DataType
from flexflow_tpu_torch.model import FFModel, Tensor


def _bottleneck(ff: FFModel, t: Tensor, out_ch: int, stride: int, name: str) -> Tensor:
    """1x1 -> 3x3 -> 1x1 with 4x expansion + projection shortcut when shape
    changes (reference resnet.cc BottleneckBlock)."""
    shortcut = t
    in_ch = t.shape[1]
    u = ff.conv2d(t, out_ch, 1, 1, 1, 1, 0, 0, name=f"{name}_c1")
    u = ff.batch_norm(u, relu=True, name=f"{name}_bn1")
    u = ff.conv2d(u, out_ch, 3, 3, stride, stride, 1, 1, name=f"{name}_c2")
    u = ff.batch_norm(u, relu=True, name=f"{name}_bn2")
    u = ff.conv2d(u, 4 * out_ch, 1, 1, 1, 1, 0, 0, name=f"{name}_c3")
    u = ff.batch_norm(u, relu=False, name=f"{name}_bn3")
    if stride != 1 or in_ch != 4 * out_ch:
        shortcut = ff.conv2d(t, 4 * out_ch, 1, 1, stride, stride, 0, 0,
                             name=f"{name}_proj")
        shortcut = ff.batch_norm(shortcut, relu=False, name=f"{name}_bnp")
    u = ff.add(u, shortcut, name=f"{name}_add")
    return ff.relu(u, name=f"{name}_relu")


def build_resnet50(ff: FFModel, batch_size: int = None, classes: int = 1000,
                   image_size: int = 224) -> Tensor:
    b = batch_size or ff.config.batch_size
    t = ff.create_tensor((b, 3, image_size, image_size), DataType.FLOAT, name="input")
    t = ff.conv2d(t, 64, 7, 7, 2, 2, 3, 3, name="conv1")
    t = ff.batch_norm(t, relu=True, name="bn1")
    t = ff.pool2d(t, 3, 3, 2, 2, 1, 1, name="pool1")
    for stage, (blocks, ch, stride) in enumerate(
        [(3, 64, 1), (4, 128, 2), (6, 256, 2), (3, 512, 2)]
    ):
        for i in range(blocks):
            t = _bottleneck(ff, t, ch, stride if i == 0 else 1,
                            f"s{stage}b{i}")
    # global average pool over spatial dims
    t = ff.mean(t, axes=(2, 3), name="gap")
    t = ff.dense(t, classes, name="fc")
    return ff.softmax(t, name="softmax")
