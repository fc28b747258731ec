"""ResNeXt-50 (32x4d) builder (counterpart of
flexflow_tpu/models/resnext.py): bottlenecks whose 3x3 convolution has 32
feature groups, NCHW, the same calls in the same order as the
reference."""

from __future__ import annotations

from flexflow_tpu_torch.ffconst import DataType
from flexflow_tpu_torch.model import FFModel, Tensor


def _resnext_block(ff: FFModel, t: Tensor, mid_ch: int, out_ch: int,
                   stride: int, groups: int, name: str) -> Tensor:
    shortcut = t
    in_ch = t.shape[1]
    u = ff.conv2d(t, mid_ch, 1, 1, 1, 1, 0, 0, use_bias=False,
                  name=f"{name}_c1")
    u = ff.batch_norm(u, relu=True, name=f"{name}_bn1")
    u = ff.conv2d(u, mid_ch, 3, 3, stride, stride, 1, 1, groups=groups,
                  use_bias=False, name=f"{name}_c2")
    u = ff.batch_norm(u, relu=True, name=f"{name}_bn2")
    u = ff.conv2d(u, out_ch, 1, 1, 1, 1, 0, 0, use_bias=False,
                  name=f"{name}_c3")
    u = ff.batch_norm(u, relu=False, name=f"{name}_bn3")
    if stride != 1 or in_ch != out_ch:
        shortcut = ff.conv2d(t, out_ch, 1, 1, stride, stride, 0, 0,
                             use_bias=False, name=f"{name}_proj")
        shortcut = ff.batch_norm(shortcut, relu=False, name=f"{name}_bnp")
    u = ff.add(u, shortcut, name=f"{name}_add")
    return ff.relu(u, name=f"{name}_relu")


def build_resnext50(ff: FFModel, batch_size: int = None, classes: int = 1000,
                    image_size: int = 224, groups: int = 32,
                    width_per_group: int = 4) -> Tensor:
    b = batch_size or ff.config.batch_size
    t = ff.create_tensor((b, 3, image_size, image_size), DataType.FLOAT,
                         name="input")
    t = ff.conv2d(t, 64, 7, 7, 2, 2, 3, 3, use_bias=False, name="conv1")
    t = ff.batch_norm(t, relu=True, name="bn1")
    t = ff.pool2d(t, 3, 3, 2, 2, 1, 1, name="pool1")
    for stage, (blocks, base, stride) in enumerate(
        [(3, 64, 1), (4, 128, 2), (6, 256, 2), (3, 512, 2)]
    ):
        mid = base * groups * width_per_group // 64
        for i in range(blocks):
            t = _resnext_block(ff, t, mid, base * 4, stride if i == 0 else 1,
                               groups, f"s{stage}b{i}")
    t = ff.mean(t, axes=(2, 3), name="gap")
    t = ff.dense(t, classes, name="fc")
    return ff.softmax(t, name="softmax")
