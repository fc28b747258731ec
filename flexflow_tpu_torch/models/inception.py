"""Inception-v3 builder (counterpart of flexflow_tpu/models/inception.py):
multi-branch blocks joined by Concat, factorised 1x7 / 7x1 convolutions,
average pools with padding, NCHW, the same calls in the same order as
the reference."""

from __future__ import annotations

from flexflow_tpu_torch.ffconst import DataType, PoolType
from flexflow_tpu_torch.model import FFModel, Tensor


def _conv_bn(ff: FFModel, t: Tensor, ch: int, kh: int, kw: int,
             sh: int = 1, sw: int = 1, ph: int = 0, pw: int = 0,
             name: str = "") -> Tensor:
    t = ff.conv2d(t, ch, kh, kw, sh, sw, ph, pw, use_bias=False,
                  name=f"{name}_conv")
    return ff.batch_norm(t, relu=True, name=f"{name}_bn")


def _inception_a(ff, t, pool_ch, name):
    b1 = _conv_bn(ff, t, 64, 1, 1, name=f"{name}_b1")
    b2 = _conv_bn(ff, t, 48, 1, 1, name=f"{name}_b2a")
    b2 = _conv_bn(ff, b2, 64, 5, 5, 1, 1, 2, 2, name=f"{name}_b2b")
    b3 = _conv_bn(ff, t, 64, 1, 1, name=f"{name}_b3a")
    b3 = _conv_bn(ff, b3, 96, 3, 3, 1, 1, 1, 1, name=f"{name}_b3b")
    b3 = _conv_bn(ff, b3, 96, 3, 3, 1, 1, 1, 1, name=f"{name}_b3c")
    b4 = ff.pool2d(t, 3, 3, 1, 1, 1, 1, PoolType.AVG, name=f"{name}_pool")
    b4 = _conv_bn(ff, b4, pool_ch, 1, 1, name=f"{name}_b4")
    return ff.concat([b1, b2, b3, b4], axis=1, name=f"{name}_cat")


def _inception_b(ff, t, name):
    b1 = _conv_bn(ff, t, 384, 3, 3, 2, 2, name=f"{name}_b1")
    b2 = _conv_bn(ff, t, 64, 1, 1, name=f"{name}_b2a")
    b2 = _conv_bn(ff, b2, 96, 3, 3, 1, 1, 1, 1, name=f"{name}_b2b")
    b2 = _conv_bn(ff, b2, 96, 3, 3, 2, 2, name=f"{name}_b2c")
    b3 = ff.pool2d(t, 3, 3, 2, 2, name=f"{name}_pool")
    return ff.concat([b1, b2, b3], axis=1, name=f"{name}_cat")


def _inception_c(ff, t, ch7, name):
    b1 = _conv_bn(ff, t, 192, 1, 1, name=f"{name}_b1")
    b2 = _conv_bn(ff, t, ch7, 1, 1, name=f"{name}_b2a")
    b2 = _conv_bn(ff, b2, ch7, 1, 7, 1, 1, 0, 3, name=f"{name}_b2b")
    b2 = _conv_bn(ff, b2, 192, 7, 1, 1, 1, 3, 0, name=f"{name}_b2c")
    b3 = _conv_bn(ff, t, ch7, 1, 1, name=f"{name}_b3a")
    b3 = _conv_bn(ff, b3, ch7, 7, 1, 1, 1, 3, 0, name=f"{name}_b3b")
    b3 = _conv_bn(ff, b3, ch7, 1, 7, 1, 1, 0, 3, name=f"{name}_b3c")
    b3 = _conv_bn(ff, b3, ch7, 7, 1, 1, 1, 3, 0, name=f"{name}_b3d")
    b3 = _conv_bn(ff, b3, 192, 1, 7, 1, 1, 0, 3, name=f"{name}_b3e")
    b4 = ff.pool2d(t, 3, 3, 1, 1, 1, 1, PoolType.AVG, name=f"{name}_pool")
    b4 = _conv_bn(ff, b4, 192, 1, 1, name=f"{name}_b4")
    return ff.concat([b1, b2, b3, b4], axis=1, name=f"{name}_cat")


def _inception_d(ff, t, name):
    b1 = _conv_bn(ff, t, 192, 1, 1, name=f"{name}_b1a")
    b1 = _conv_bn(ff, b1, 320, 3, 3, 2, 2, name=f"{name}_b1b")
    b2 = _conv_bn(ff, t, 192, 1, 1, name=f"{name}_b2a")
    b2 = _conv_bn(ff, b2, 192, 1, 7, 1, 1, 0, 3, name=f"{name}_b2b")
    b2 = _conv_bn(ff, b2, 192, 7, 1, 1, 1, 3, 0, name=f"{name}_b2c")
    b2 = _conv_bn(ff, b2, 192, 3, 3, 2, 2, name=f"{name}_b2d")
    b3 = ff.pool2d(t, 3, 3, 2, 2, name=f"{name}_pool")
    return ff.concat([b1, b2, b3], axis=1, name=f"{name}_cat")


def _inception_e(ff, t, name):
    b1 = _conv_bn(ff, t, 320, 1, 1, name=f"{name}_b1")
    b2 = _conv_bn(ff, t, 384, 1, 1, name=f"{name}_b2a")
    b2x = _conv_bn(ff, b2, 384, 1, 3, 1, 1, 0, 1, name=f"{name}_b2b")
    b2y = _conv_bn(ff, b2, 384, 3, 1, 1, 1, 1, 0, name=f"{name}_b2c")
    b2 = ff.concat([b2x, b2y], axis=1, name=f"{name}_cat2")
    b3 = _conv_bn(ff, t, 448, 1, 1, name=f"{name}_b3a")
    b3 = _conv_bn(ff, b3, 384, 3, 3, 1, 1, 1, 1, name=f"{name}_b3b")
    b3x = _conv_bn(ff, b3, 384, 1, 3, 1, 1, 0, 1, name=f"{name}_b3c")
    b3y = _conv_bn(ff, b3, 384, 3, 1, 1, 1, 1, 0, name=f"{name}_b3d")
    b3 = ff.concat([b3x, b3y], axis=1, name=f"{name}_cat3")
    b4 = ff.pool2d(t, 3, 3, 1, 1, 1, 1, PoolType.AVG, name=f"{name}_pool")
    b4 = _conv_bn(ff, b4, 192, 1, 1, name=f"{name}_b4")
    return ff.concat([b1, b2, b3, b4], axis=1, name=f"{name}_cat")


def build_inception_v3(ff: FFModel, batch_size: int = None,
                       classes: int = 1000, image_size: int = 299) -> Tensor:
    b = batch_size or ff.config.batch_size
    t = ff.create_tensor((b, 3, image_size, image_size), DataType.FLOAT,
                         name="input")
    t = _conv_bn(ff, t, 32, 3, 3, 2, 2, name="stem1")
    t = _conv_bn(ff, t, 32, 3, 3, name="stem2")
    t = _conv_bn(ff, t, 64, 3, 3, 1, 1, 1, 1, name="stem3")
    t = ff.pool2d(t, 3, 3, 2, 2, name="stem_pool1")
    t = _conv_bn(ff, t, 80, 1, 1, name="stem4")
    t = _conv_bn(ff, t, 192, 3, 3, name="stem5")
    t = ff.pool2d(t, 3, 3, 2, 2, name="stem_pool2")
    t = _inception_a(ff, t, 32, "a1")
    t = _inception_a(ff, t, 64, "a2")
    t = _inception_a(ff, t, 64, "a3")
    t = _inception_b(ff, t, "b1")
    t = _inception_c(ff, t, 128, "c1")
    t = _inception_c(ff, t, 160, "c2")
    t = _inception_c(ff, t, 160, "c3")
    t = _inception_c(ff, t, 192, "c4")
    t = _inception_d(ff, t, "d1")
    t = _inception_e(ff, t, "e1")
    t = _inception_e(ff, t, "e2")
    t = ff.mean(t, axes=(2, 3), name="gap")
    t = ff.dense(t, classes, name="fc")
    return ff.softmax(t, name="softmax")
