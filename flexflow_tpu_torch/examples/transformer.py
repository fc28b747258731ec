"""Transformer encoder training (examples/python/transformer.py on the
port): an attention encoder stack and a regression head, MSE on
synthetic data; --enc-dec trains the encoder-decoder with
cross-attention.

Run:  python -m flexflow_tpu_torch.examples.transformer -b 8 -e 2 [--enc-dec]
"""

import sys

import numpy as np

from flexflow_tpu_torch import (
    AdamOptimizer, FFConfig, FFModel, LossType, MetricsType,
)
from flexflow_tpu_torch.models.transformer import (
    TransformerConfig,
    build_transformer_encoder,
    build_transformer_encoder_decoder,
)

SEQ = 32


def main(argv=None):
    args = list(sys.argv[1:] if argv is None else argv)
    enc_dec = "--enc-dec" in args
    if enc_dec:
        args.remove("--enc-dec")
    ffcfg = FFConfig.from_args(args)
    cfg = TransformerConfig(dim=64, heads=8, hidden=256, layers=4)
    ff = FFModel(ffcfg)
    if enc_dec:
        build_transformer_encoder_decoder(ff, cfg, src_len=SEQ,
                                          tgt_len=SEQ // 2)
    else:
        build_transformer_encoder(ff, cfg, seq_len=SEQ)
    ff.compile(optimizer=AdamOptimizer(lr=1e-3),
               loss_type=LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
               metrics=[MetricsType.MEAN_SQUARED_ERROR])
    rs = np.random.RandomState(0)
    n = ffcfg.batch_size * 8
    if enc_dec:
        src = rs.randn(n, SEQ, cfg.dim).astype(np.float32)
        tgt = rs.randn(n, SEQ // 2, cfg.dim).astype(np.float32)
        y = tgt.mean(-1, keepdims=True).astype(np.float32)
        return ff.fit([src, tgt], y, epochs=ffcfg.epochs)
    x = rs.randn(n, SEQ, cfg.dim).astype(np.float32)
    y = x.mean(-1, keepdims=True).astype(np.float32)
    return ff.fit(x, y, epochs=ffcfg.epochs)


if __name__ == "__main__":
    main()
