"""Seq2seq NMT training (examples/python/nmt_seq2seq.py on the port):
stacked-LSTM encoder and decoder, a vocabulary projection, on a synthetic
copy-with-offset translation task.

The reference's example shards the batch over a mesh (nmt_dp_strategy
under --mesh data=2,model=4). The port does the same one process per
card; without a --mesh it trains on one card without a strategy.

Run:  python -m flexflow_tpu_torch.examples.nmt_seq2seq -b 32 -e 3
      torchrun --nproc-per-node 8 -m flexflow_tpu_torch \
          flexflow_tpu_torch/examples/nmt_seq2seq.py -b 32 \
          --mesh data=2,model=4
"""

import sys

import numpy as np

from flexflow_tpu_torch import (
    AdamOptimizer, FFConfig, FFModel, LossType, MetricsType,
)
from flexflow_tpu_torch.models.nmt import NMTConfig, build_nmt, nmt_dp_strategy

SRC_LEN, TGT_LEN = 16, 16


def synthetic_pairs(cfg: NMTConfig, n=2048, seed=0):
    """"Translation": each source token maps to (token*3+1) mod
    tgt_vocab; teacher forcing feeds the shifted target."""
    rs = np.random.RandomState(seed)
    src = rs.randint(1, cfg.src_vocab, (n, SRC_LEN)).astype(np.int32)
    tgt = ((src[:, :TGT_LEN] * 3 + 1) % cfg.tgt_vocab).astype(np.int32)
    dec_in = np.concatenate([np.zeros((n, 1), np.int32), tgt[:, :-1]],
                            axis=1)
    return src, dec_in, tgt


def main(argv=None):
    ffcfg = FFConfig.from_args(sys.argv[1:] if argv is None else argv)
    cfg = NMTConfig(src_vocab=512, tgt_vocab=512, embed_dim=128, hidden=192,
                    layers=2)
    ff = FFModel(ffcfg)
    build_nmt(ff, cfg, src_len=SRC_LEN, tgt_len=TGT_LEN)
    ff.compile(
        optimizer=AdamOptimizer(lr=3e-3),
        loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
        metrics=[MetricsType.ACCURACY,
                 MetricsType.SPARSE_CATEGORICAL_CROSSENTROPY],
        strategy=nmt_dp_strategy(cfg) if ffcfg.mesh_shape else None,
    )
    src, dec_in, tgt = synthetic_pairs(cfg, n=ffcfg.batch_size * 8)
    ff.fit([src, dec_in], tgt, epochs=ffcfg.epochs)
    return ff.eval([src, dec_in], tgt)


if __name__ == "__main__":
    main()
