"""BERT on synthetic token classification (examples/python/
bert_attribute_parallel.py on the port).

The reference's example splits attention heads over a mesh's model axis
(--mesh data=2,model=4 with bert_attribute_parallel_strategy). The port
does the same one process per card; without a --mesh it trains the same
BERT on one card without a strategy.

Run:  python -m flexflow_tpu_torch.examples.bert_attribute_parallel -b 8 -e 1
      torchrun --nproc-per-node 8 -m flexflow_tpu_torch \
          flexflow_tpu_torch/examples/bert_attribute_parallel.py -b 8 \
          --mesh data=2,model=4
"""

import sys

import numpy as np

from flexflow_tpu_torch import (
    AdamOptimizer, FFConfig, FFModel, LossType, MetricsType,
)
from flexflow_tpu_torch.models.bert import (
    BertConfig, bert_attribute_parallel_strategy, build_bert,
)

SEQ = 128


def main(argv=None):
    cfg = FFConfig.from_args(sys.argv[1:] if argv is None else argv)
    bcfg = BertConfig(vocab_size=1024, hidden=128, layers=2, heads=8,
                      intermediate=256, max_seq=SEQ)
    ff = FFModel(cfg)
    build_bert(ff, bcfg, batch_size=cfg.batch_size, seq_len=SEQ)
    ff.compile(
        optimizer=AdamOptimizer(lr=1e-4),
        loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
        metrics=[MetricsType.ACCURACY],
        strategy=(bert_attribute_parallel_strategy(bcfg)
                  if cfg.mesh_shape else None),
    )
    rs = np.random.RandomState(0)
    n = cfg.batch_size * 4
    x = rs.randint(0, bcfg.vocab_size, (n, SEQ)).astype(np.int32)
    y = rs.randint(0, bcfg.num_classes, n).astype(np.int32)
    return ff.fit(x, y, epochs=cfg.epochs)


if __name__ == "__main__":
    main()
