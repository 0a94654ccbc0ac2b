"""xlstm-125m [ssm] — arXiv:2405.04517 (sLSTM + mLSTM blocks).

12L d_model=768 4H vocab=50304, d_ff=0 (blocks carry their own up/down
projections). Block ratio ~5:1 mLSTM:sLSTM (every 6th block is sLSTM).
Runs long_500k: decode state is O(1).

Arch-applicability note (DESIGN.md §5): no FFN exists, so the ReLU-sparse
FFN path is inapplicable; the NMCE int8 GEMV path still covers every
projection."""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    glu=False,
    pos_emb="none",
    slstm_every=6,
    tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    CONFIG, name="xlstm-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_head=16, vocab=256, slstm_every=2, dtype="float32",
    remat=False)
