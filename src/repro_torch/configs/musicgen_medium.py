"""musicgen-medium [audio] — arXiv:2306.05284 (decoder over EnCodec tokens).

48L d_model=1536 24H (kv=24, MHA) d_ff=6144 vocab=2048, 4 codebooks.
Backbone only: the EnCodec frontend is a stub (the caller passes token
ids [.., nc] and, optionally, frame embeddings ``audio_embeds``);
sinusoidal positions, non-GLU GELU FFN per the
original transformer-decoder recipe."""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab=2048,
    act="gelu",
    glu=False,
    pos_emb="sin",
    n_codebooks=4,
    frontend="audio_stub",
)

SMOKE = dataclasses.replace(
    CONFIG, name="musicgen-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_head=16, d_ff=128, vocab=64, n_codebooks=2,
    dtype="float32", remat=False)
