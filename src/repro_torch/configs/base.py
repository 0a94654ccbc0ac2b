"""Config dataclasses: the port's own copy of ``repro.configs.base``.

``ModelConfig`` and ``ServeConfig`` keep the reference's fields and
defaults so one set of values configures both packages. ``SpecConfig``,
``ObsConfig``, ``MeshConfig`` and ``AsyncConfig`` are here only so that a
``ServeConfig`` constructs as it does in the reference; the port's engine
raises ``NotImplementedError`` when any of them is switched on.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | vlm | hybrid | audio | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    d_head: int = 0                 # 0 -> d_model // n_heads
    act: str = "silu"
    glu: bool = True
    qk_norm: bool = False
    qkv_bias: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    mrope: bool = False
    pos_emb: str = "rope"           # rope | sin | none

    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25

    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    block_pattern: Tuple[str, ...] = ()
    slstm_every: int = 0

    n_codebooks: int = 0
    frontend: str = "none"

    # --- the paper's technique ---
    relu_sparse: bool = False       # ReLU-fied FFN + sparse decode path
    sparse_k_frac: float = 0.125    # active fraction for top-k gather
    int8_weights: bool = False
    predictor_rank: int = 0

    dtype: str = "bfloat16"
    remat: bool = True
    block_causal: bool = False
    unroll: bool = False

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)
        if self.n_heads % max(self.n_kv_heads, 1) != 0:
            raise ValueError(
                f"{self.name}: n_heads must be a multiple of n_kv_heads")

    def pattern_unit(self) -> Tuple[str, ...]:
        """The repeating block pattern; the stack loops over
        n_layers/len(unit) copies of this unit."""
        if self.block_pattern:
            return self.block_pattern
        if self.family == "moe":
            return ("moe",)
        if self.family == "ssm":
            if self.slstm_every:
                return ("mlstm",) * (self.slstm_every - 1) + ("slstm",)
            return ("mlstm",)
        return ("attn",)

    @property
    def n_units(self) -> int:
        unit = self.pattern_unit()
        if self.n_layers % len(unit):
            raise ValueError(
                f"{self.name}: n_layers {self.n_layers} % unit {len(unit)}")
        return self.n_layers // len(unit)


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Speculative decoding (a later slice): its fields come with it."""


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    enabled: bool = False
    profile: bool = False


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    model: int = 1
    data: int = 1

    @property
    def n_devices(self) -> int:
        return self.model * self.data


@dataclasses.dataclass(frozen=True)
class AsyncConfig:
    enabled: bool = False


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_batch: int = 8
    max_seq: int = 2048
    sparse_decode: bool = True      # use the NeCTAr sparse FFN path
    int8_decode: bool = True        # NMCE int8 weight streaming
    kv_quant: bool = False          # int8 KV cache

    paged: bool = False             # block-table paged KV decode
    prefix_cache: bool = False
    block_size: int = 16            # tokens per KV block
    n_kv_blocks: int = 0            # KV pool size; 0 = max_batch*max_seq/bs
    prefill_chunk: int = 32         # chunked-prefill tokens per tick
    policy: str = "fifo"            # request ordering: fifo | priority
    max_queue: int = 256            # admission control: queue depth bound
    spec: Optional[SpecConfig] = None
    # attention read path: "naive" = gather through the block tables in
    # plain PyTorch; "flash" = the CUDA paged-attention kernel reading the
    # block pools directly
    attn_backend: str = "naive"
    mesh: Optional[MeshConfig] = None
    obs: ObsConfig = dataclasses.field(default_factory=ObsConfig)
    async_cfg: Optional[AsyncConfig] = None

    @property
    def blocks_per_seq(self) -> int:
        return -(-self.max_seq // self.block_size)

    @property
    def pool_blocks(self) -> int:
        return self.n_kv_blocks or self.max_batch * self.blocks_per_seq
