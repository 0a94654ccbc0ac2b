"""Config dataclasses: the port's own copy of ``repro.configs.base``.

``ModelConfig``, ``TrainConfig``, ``ServeConfig`` and ``SpecConfig`` keep
the reference's fields and defaults so one set of values configures both
packages.
``ObsConfig``, ``MeshConfig`` and ``AsyncConfig`` configure tracing,
sharded serving and the async engine, as in the reference. ``SHAPES`` and
``applicable_shapes`` are the assigned input shapes the dry run and the
roofline cover.
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
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode: SSM and hybrid archs run long_500k."""
        return self.family in ("ssm", "hybrid")

    @property
    def n_units(self) -> int:
        unit = self.pattern_unit()
        if self.n_layers % len(unit):
            raise ValueError(
                f"{self.name}: n_layers {self.n_layers} % unit {len(unit)}")
        return self.n_layers // len(unit)

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kind, resolved from the pattern/family."""
        pat = self.pattern_unit()
        return tuple(pat[i % len(pat)] for i in range(self.n_layers))

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + norms), the
        reference's formula: the shared attention block counts once."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        n_q = self.n_heads * self.d_head
        n_kv = self.n_kv_heads * self.d_head
        emb = v * d * (1 + self.n_codebooks if self.n_codebooks else 1)
        head = 0 if self.tie_embeddings else v * d * (self.n_codebooks or 1)
        total = emb + head + d  # final norm
        for blk in self.layer_kinds():
            if blk in ("attn", "shared_attn"):
                total += n_q * d + 2 * n_kv * d + n_q * d + d  # qkvo + norm
                if blk == "attn":
                    total += self._ffn_params() + d
            elif blk == "mamba2":
                di = self.ssm_expand * d
                heads = self.ssm_heads or di // 64
                total += d * (2 * di + 2 * self.ssm_state + heads)  # in_proj
                total += di * self.ssm_conv + di * d + 2 * heads + di + d
            elif blk in ("mlstm", "slstm"):
                di = 2 * d
                total += d * 2 * di + di * d + 4 * di * 2 + d  # projs + gates
            elif blk == "moe":
                total += n_q * d + 2 * n_kv * d + n_q * d + d
                total += d * self.n_experts  # router
                e_f = (2 if self.glu else 1) * d * f + f * d
                total += self.n_experts * e_f + self.n_shared_experts * e_f + d
        n_shared = sum(1 for b in self.layer_kinds() if b == "shared_attn")
        if n_shared > 1:
            total -= (n_shared - 1) * (n_q * d + 2 * n_kv * d + n_q * d + d)
        return int(total)

    def _ffn_params(self) -> int:
        return (2 if self.glu else 1) * self.d_model * self.d_ff \
            + self.d_ff * self.d_model


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    microbatch: int = 0             # 0 = no accumulation
    adam_8bit: bool = False         # int8 moments (blockwise scales)
    grad_compression: str = "none"  # none | int8_ef (cross-pod)
    checkpoint_every: int = 200
    keep_checkpoints: int = 3
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Speculative decoding (repro_torch.spec): draft K tokens cheaply,
    verify them in ONE batched forward pass of the target model, so one
    read of its weight stream serves up to K+1 emitted tokens."""

    drafter: str = "ngram"          # ngram | model | selfspec
    k: int = 4                      # initial draft length per verify step
    k_min: int = 1                  # adaptive-K floor
    k_max: int = 8                  # adaptive-K ceiling (fixed verify shape)
    adaptive: bool = True           # back off K when acceptance drops
    accept_low: float = 0.4         # EMA acceptance below this shrinks K
    accept_high: float = 0.7        # EMA acceptance above this grows K
    ema_decay: float = 0.9          # acceptance-rate EMA decay
    temperature: float = 0.0        # 0 = greedy accept; >0 rejection sampling
    ngram: int = 3                  # prompt-lookup: longest suffix match
    draft_name: str = ""            # registry config for drafter="model"
    draft_frac: float = 0.0625      # selfspec: sparse active fraction
    predictor_rank: int = 16        # selfspec: Deja-Vu predictor rank
    seed: int = 0                   # acceptance/draft sampling RNG


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """Tracing and telemetry (repro_torch.obs).

    Always on: the engine's phase totals (``obs.trace.CountingTracer``),
    seconds by phase (front_end, tick, schedule, admit, draft,
    batch_assemble, device_dispatch, graph_dispatch, sample_sync,
    device_wait, postprocess, kv_handoff) from one clock read at each
    phase boundary: no span object, no event, no CUDA event, no wait.
    ``metrics.summary()`` and the registry show them
    (``engine_phase_seconds_total{phase=...}``) beside each request's
    queue wait; every time in ``obs`` and ``serve.metrics`` is on
    ``time.perf_counter_ns``. With ``enabled=True`` the engine also
    records per-tick phase spans with each tick's device time (CUDA
    timing events on the card, read once the tick's own waits have passed
    them: tracing adds no wait), per-row-kind and padding figures, and
    per-request lifecycle events. ``profile`` adds roofline attainment per
    width bucket (``obs.profile``)."""

    enabled: bool = False
    profile: bool = False           # roofline attainment per width bucket;
    #                                 implies enabled (it reads the ticks'
    #                                 device time)
    tick_spans: bool = True         # per-tick phase spans
    timeline: bool = True           # per-request lifecycle events
    torch_annotations: bool = False  # also open a torch.profiler
    #                                 record_function range per span
    max_events: int = 262_144       # storage bound: spans and events
    #                                 past it are counted (dropped), not kept


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device mesh for sharded serving (paged engine only).

    ``model`` is the tensor-parallel axis: transformer weights shard over
    it (dist.sharding.params_shardings) and the paged KV block pool
    partitions its KV-head axis over it (dist.sharding.cache_shardings
    with paged=True) — each shard holds n_kv_heads/model heads of every
    physical block, so the pool's host-side bookkeeping (block tables,
    refcounts, COW, truncate, defrag, the radix prefix index) is
    completely shard-agnostic.

    ``shard_kv_seq`` additionally shards the gathered per-row KV
    *sequence* over ``model`` inside single-token decode attention and
    merges the per-shard partial softmaxes with the LSE-combine
    collective (dist.collectives.lse_combine_decode_attention) — the
    long-context layout where one device cannot hold a row's KV.

    ``data`` > 1 is reserved for batch-parallel replicas and is rejected
    by the engine until the runner actually batch-shards step inputs —
    accepting it today would silently replicate identical work across
    the extra devices.

    Declarative and torch-free: the engine materializes the actual mesh
    via launch.mesh.make_serving_mesh, so configs can be built before any
    device is chosen."""

    model: int = 1                  # tensor-parallel shards
    data: int = 1                   # batch-parallel replicas (reserved)
    shard_kv_seq: bool = False      # LSE-combine decode over seq shards

    @property
    def n_devices(self) -> int:
        return self.model * self.data


@dataclasses.dataclass(frozen=True)
class AsyncConfig:
    """Asynchronous engine ticks (serve.engine, paged mode only).

    With ``enabled=True`` the engine runs a pure-decode tick without the
    synchronous round trip, two ways:

      * overlap ticks: tick t's decode step and its on-device sample are
        dispatched without waiting; tick t-1's tokens are committed while
        t runs, and t+1's input token chains on t's on the device;
      * device-resident decode bursts: up to ``max_device_ticks`` decode
        steps chained on the device, one host wait per burst (on CUDA a
        captured graph of one decode iteration, replayed per step).

    The host replays every emitted token through the synchronous commit
    path, so greedy and seeded sampled output stay token-identical to the
    synchronous engine. Ticks that need host policy (prefill, admission,
    speculation, eviction pressure, the repetition penalty) run
    synchronously."""

    enabled: bool = False
    max_device_ticks: int = 8       # K: decode ticks per device burst (>=1)
    sync_every: int = 0             # force a synchronous tick every N engine
    #                                 ticks (0 = only when the engine needs
    #                                 one); bounds streaming staleness


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


@dataclasses.dataclass(frozen=True)
class DisaggConfig:
    """Disaggregated prefill/decode serving (serve.disagg).

    Prefill is compute-bound and decode weight-bandwidth-bound (the
    paper's near-core vs near-memory split), so the DisaggCoordinator
    runs each phase on its own Engine and hands finished prefills over as
    a paged-KV block copy. These knobs size the PREFILL engine against
    the decode engine's ServeConfig, which keeps the user's values:

    ``prefill_batch`` / ``prefill_blocks``: the prefill engine's
    max_batch and KV pool size (0 = the decode ServeConfig's). A request
    holds a prefill slot only until its handoff, so a small batch and a
    pool of a few prompts usually suffice.

    ``direct_max_suffix``: the multi-turn fast path. When the DECODE
    engine's radix index already covers a prompt up to its last
    ``<= direct_max_suffix`` tokens, the request goes straight to the
    decode engine instead of through a prefill and a handoff. 0 turns it
    off."""

    prefill_batch: int = 0          # prefill engine max_batch (0=inherit)
    prefill_blocks: int = 0         # prefill engine KV pool (0=inherit)
    direct_max_suffix: int = 0      # decode-direct if cached suffix <= this


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Multi-replica serving fleet (serve.fleet + serve.router).

    One ServeConfig builds every replica (a homogeneous fleet); this adds
    the fleet's knobs: the replica count, the routing policy, the
    router's own bounded overflow queue (requests wait there when every
    replica's admission is full and are shed with FleetSaturated past the
    bound) and session stickiness. Needs ``ServeConfig.paged``: routing
    reads the paged scheduler's queue depth and the radix prefix index."""

    replicas: int = 1
    router_policy: str = "affinity"   # affinity | round_robin | least_loaded
    max_router_queue: int = 512       # bounded front-door overflow queue
    session_affinity: bool = True     # same session id -> same replica
    parallel_poll: bool = False       # tick replicas from a thread pool
    #                                   (serialized polling is the default:
    #                                   replicas on one card share its
    #                                   stream and the host's one thread)


# --- assigned input shapes (seq_len, global_batch, kind) -------------------

SHAPES = {
    "train_4k": dict(seq=4096, batch=256, kind="train"),
    "prefill_32k": dict(seq=32768, batch=32, kind="prefill"),
    "decode_32k": dict(seq=32768, batch=128, kind="decode"),
    "long_500k": dict(seq=524288, batch=1, kind="decode"),
}


def applicable_shapes(cfg: ModelConfig) -> Tuple[str, ...]:
    """long_500k only for sub-quadratic archs (assignment rule)."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.supports_long_context:
        names.append("long_500k")
    return tuple(names)
