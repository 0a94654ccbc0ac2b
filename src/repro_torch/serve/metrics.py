"""Serving metrics: per-request TTFT/TPOT, percentile latency, tokens/s,
the prefill-interference split of inter-token gaps, the prefix-cache
counters and the paper's Table-II off-chip traffic counters (weight bytes,
KV bytes, sparsity savings), with the block pool's and the prefix index's
gauges spliced into ``summary()``.

The port's copy of the reference's collector. The reference keeps every
scalar in an ``obs.Registry`` with a Prometheus export; here they are
plain counters (the registry and its metrics server come with the
observability slice).

Empty windows report ``None`` (explicit null), never a fake 0."""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig, ServeConfig
from repro_torch.serve import kv_cache


@dataclasses.dataclass
class StepStats:
    """One decode step's off-chip traffic (paper Table II units)."""
    weight_bytes: float
    kv_bytes: float
    sparse_savings_bytes: float
    tokens: int


def weight_traffic(cfg: ModelConfig, scfg: ServeConfig):
    """(weight_bytes, sparse_savings_bytes) streamed per decode step: the
    paper's argument that ReLU sparsity ~halves FFN weight reads and int8
    NMCE weights halve bytes/element again."""
    bpe = 1 if scfg.int8_decode else 2
    w_bytes = 0.0
    savings = 0.0
    for k in cfg.layer_kinds():
        if k not in ("attn", "shared_attn", "moe"):
            continue
        attn = 2 * cfg.d_model * (cfg.n_heads + 2 * cfg.n_kv_heads) \
            * cfg.d_head * bpe / 2
        w_bytes += attn
        if k == "moe":
            act_experts = cfg.top_k + cfg.n_shared_experts
            per_e = (3 if cfg.glu else 2) * cfg.d_model * cfg.d_ff
            dense = act_experts * per_e * bpe
        else:
            dense = (3 if cfg.glu else 2) * cfg.d_model * cfg.d_ff * bpe
        if cfg.relu_sparse and scfg.sparse_decode:
            frac = cfg.sparse_k_frac
            glu_f = 2.0 if cfg.glu else 1.0
            sparse = dense * (glu_f + frac) / (glu_f + 1)
            savings += dense - sparse
            w_bytes += sparse
        else:
            w_bytes += dense
    return w_bytes, savings


def traffic_step(cfg: ModelConfig, scfg: ServeConfig, n_tokens: int,
                 kv_bytes: Optional[float] = None) -> StepStats:
    """Traffic of one decode step serving ``n_tokens`` rows. ``kv_bytes``
    overrides the contiguous worst-case estimate (the paged cache reports
    actually-allocated bytes instead)."""
    w_bytes, savings = weight_traffic(cfg, scfg)
    if kv_bytes is None:
        kv_bytes = kv_cache.kv_bytes(cfg, n_tokens, scfg.max_seq, 2)
    return StepStats(weight_bytes=w_bytes, kv_bytes=kv_bytes,
                     sparse_savings_bytes=savings, tokens=n_tokens)


@dataclasses.dataclass
class RequestMetrics:
    rid: int
    arrival: float
    prompt_len: int = 0
    first_token_at: Optional[float] = None
    last_token_at: Optional[float] = None   # inter-token gap frontier
    finished_at: Optional[float] = None
    n_generated: int = 0
    preemptions: int = 0
    cached_prompt_tokens: int = 0   # prefix-cache hit size at admission
    # speculative decode, per request
    spec_drafted: int = 0           # draft tokens verified for this req
    spec_accepted: int = 0          # ... accepted
    spec_emitted: int = 0           # tokens committed via verify passes
    spec_verifies: int = 0          # verify passes this request rode

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.arrival

    @property
    def latency(self) -> Optional[float]:
        if self.finished_at is None:
            return None
        return self.finished_at - self.arrival

    @property
    def tpot(self) -> Optional[float]:
        """Time per output token after the first (decode cadence)."""
        if self.finished_at is None or self.first_token_at is None \
                or self.n_generated <= 1:
            return None
        return (self.finished_at - self.first_token_at) \
            / (self.n_generated - 1)

    @property
    def spec_acceptance(self) -> Optional[float]:
        """Realized per-request draft acceptance rate (None: no spec)."""
        if self.spec_drafted == 0:
            return None
        return self.spec_accepted / self.spec_drafted

    @property
    def spec_tokens_per_verify(self) -> Optional[float]:
        """Tokens committed per verify pass for this request."""
        if self.spec_verifies == 0:
            return None
        return self.spec_emitted / self.spec_verifies


def percentile(values: List[float], p: float) -> Optional[float]:
    """Percentile of a sample, ``None`` for an empty one; a single sample
    reports itself exactly for every p."""
    if not values:
        return None
    if len(values) == 1:
        return float(values[0])
    return float(np.percentile(np.asarray(values), p))


def _ms(v: Optional[float]) -> Optional[float]:
    return None if v is None else v * 1e3


class MetricsCollector:
    """Accumulates per-request and per-step serving metrics. ``pool`` and
    ``prefix`` (set by the paged engine) splice their ``stats()`` into
    ``summary()``."""

    def __init__(self, cfg: ModelConfig, scfg: ServeConfig,
                 clock=time.monotonic):
        self.cfg = cfg
        self.scfg = scfg
        self.clock = clock
        self.requests: Dict[int, RequestMetrics] = {}
        self.step_stats: List[StepStats] = []
        self.decode_steps = 0
        self.prefill_chunks = 0
        self.prefill_tokens = 0      # prompt tokens run through the model
        self.evictions = 0
        self.prefix_lookups = 0
        self.prefix_hits = 0
        self.prefix_cached_tokens = 0
        self.spec_steps = 0          # verify passes
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.spec_emitted = 0
        self.weight_bytes = 0.0
        self.kv_bytes = 0.0
        self.sparse_savings_bytes = 0.0
        # every inter-token gap, split by whether a prefill ran in the same
        # tick (the prefill-interference split)
        self._tpot_overlap: List[float] = []
        self._tpot_steady: List[float] = []
        self.pool = None             # PagedKVCache (paged engine)
        self.prefix = None           # RadixPrefixCache (prefix_cache)
        self._t0: Optional[float] = None

    # --- request lifecycle events ---
    def on_arrival(self, rid: int, prompt_len: int) -> None:
        at = self.clock()
        if self._t0 is None:
            self._t0 = at
        self.requests[rid] = RequestMetrics(rid=rid, arrival=at,
                                            prompt_len=prompt_len)

    def on_first_token(self, rid: int) -> None:
        r = self.requests[rid]
        now = self.clock()
        if r.first_token_at is None:
            r.first_token_at = now
        r.last_token_at = now
        r.n_generated += 1

    def on_token(self, rid: int, prefill_overlap: bool = False) -> None:
        """One committed decode token; ``prefill_overlap`` says whether a
        prefill ran in the tick that produced it."""
        r = self.requests[rid]
        now = self.clock()
        prev = r.last_token_at if r.last_token_at is not None \
            else r.first_token_at
        if prev is not None:
            (self._tpot_overlap if prefill_overlap
             else self._tpot_steady).append(now - prev)
        r.last_token_at = now
        r.n_generated += 1

    def on_finish(self, rid: int) -> None:
        self.requests[rid].finished_at = self.clock()

    def on_preemption(self, rid: int) -> None:
        self.requests[rid].preemptions += 1
        self.evictions += 1

    def on_prefix_lookup(self, rid: int, cached_tokens: int) -> None:
        """One admission-time radix lookup; ``cached_tokens`` is the
        matched block-aligned prefix length (0 = miss)."""
        self.prefix_lookups += 1
        if cached_tokens > 0:
            self.prefix_hits += 1
            self.prefix_cached_tokens += cached_tokens
        r = self.requests.get(rid)
        if r is not None:
            r.cached_prompt_tokens = max(r.cached_prompt_tokens,
                                         cached_tokens)

    # --- step events ---
    def on_decode_step(self, n_tokens: int,
                       kv_bytes: Optional[float] = None) -> None:
        self.decode_steps += 1
        self._traffic(traffic_step(self.cfg, self.scfg, n_tokens,
                                   kv_bytes=kv_bytes))

    def on_spec_step(self, n_rows: int, drafted: int, accepted: int,
                     emitted: int, kv_bytes: Optional[float] = None,
                     draft_weight_bytes: float = 0.0) -> None:
        """One draft->verify pass: ``emitted`` tokens committed for one
        read of the target's weight stream. ``draft_weight_bytes`` adds
        the drafter's own weight stream (0 for n-gram) to the totals."""
        self.spec_steps += 1
        self.spec_drafted += drafted
        self.spec_accepted += accepted
        self.spec_emitted += emitted
        stats = traffic_step(self.cfg, self.scfg, emitted,
                             kv_bytes=kv_bytes)
        stats.weight_bytes += draft_weight_bytes
        self._traffic(stats)

    def on_spec_request(self, rid: int, drafted: int, accepted: int,
                        emitted: int) -> None:
        """One request's share of a verify pass; ``emitted`` counts the
        tokens that landed in tokens_out."""
        r = self.requests.get(rid)
        if r is None:
            return
        r.spec_drafted += drafted
        r.spec_accepted += accepted
        r.spec_emitted += emitted
        r.spec_verifies += 1

    def _traffic(self, stats: StepStats) -> None:
        self.step_stats.append(stats)
        self.weight_bytes += stats.weight_bytes
        self.kv_bytes += stats.kv_bytes
        self.sparse_savings_bytes += stats.sparse_savings_bytes

    def on_prefill_chunk(self, n_tokens: int) -> None:
        self.prefill_chunks += 1
        self.prefill_tokens += n_tokens

    # --- summary ---
    def summary(self) -> dict:
        """The reference's summary keys, less the tracer's (``ticks``,
        ``phase_ms_per_tick``, ``bucket_attainment``)."""
        done = [r for r in self.requests.values()
                if r.finished_at is not None]
        ttfts = [r.ttft for r in done if r.ttft is not None]
        lats = [r.latency for r in done]
        tpots = [r.tpot for r in done if r.tpot is not None]
        n_tok = sum(r.n_generated for r in done)
        wall = (max(r.finished_at for r in done) - self._t0) \
            if done and self._t0 is not None else None
        ttft_hit = [r.ttft for r in done
                    if r.ttft is not None and r.cached_prompt_tokens > 0]
        ttft_miss = [r.ttft for r in done
                     if r.ttft is not None and r.cached_prompt_tokens == 0]
        spec_req = {
            r.rid: {"acceptance": r.spec_acceptance,
                    "tokens_per_verify": r.spec_tokens_per_verify,
                    "drafted": r.spec_drafted,
                    "emitted": r.spec_emitted}
            for r in done if r.spec_verifies > 0}
        return {
            "n_finished": len(done),
            "generated_tokens": n_tok,
            "tokens_per_s": (n_tok / wall) if wall else None,
            "ttft_p50_ms": _ms(percentile(ttfts, 50)),
            "ttft_p99_ms": _ms(percentile(ttfts, 99)),
            "latency_p50_ms": _ms(percentile(lats, 50)),
            "latency_p99_ms": _ms(percentile(lats, 99)),
            "tpot_p50_ms": _ms(percentile(tpots, 50)),
            "tpot_p99_ms": _ms(percentile(tpots, 99)),
            "tpot_p50_prefill_overlap_ms":
                _ms(percentile(self._tpot_overlap, 50)),
            "tpot_p99_prefill_overlap_ms":
                _ms(percentile(self._tpot_overlap, 99)),
            "tpot_p50_steady_ms": _ms(percentile(self._tpot_steady, 50)),
            "tpot_p99_steady_ms": _ms(percentile(self._tpot_steady, 99)),
            "tpot_overlap_samples": len(self._tpot_overlap),
            "tpot_steady_samples": len(self._tpot_steady),
            "decode_steps": self.decode_steps,
            "prefill_chunks": self.prefill_chunks,
            "evictions": self.evictions,
            "spec_steps": self.spec_steps,
            "spec_acceptance_rate": (self.spec_accepted
                                     / max(self.spec_drafted, 1)),
            "spec_tokens_per_verify": (self.spec_emitted
                                       / max(self.spec_steps, 1)),
            "spec_per_request": spec_req,
            "weight_bytes": self.weight_bytes,
            "kv_bytes": self.kv_bytes,
            "sparse_savings_bytes": self.sparse_savings_bytes,
            "prefix_lookups": self.prefix_lookups,
            "prefix_hits": self.prefix_hits,
            "prefix_hit_rate": (self.prefix_hits
                                / max(self.prefix_lookups, 1)),
            "prefix_cached_tokens": self.prefix_cached_tokens,
            "ttft_hit_p50_ms": _ms(percentile(ttft_hit, 50)),
            "ttft_miss_p50_ms": _ms(percentile(ttft_miss, 50)),
            "kv_pool": self.pool.stats() if self.pool is not None else {},
            "prefix_index": (self.prefix.stats()
                             if self.prefix is not None else {}),
            # sharded serving is a later slice: one device, no mesh
            "mesh": {},
        }
