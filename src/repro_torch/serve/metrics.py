"""Serving metrics: per-request TTFT/TPOT, percentile latency, tokens/s,
the prefill-interference split of inter-token gaps, the prefix-cache
counters and the paper's Table-II off-chip traffic counters (weight bytes,
KV bytes, sparsity savings).

The port's copy of the reference's collector. Every number lives in ONE
``obs.Registry``: the event hooks increment registry counters (the legacy
attribute names, ``decode_steps``, ``evictions``, ``spec_steps``, ..., are
read-only properties over them), the block pool's, the prefix index's and
the roofline profiler's stats are spliced in as pull-style gauge groups,
and ``summary()``, the Prometheus text endpoint and the Perfetto trace
metadata all read the same registry. With tracing on, ``summary()`` adds
the tracer's ``ticks`` and ``phase_ms_per_tick`` and, with profiling, the
per-bucket ``bucket_attainment``.

``fleet_summary`` aggregates several collectors (fleet replicas, or a
disagg pool's merged view) into one fleet view.

Empty windows report ``None`` (explicit null), never a fake 0."""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig, ServeConfig
from repro_torch.obs.registry import Registry
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
    """Accumulates per-request and per-step serving metrics. Every scalar
    lives in ``self.registry``; the legacy attribute names are read-only
    properties over its counters. ``pool``, ``prefix`` and ``profiler``
    (set by the paged engine) splice their stats into the registry and
    ``summary()``; ``tracer`` (set by the engine) adds its per-tick
    aggregates when it records."""

    def __init__(self, cfg: ModelConfig, scfg: ServeConfig,
                 clock=time.monotonic):
        self.cfg = cfg
        self.scfg = scfg
        self.clock = clock
        self.requests: Dict[int, RequestMetrics] = {}
        self.step_stats: List[StepStats] = []
        self.registry = Registry()
        r = self.registry
        self._c_decode = r.counter("engine_decode_steps_total",
                                   "non-speculative decode ticks")
        self._c_chunks = r.counter("engine_prefill_chunks_total",
                                   "chunked-prefill rows processed")
        self._c_prefill_tok = r.counter("engine_prefill_tokens_total",
                                        "prompt tokens prefilled")
        self._c_evict = r.counter("sched_preemptions_total",
                                  "preemption-by-recompute evictions")
        self._c_arrive = r.counter("request_arrivals_total")
        self._c_finish = r.counter("request_finished_total")
        self._c_tokens = r.counter("request_generated_tokens_total",
                                   "committed output tokens")
        self._h_ttft = r.histogram("request_ttft_seconds",
                                   "time to first token")
        self._h_lat = r.histogram("request_latency_seconds",
                                  "arrival to finish")
        self._h_tpot = r.histogram("request_tpot_seconds",
                                   "decode cadence after first token")
        # the prefill-interference split: every inter-token gap, by whether
        # a prefill ran in the tick that produced it; the raw samples back
        # the exact percentiles of summary(), the histograms Prometheus
        self._h_tpot_ov = r.histogram(
            "request_tpot_prefill_overlap_seconds",
            "inter-token gaps with a concurrent prefill in flight")
        self._h_tpot_st = r.histogram(
            "request_tpot_steady_seconds",
            "inter-token gaps with no prefill in flight")
        self._tpot_overlap: List[float] = []
        self._tpot_steady: List[float] = []
        # prefix cache
        self._c_plook = r.counter("prefix_lookups_total",
                                  "admissions that consulted the index")
        self._c_phit = r.counter("prefix_hits_total",
                                 "... that matched >= 1 block")
        self._c_ptok = r.counter("prefix_cached_tokens_total",
                                 "prompt tokens served from cache")
        # speculative decoding
        self._c_sstep = r.counter("spec_verify_steps_total",
                                  "draft->verify passes")
        self._c_sdraft = r.counter("spec_drafted_tokens_total")
        self._c_saccept = r.counter("spec_accepted_tokens_total")
        self._c_semit = r.counter("spec_emitted_tokens_total",
                                  "tokens committed via verify passes")
        self._h_saccept = r.histogram(
            "spec_request_acceptance_ratio",
            "per-request realized draft acceptance",
            buckets=tuple(i / 10 for i in range(11)))
        self._h_stpv = r.histogram(
            "spec_request_tokens_per_verify",
            "per-request realized tokens committed per verify pass",
            buckets=tuple(float(i) for i in range(1, 17)))
        # the paper's Table-II off-chip traffic
        self._c_wbytes = r.counter("traffic_weight_bytes_total")
        self._c_kvbytes = r.counter("traffic_kv_bytes_total")
        self._c_savings = r.counter("traffic_sparse_savings_bytes_total")
        self._pool = None            # PagedKVCache (paged engine)
        self._prefix = None          # RadixPrefixCache (prefix_cache)
        self._mesh: dict = {}        # sharded serving: launch.mesh info
        self._profiler = None        # obs.ServingProfiler (obs.profile)
        self.tracer = None           # obs.Tracer, set by the engine
        self._t0: Optional[float] = None

    @property
    def window_start(self) -> Optional[float]:
        """First arrival of the measurement window (None before any). The
        fleet's aggregate needs the earliest start across collectors for
        one shared wall clock: per-replica walls do not add."""
        return self._t0

    # --- registry-backed live gauges -------------------------------------
    @property
    def pool(self):
        return self._pool

    @pool.setter
    def pool(self, pool) -> None:
        self._pool = pool
        if pool is not None:
            self.registry.gauge_group("pool", pool.stats)

    @property
    def prefix(self):
        return self._prefix

    @prefix.setter
    def prefix(self, prefix) -> None:
        self._prefix = prefix
        if prefix is not None:
            self.registry.gauge_group("prefix_index", prefix.stats)

    @property
    def mesh(self) -> dict:
        return self._mesh

    @mesh.setter
    def mesh(self, info: dict) -> None:
        """Sharded serving's ``launch.mesh.mesh_info`` plus
        ``kv_pool_shards`` and ``shard_kv_seq`` (the engine's); a
        non-empty one joins the registry as the "mesh" gauge group."""
        self._mesh = info
        if info:
            self.registry.gauge_group("mesh", lambda: self._mesh)

    @property
    def profiler(self):
        return self._profiler

    @profiler.setter
    def profiler(self, profiler) -> None:
        """The roofline profiler's per-bucket attainment, as
        ``bucket_attainment_<metric>{bucket="..."}`` labeled gauges
        (re-pulled from the live tracer at every scrape) and as the
        ``bucket_attainment`` summary group."""
        self._profiler = profiler
        if profiler is not None:
            self.registry.labeled_gauge_group(
                "bucket_attainment", "bucket", profiler.gauges)

    # --- legacy attribute names over registry counters --------------------
    @property
    def decode_steps(self) -> int:
        return self._c_decode.value

    @property
    def prefill_chunks(self) -> int:
        return self._c_chunks.value

    @property
    def prefill_tokens(self) -> int:
        return self._c_prefill_tok.value

    @property
    def evictions(self) -> int:
        return self._c_evict.value

    @property
    def prefix_lookups(self) -> int:
        return self._c_plook.value

    @property
    def prefix_hits(self) -> int:
        return self._c_phit.value

    @property
    def prefix_cached_tokens(self) -> int:
        return self._c_ptok.value

    @property
    def spec_steps(self) -> int:
        return self._c_sstep.value

    @property
    def spec_drafted(self) -> int:
        return self._c_sdraft.value

    @property
    def spec_accepted(self) -> int:
        return self._c_saccept.value

    @property
    def spec_emitted(self) -> int:
        return self._c_semit.value

    @property
    def weight_bytes(self) -> float:
        return self._c_wbytes.value

    @property
    def kv_bytes(self) -> float:
        return self._c_kvbytes.value

    @property
    def sparse_savings_bytes(self) -> float:
        return self._c_savings.value

    # --- request lifecycle events ---
    def on_arrival(self, rid: int, prompt_len: int) -> None:
        at = self.clock()
        if self._t0 is None:
            self._t0 = at
        self._c_arrive.inc()
        self.requests[rid] = RequestMetrics(rid=rid, arrival=at,
                                            prompt_len=prompt_len)

    def on_first_token(self, rid: int) -> None:
        r = self.requests[rid]
        now = self.clock()
        if r.first_token_at is None:
            r.first_token_at = now
        r.last_token_at = now
        r.n_generated += 1
        self._c_tokens.inc()

    def on_token(self, rid: int, prefill_overlap: bool = False) -> None:
        """One committed decode token; ``prefill_overlap`` says whether a
        prefill ran in the tick that produced it."""
        r = self.requests[rid]
        now = self.clock()
        prev = r.last_token_at if r.last_token_at is not None \
            else r.first_token_at
        if prev is not None:
            gap = now - prev
            if prefill_overlap:
                self._tpot_overlap.append(gap)
                self._h_tpot_ov.observe(gap)
            else:
                self._tpot_steady.append(gap)
                self._h_tpot_st.observe(gap)
        r.last_token_at = now
        r.n_generated += 1
        self._c_tokens.inc()

    def on_finish(self, rid: int) -> None:
        r = self.requests[rid]
        r.finished_at = self.clock()
        self._c_finish.inc()
        for hist, v in ((self._h_ttft, r.ttft), (self._h_lat, r.latency),
                        (self._h_tpot, r.tpot),
                        (self._h_saccept, r.spec_acceptance),
                        (self._h_stpv, r.spec_tokens_per_verify)):
            if v is not None:
                hist.observe(v)

    def on_preemption(self, rid: int) -> None:
        self.requests[rid].preemptions += 1
        self._c_evict.inc()

    def on_prefix_lookup(self, rid: int, cached_tokens: int) -> None:
        """One admission-time radix lookup; ``cached_tokens`` is the
        matched block-aligned prefix length (0 = miss)."""
        self._c_plook.inc()
        if cached_tokens > 0:
            self._c_phit.inc()
            self._c_ptok.inc(cached_tokens)
        r = self.requests.get(rid)
        if r is not None:
            r.cached_prompt_tokens = max(r.cached_prompt_tokens,
                                         cached_tokens)

    # --- step events ---
    def on_decode_step(self, n_tokens: int,
                       kv_bytes: Optional[float] = None) -> None:
        self._c_decode.inc()
        self._traffic(traffic_step(self.cfg, self.scfg, n_tokens,
                                   kv_bytes=kv_bytes))

    def on_spec_step(self, n_rows: int, drafted: int, accepted: int,
                     emitted: int, kv_bytes: Optional[float] = None,
                     draft_weight_bytes: float = 0.0) -> None:
        """One draft->verify pass: ``emitted`` tokens committed for one
        read of the target's weight stream. ``draft_weight_bytes`` adds
        the drafter's own weight stream (0 for n-gram) to the totals."""
        self._c_sstep.inc()
        self._c_sdraft.inc(drafted)
        self._c_saccept.inc(accepted)
        self._c_semit.inc(emitted)
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
        self._c_wbytes.inc(stats.weight_bytes)
        self._c_kvbytes.inc(stats.kv_bytes)
        self._c_savings.inc(stats.sparse_savings_bytes)

    def on_prefill_chunk(self, n_tokens: int) -> None:
        self._c_chunks.inc()
        self._c_prefill_tok.inc(n_tokens)

    # --- summary ---
    def summary(self) -> dict:
        """The reference's summary keys; ``ticks`` and
        ``phase_ms_per_tick`` with tracing on, ``bucket_attainment`` with
        profiling too."""
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
        out = {
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
            # sharded serving (ServeConfig.mesh): axes, shard count, the
            # pool's KV-head shards; {} without a mesh
            "mesh": self.mesh,
        }
        if self.tracer is not None and self.tracer.enabled:
            out["ticks"] = self.tracer.tick_summary()
            out["phase_ms_per_tick"] = self.tracer.phase_ms_per_tick()
            if self._profiler is not None:
                out["bucket_attainment"] = self._profiler.report(
                    self.tracer.tick_stats)
        return out


# ---------------------------------------------------------------------------
# fleet aggregation (serve.router / serve.fleet)


def fleet_summary(collectors: Dict[int, "MetricsCollector"],
                  replica_info: Optional[Dict[int, dict]] = None,
                  fleet_queue_depth: int = 0) -> dict:
    """Aggregate N replicas' collectors into one fleet view.

    Percentiles come from the POOLED per-request samples (the p50 of
    per-replica p50s is not the fleet's p50), throughput from all tokens
    over the UNION wall-clock window (earliest arrival anywhere to the
    last finish anywhere: replica walls overlap, so summing per-replica
    tokens_per_s would count time twice), the hit rate from the summed
    lookup and hit counters. ``per_replica`` keeps each replica's own
    summary() beside the aggregate; ``replica_info`` (id -> health dict,
    from ``Fleet.health()``) rides along when given."""
    per_replica: Dict[int, dict] = {}
    done: List[RequestMetrics] = []
    t0 = None
    t_end = None
    lookups = hits = cached_tokens = 0
    prefill_chunks = decode_steps = evictions = 0
    for rep_id in sorted(collectors):
        col = collectors[rep_id]
        per_replica[rep_id] = col.summary()
        done.extend(r for r in col.requests.values()
                    if r.finished_at is not None)
        if col.window_start is not None:
            t0 = col.window_start if t0 is None \
                else min(t0, col.window_start)
        lookups += col.prefix_lookups
        hits += col.prefix_hits
        cached_tokens += col.prefix_cached_tokens
        prefill_chunks += col.prefill_chunks
        decode_steps += col.decode_steps
        evictions += col.evictions
    if done:
        t_end = max(r.finished_at for r in done)
    wall = (t_end - t0) if (t0 is not None and t_end is not None) else None
    n_tok = sum(r.n_generated for r in done)
    ttfts = [r.ttft for r in done if r.ttft is not None]
    tpots = [r.tpot for r in done if r.tpot is not None]
    ttft_hit = [r.ttft for r in done
                if r.ttft is not None and r.cached_prompt_tokens > 0]
    ttft_miss = [r.ttft for r in done
                 if r.ttft is not None and r.cached_prompt_tokens == 0]
    out = {
        "n_replicas": len(collectors),
        "n_finished": len(done),
        "generated_tokens": n_tok,
        "tokens_per_s": (n_tok / wall) if wall else None,
        "ttft_p50_ms": _ms(percentile(ttfts, 50)),
        "ttft_p99_ms": _ms(percentile(ttfts, 99)),
        "tpot_p50_ms": _ms(percentile(tpots, 50)),
        "prefix_lookups": lookups,
        "prefix_hits": hits,
        "prefix_hit_rate": hits / max(lookups, 1),
        "prefix_cached_tokens": cached_tokens,
        "ttft_hit_p50_ms": _ms(percentile(ttft_hit, 50)),
        "ttft_miss_p50_ms": _ms(percentile(ttft_miss, 50)),
        "prefill_chunks": prefill_chunks,
        "decode_steps": decode_steps,
        "evictions": evictions,
        "fleet_queue_depth": fleet_queue_depth,
        "per_replica": per_replica,
    }
    if replica_info is not None:
        out["replicas"] = replica_info
    return out
