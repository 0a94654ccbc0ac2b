"""Inference engine: the paged scheduler engine and the legacy slot engine.

The port of the reference engine's two synchronous modes:

  * ``ServeConfig(paged=True)``: every phase of every request — chunked
    prefill, single-token decode and the K+1 verify rows of speculative
    decoding (``spec``, repro_torch.spec) — is a ROW of one batched
    ``ModelRunner.step`` per tick. The engine is pure host policy:
    admission (serve.scheduler, with the radix prefix cache under
    ``prefix_cache``), block accounting, copy-on-write and speculative
    rollback (serve.paged_kv), drafting, building the per-tick
    ``StepBatch`` and committing tokens through per-request
    ``SamplingParams`` (serve.sampling) or the acceptance rules, prompt
    log-probabilities included. ``kv_quant`` stores the KV pools in int8.
  * ``ServeConfig(paged=False)``, the default: fixed slots over a
    contiguous [max_batch, max_seq] KV cache. ``add_request`` prefills the
    prompt at once into a batch-1 cache, splices it into a free slot and
    draws the first token on the host (``sampling.sample_np``); each
    ``step`` decodes one token for every slot.

Both modes serve a codebook model (musicgen) as the reference does: a
prompt is [L, nc], each committed token an i32[nc], drawn greedy per
codebook whatever the request's sampling params, with no stop sequences,
prompt log-probabilities, prefix cache, speculation or async bursts.
M-RoPE models (qwen2-vl) are served on text-only positions; they refuse
the prefix cache and speculation too.

``ServeConfig.async_cfg`` (paged mode) turns on the asynchronous tick
pipeline: overlap ticks and device-resident decode bursts, whose tokens
the host replays through the synchronous commit path (see the section
"asynchronous tick pipeline" below).

``ServeConfig.obs`` turns on tracing (repro_torch.obs): every tick runs
in the tracer's ``tick`` span, its phases in phase spans (schedule,
admit, draft, batch_assemble, device_dispatch, device_wait, sample_sync,
postprocess) with the tick's attributes, and each request's lifecycle
events (arrival, admitted, prefix_hit, prefill_chunk, first_token,
preempted, replay_done, spec_*, cow, finish) land on its timeline;
``ObsConfig.profile`` (paged mode) adds the roofline profiler. The
default tracer is the shared no-op ``NULL_TRACER``.

The paged engine also carries the disagg handoff seam (serve.disagg):
``submit_prefill`` admits a request for prefill only, which parks at
``State.HANDOFF`` once its first token is committed; ``export_handoff``,
``adopt_handoff`` (on the decode engine) and ``release_handoff`` move it,
its KV blocks copied in place by ``ModelRunner.import_blocks_from``.

Sharded serving (``ServeConfig.mesh``, paged mode): the weights and the
KV-head-sharded block pool live on a mesh of shards (launch.mesh), one
``torch.device`` a shard, devices given by the ``device`` argument as a
sequence or the visible CUDA devices. The runner is the mesh-aware
boundary; everything host-side (scheduler, pool, prefix index) never sees
the mesh. The slot engine refuses a mesh, as the reference's does.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import spec as spec_mod
from repro_torch.configs.base import ModelConfig, ServeConfig
from repro_torch.device import Devices, resolve_device
from repro_torch.dist.sharding import ShardingPolicy
from repro_torch.launch.mesh import make_serving_mesh, mesh_info
from repro_torch.models import Model
from repro_torch.obs import ServingProfiler, make_tracer
from repro_torch.serve import (kv_cache, metrics as metrics_mod, paged_kv,
                               sampling)
from repro_torch.serve.metrics import StepStats
from repro_torch.serve.prefix_cache import RadixPrefixCache
from repro_torch.serve.runner import (DECODE, PREFILL, STOP_L, STOP_NS,
                                      VERIFY, ModelRunner, StepOutput)
from repro_torch.serve.scheduler import Request, SchedEntry, Scheduler, State


@dataclasses.dataclass
class HandoffPacket:
    """What a decode engine needs to adopt a prefilled request
    (serve.disagg). ``blocks`` are the SOURCE pool's physical block ids
    covering [0, ctx_len): valid while the source entry stays parked at
    State.HANDOFF (its slot is pinned, so defrag cannot move them).
    ``draw_ctr`` carries the request's sample-draw counter, so seeded
    sampling goes on where the prefill engine left off; ``metrics`` is the
    live RequestMetrics record, moved (not copied), so TTFT measured at
    prefill and TPOT measured at decode land on one request row."""
    req: Request
    ctx_len: int
    blocks: List[int]
    draw_ctr: int
    metrics: object = None


def _to(tree: dict, device: torch.device) -> dict:
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def _paged_only(scfg: ServeConfig) -> List[str]:
    """The features ``scfg`` asks for that the reference serves in paged
    mode only: its slot engine refuses them with a ValueError."""
    return [name for name, on in (
        ("async serving (ServeConfig.async_cfg)",
         scfg.async_cfg is not None and scfg.async_cfg.enabled),
        ("speculative decode (ServeConfig.spec)", scfg.spec is not None),
        ("roofline profiling (ObsConfig.profile)", scfg.obs.profile),
        ("prefix_cache", scfg.prefix_cache),
        ("sharded serving (ServeConfig.mesh)",
         scfg.mesh is not None and scfg.mesh.n_devices > 1)) if on]


class Engine:
    """The serving front door: host-side policy over one ModelRunner
    (paged mode) or over the slot cache (slot mode, the default).

    Construct with a ModelConfig, its params and a ServeConfig; submit
    work with ``add_request(Request)`` (or the batch loop ``run``),
    advance with ``step()`` — one tick = at most one batched device step
    — and read results off ``Request.tokens_out`` / ``metrics.summary()``.
    ``device`` defaults to CUDA; the params move there. Under
    ``scfg.mesh`` (more than one device) ``device`` is a sequence of
    devices, one a shard (repeats allowed: ``["cuda:0"] * 4``), or None
    for the visible CUDA devices (``launch.mesh.make_serving_mesh``,
    which raises when there are fewer); the whole params live on the
    mesh's home device and the runner places its shards."""

    def __init__(self, cfg: ModelConfig, params: dict, scfg: ServeConfig,
                 device: Devices = None,
                 drafter=None, draft_params: Optional[dict] = None,
                 tracer=None):
        """``scfg.spec`` turns on speculative decoding (paged mode only).
        ``drafter`` injects a ready repro_torch.spec drafter; otherwise one
        is built from the spec config (``draft_params`` are the weights of
        the small model for spec.drafter='model'; they move to
        ``device``). ``tracer`` injects a shared obs.Tracer; otherwise one
        is made from ``scfg.obs`` (the no-op NULL_TRACER by default)."""
        paged_only = [] if scfg.paged else _paged_only(scfg)
        if paged_only:
            raise ValueError(f"{', '.join(paged_only)} requires the paged "
                             f"engine (paged=True)")
        self.scfg = scfg
        self.mesh = self._make_mesh(device)
        self.device = resolve_device(device) if self.mesh is None \
            else self.mesh.home
        if scfg.spec is not None and (cfg.n_codebooks or cfg.mrope):
            raise ValueError(
                f"{cfg.name}: speculative decode supports plain token "
                f"streams only (no codebooks / M-RoPE)")
        if scfg.prefix_cache and (cfg.n_codebooks or cfg.mrope):
            raise ValueError(
                f"{cfg.name}: prefix caching keys on plain token-id "
                f"streams (no codebooks / M-RoPE)")
        self.cfg = cfg
        self.model = Model(cfg)
        self.params = _to(params, self.device)
        # tracing (repro_torch.obs): the instrumented tick path calls
        # through unconditionally; the null tracer makes every hook a
        # shared no-op
        self.tracer = tracer if tracer is not None \
            else make_tracer(scfg.obs)
        self.metrics = metrics_mod.MetricsCollector(cfg, scfg)
        self.metrics.tracer = self.tracer
        self.profiler = None           # obs.ServingProfiler (obs.profile)
        self._requests: Dict[int, Request] = {}
        self._rids = itertools.count()
        self.spec = scfg.spec
        self.drafter = None
        self.sampler = sampling.Sampler()
        # per-slot token-id presence for the repetition penalty (codebook
        # streams are greedy only and skip it)
        self._presence = None if cfg.n_codebooks else \
            np.zeros((scfg.max_batch, cfg.vocab), bool)
        self._draw_ctr: Dict[int, int] = {}    # rid -> sample-draw counter
        # disagg seam (serve.disagg): rids submitted for prefill only park
        # at State.HANDOFF instead of decoding here. The coordinator sets
        # external_prefill_overlap each tick, so that the decode engine's
        # interference split sees its paired prefill engine's work.
        self._handoff_rids: set = set()
        self.external_prefill_overlap = False
        self._tick_overlap = False
        # async tick pipeline: double-buffered overlap ticks and
        # device-resident decode bursts. ``_pending`` holds the one
        # in-flight overlap tick awaiting reconciliation.
        acfg = scfg.async_cfg
        self._async = acfg if (acfg is not None and acfg.enabled) else None
        self._pending = None
        self._flushed_finished: List[int] = []
        self._async_tick_no = 0
        self._loop_device_ticks = 0
        self._async_stats = {"sync_ticks": 0, "overlap_ticks": 0,
                             "loop_bursts": 0, "loop_device_ticks": 0}
        if self._async is not None and self._async.max_device_ticks < 1:
            raise ValueError("AsyncConfig.max_device_ticks must be >= 1")
        if scfg.paged:
            self._init_paged(drafter, draft_params)
        else:
            self._init_slots()

    def new_rid(self) -> int:
        """Engine-global request id: every front end draws from here."""
        rid = next(self._rids)
        while rid in self._requests:
            rid = next(self._rids)
        return rid

    @property
    def stats(self) -> List[StepStats]:
        return self.metrics.step_stats

    @property
    def admission_free(self) -> int:
        """How many more requests ``add_request`` would take right now:
        the scheduler's queue headroom in paged mode, the free slots in
        slot mode."""
        if self.scfg.paged:
            return max(self.scfg.max_queue - self.sched.n_waiting, 0)
        return len(self.alloc.free)

    def reset_metrics(self) -> None:
        """A fresh MetricsCollector wired to the live pool and prefix
        gauges; the pool's and index's event counters restart with it, so
        every rate in one summary() covers the same window, and so does
        the tracer's record. Pool state (blocks, refcounts, the radix
        tree) is untouched."""
        if self._async is not None:
            # commit any deferred tokens into the OLD window first
            self.flush_async()
        self.metrics = metrics_mod.MetricsCollector(self.cfg, self.scfg)
        self.metrics.tracer = self.tracer
        self.tracer.reset()            # same window as the collector
        if self.profiler is not None:
            self.metrics.profiler = self.profiler
        if self.scfg.paged:
            self.metrics.pool = self.pool
            self.metrics.prefix = self.prefix
            self.pool.reset_counters()
            self.metrics.mesh = self._mesh_summary()
            if self.prefix is not None:
                self.prefix.reset_counters()

    # ------------------------------------------------------------------
    # request loop

    def run(self, requests: List[Request], max_steps: int = 256
            ) -> Dict[int, Request]:
        """Continuous batching loop: admit whenever capacity frees, one
        scheduler tick per iteration."""
        pending = list(requests)
        done: Dict[int, Request] = {}
        steps = 0
        while (pending or self._busy()) and steps < max_steps:
            while pending and self.add_request(pending[0]):
                pending.pop(0)
            if pending and not self._busy():
                pending.pop(0)        # structurally unservable (too long)
            for rid in self.step():
                done[rid] = self._requests[rid]
            steps += 1
        return done

    def _busy(self) -> bool:
        if self.scfg.paged:
            return not self.sched.idle
        return bool(self._active) or bool(self._done_at_admit)

    def can_serve(self, req: Request) -> bool:
        """False means no amount of waiting will ever admit ``req``."""
        return len(np.asarray(req.prompt)) + 1 <= self.scfg.max_seq

    def add_request(self, req: Request) -> bool:
        prev = self._requests.get(req.rid)
        if prev is not None and prev is not req and not prev.done:
            raise ValueError(
                f"request id {req.rid} is already in flight; use "
                f"Engine.new_rid() to allocate ids")
        if not self.can_serve(req):
            return False
        if req.sampling.prompt_logprobs and (not self.scfg.paged
                                             or self.cfg.n_codebooks):
            raise ValueError(
                "prompt_logprobs needs the paged engine's all-position "
                "prefill logits (ServeConfig(paged=True), plain token "
                "streams)")
        if req.sampling.max_tokens is not None:
            req.max_new = min(req.max_new, req.sampling.max_tokens)
        if not self.scfg.paged:
            return self._add_request_slots(req)
        if not self.sched.submit(req):
            return False                       # queue full: shed load
        self._requests[req.rid] = req
        n_prompt = len(np.asarray(req.prompt))
        self.metrics.on_arrival(req.rid, n_prompt)
        self.tracer.event(req.rid, "arrival", prompt_len=n_prompt)
        return True

    def forget(self, rid: int) -> None:
        """Drop a finished request's record (and its metrics entry)."""
        req = self._requests.get(rid)
        if req is not None and req.done:
            del self._requests[rid]
            self.metrics.requests.pop(rid, None)
            self._draw_ctr.pop(rid, None)
            getattr(self, "_host_rngs", {}).pop(rid, None)
            getattr(self, "_accept_rngs", {}).pop(rid, None)

    def step(self) -> List[int]:
        """One engine tick; returns the rids that finished this tick. Under
        tracing the whole tick runs inside a ``tick`` span whose exit folds
        host/device attribution into ``tracer.tick_stats``."""
        with self.tracer.tick():
            if self.scfg.paged:
                if self._async is not None:
                    return self._tick_paged_async()
                return self._tick_paged()
            return self._step_slots()

    def defrag(self) -> Optional[np.ndarray]:
        """Compact the block pool: host bookkeeping, then the same moves
        on the device pools (the next step republishes the tables)."""
        self.flush_async()   # in-flight tables must not capture a move
        perm = self.pool.defrag()
        if perm is not None:
            self.runner.apply_perm(perm)
        return perm

    # ------------------------------------------------------------------
    # sampling plumbing (shared by both modes)

    def _sp(self, req: Request) -> sampling.SamplingParams:
        """Resolve the request's params; under speculation, requests that
        set no temperature inherit SpecConfig.temperature."""
        fallback = self.spec.temperature if self.spec is not None else 0.0
        return sampling.effective_params(req.sampling, fallback)

    def _seed_presence(self, slot: int, req: Request) -> None:
        if self._presence is None:
            return
        self._presence[slot, :] = False
        self._presence[slot, np.asarray(req.prompt, np.int64).reshape(-1)] \
            = True
        if req.tokens_out:
            self._presence[slot, np.asarray(req.tokens_out, np.int64)] = True

    def _sample_rows(self, pairs: List[Tuple[int, Request]],
                     last_logits: torch.Tensor
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """One batched sample over the rows in ``pairs`` [(slot, req)],
        each with its own params and its next key; other rows get garbage
        the caller ignores. Codebook models are greedy only, as the
        reference's: a per-codebook argmax of last_logits [B, nc, V], and
        a sampled request is served greedy."""
        B = self.scfg.max_batch
        if self.cfg.n_codebooks:
            tok = last_logits.argmax(dim=-1).to(torch.int32).cpu().numpy()
            return tok, np.zeros((B,), np.float32)
        temp = np.zeros((B,), np.float32)
        top_k = np.zeros((B,), np.int32)
        top_p = np.ones((B,), np.float32)
        rep = np.ones((B,), np.float32)
        keys = np.zeros((B, 2), np.uint32)
        for slot, req in pairs:
            sp = self._sp(req)
            temp[slot] = sp.temperature
            top_k[slot] = sp.top_k
            top_p[slot] = sp.top_p
            rep[slot] = sp.repetition_penalty
            ctr = self._draw_ctr.get(req.rid, 0)
            self._draw_ctr[req.rid] = ctr + 1
            keys[slot] = sampling.request_key(sp.seed, req.rid, ctr)
        return self.sampler(last_logits, self._presence, temp, top_k,
                            top_p, rep, keys)

    def _append_token(self, req: Request, slot: int, tok,
                      lp: float) -> str:
        """Commit one token (a codebook model's: i32[nc]) to the request
        stream. Returns "ok", "stop" (a stop sequence matched and was
        truncated off; codebook streams have no stops) or "max"."""
        req.tokens_out.append(tok)
        if req.sampling.logprobs:
            req.logprobs_out.append(float(lp))
        if self._presence is not None:
            self._presence[slot, int(tok)] = True
        if req.sampling.stop and not self.cfg.n_codebooks:
            cut = sampling.stop_truncate(req.tokens_out, req.sampling.stop)
            if cut is not None:
                del req.tokens_out[cut:]
                del req.logprobs_out[cut:]
                return "stop"
        if len(req.tokens_out) >= req.max_new:
            return "max"
        return "ok"

    # ------------------------------------------------------------------
    # paged mode

    def _init_paged(self, drafter=None, draft_params=None) -> None:
        scfg = self.scfg
        self.pool = paged_kv.PagedKVCache(
            self.cfg, n_blocks=scfg.pool_blocks, block_size=scfg.block_size,
            max_batch=scfg.max_batch,
            max_blocks_per_seq=scfg.blocks_per_seq, int8_kv=scfg.kv_quant)
        self.prefix = RadixPrefixCache(self.pool) if scfg.prefix_cache \
            else None                          # registers as pool.index
        self.sched = Scheduler(scfg, self.pool, prefix=self.prefix)
        if self.mesh is not None:
            # KV heads shard over 'model' only when they divide; weights
            # shard independently, so an indivisible head count degrades
            # the POOL to replicated without turning sharded serving off
            msize = self.mesh.shape["model"]
            self.pool.model_shards = \
                msize if self.cfg.n_kv_heads % msize == 0 else 1
        self.metrics.pool = self.pool
        self.metrics.prefix = self.prefix
        self.metrics.mesh = self._mesh_summary()
        self.runner = ModelRunner(self.model, self.params, scfg,
                                  self.device, tracer=self.tracer,
                                  mesh=self.mesh, policy=self._policy)
        if scfg.obs.profile:
            # roofline attainment (obs.profile): the static cost per
            # bucket, from shapes, joins the ticks' device time
            self.profiler = ServingProfiler(self.runner)
            self.metrics.profiler = self.profiler
        self._kv_per_tok = paged_kv.kv_bytes_per_token(self.cfg,
                                                       scfg.kv_quant)
        if self.spec is not None:
            self.drafter = drafter if drafter is not None else \
                spec_mod.make_drafter(
                    self.spec, self.cfg, self.params, scfg,
                    draft_params=None if draft_params is None
                    else _to(draft_params, self.device),
                    device=self.device)
            self.kctl = spec_mod.AdaptiveK.from_config(self.spec)
            # per-request acceptance RNGs: a request's accept/resample
            # draws do not depend on the batch's composition. The spawn
            # key's second element keeps each stream independent of the
            # drafter's per-rid sampling RNG (spawn_key=(rid,)) even when
            # both derive from spec.seed.
            self._accept_rngs: Dict[int, np.random.Generator] = {}
            self._draft_w_per_step = self.drafter.weight_bytes_per_step(
                scfg)
            self._draft_steps_seen = 0
        if self.mesh is not None:
            # the runner's shards are the weights: no whole copy stays on
            # the home device (a self-speculative drafter holds its own)
            self.params = None

    def _make_mesh(self, device):
        """Materialize ServeConfig.mesh into a launch.mesh.Mesh and the
        exact_tp ShardingPolicy (None and None when unsharded). The mesh
        threads engine -> runner; everything host-side never sees it."""
        self._policy = None
        mcfg = self.scfg.mesh
        if mcfg is None or mcfg.n_devices <= 1:
            return None
        if mcfg.data > 1:
            raise ValueError(
                "MeshConfig.data > 1 is reserved: the serving runner "
                "does not batch-shard step inputs yet, so extra data-"
                "axis devices would only replicate identical work")
        if isinstance(device, (str, torch.device)):
            raise ValueError(
                f"ServeConfig.mesh asks for {mcfg.n_devices} devices: pass "
                f"device as a sequence of {mcfg.n_devices} devices (repeats "
                f"allowed), or None for the visible CUDA devices")
        # exact_tp: the bit-reproducible layout (every collective a
        # concatenation)
        self._policy = ShardingPolicy(shard_kv_seq=mcfg.shard_kv_seq,
                                      exact_tp=True)
        mesh = make_serving_mesh(mcfg, device)
        for dev in mesh.devices:
            resolve_device(dev)        # a CUDA shard without a card raises
        return mesh

    def _mesh_summary(self) -> dict:
        if getattr(self, "mesh", None) is None:
            return {}
        info = mesh_info(self.mesh)
        info["kv_pool_shards"] = self.pool.model_shards
        info["shard_kv_seq"] = bool(self._policy
                                    and self._policy.shard_kv_seq)
        return info

    def _accept_rng(self, rid: int, sp: sampling.SamplingParams
                    ) -> np.random.Generator:
        rng = self._accept_rngs.get(rid)
        if rng is None:
            ent = self.spec.seed if sp.seed is None else sp.seed
            rng = self._accept_rngs[rid] = np.random.default_rng(
                np.random.SeedSequence(entropy=ent,
                                       spawn_key=(rid & 0xFFFFFFFF,
                                                  0xACC)))
        return rng

    def _propose(self, items):
        """Batched drafting where the drafter has it (ModelDrafter decodes
        every slot in one device step per draft token), else one propose
        per row."""
        batched = getattr(self.drafter, "propose_batch", None)
        if batched is not None:
            return batched(items)
        return [self.drafter.propose(rid, ctx, k) for rid, ctx, k in items]

    def _commit_emitted(self, e: SchedEntry, tok: int, lp: float,
                        finished: List[int], first: bool = False) -> bool:
        """Commit one token; finishes the entry on stop/max. Returns False
        when the request is done."""
        status = self._append_token(e.req, e.slot, tok, lp)
        if status != "stop":
            if first:
                self.metrics.on_first_token(e.req.rid)
                self.tracer.event(e.req.rid, "first_token")
            else:
                self.metrics.on_token(e.req.rid,
                                      prefill_overlap=self._tick_overlap)
        if status != "ok":
            self._finish(e, finished)
            return False
        return True

    def _ensure_blocks(self, e: SchedEntry, upto_len: int) -> str:
        """Grow e's block list to cover [0, upto_len), evicting only
        victims that rank strictly below e until it fits. Returns "ok",
        "defer" (retry next tick) or "never" (cannot fit a table row)."""
        if self.pool.blocks_for(upto_len) > self.pool.max_blocks_per_seq:
            return "never"
        while not self.pool.allocate(e.slot, upto_len):
            victim = self.sched.pick_victim(e)
            if victim is None:
                if self.sched.n_active <= 1:
                    raise RuntimeError(
                        f"KV pool too small: {self.pool.n_blocks} blocks "
                        f"of {self.pool.block_size} cannot hold one "
                        f"request of {upto_len} tokens")
                return "defer"
            self.metrics.on_preemption(victim.req.rid)
            self.tracer.event(victim.req.rid, "preempted",
                              by=e.req.rid, at_tokens=victim.ctx_len)
            self.sched.preempt(victim)
        return "ok"

    def _tick_paged(self) -> List[int]:
        """One tick = one batched ModelRunner.step serving every phase:
        admission (prefix match), capacity resolution (may evict),
        drafting for speculative rows, copy-on-write, one device step over
        prefill, decode and verify rows, one batched sample and the
        host-side commit (acceptance and rollback for verify rows)."""
        finished: List[int] = []
        tr = self.tracer
        with tr.span("schedule"):
            with tr.span("admit"):
                for e in self.sched.admit():
                    self._seed_presence(e.slot, e.req)
                    tr.event(e.req.rid, "admitted", slot=e.slot,
                             cached=e.cached_len, replay=e.replay)
                    if self.prefix is not None \
                            and not e.req.sampling.prompt_logprobs:
                        # prompt_logprobs requests never consult the index
                        self.metrics.on_prefix_lookup(e.req.rid,
                                                      e.cached_len)
                        if e.cached_len > 0:
                            tr.event(e.req.rid, "prefix_hit",
                                     cached_tokens=e.cached_len)
            spec = self.spec
            S_spec = spec.k_max + 1 if spec is not None else 0
            K = 0
            if spec is not None:
                K = self.kctl.k if spec.adaptive \
                    else min(spec.k, spec.k_max)

            # ---- 1) capacity resolution -------------------------------
            prefill_plan: List[Tuple[SchedEntry, int, int]] = []
            for e in self.sched.prefill_entries():
                if e.req.rid not in self.sched.active:
                    continue                   # evicted making room above
                valid = min(self.scfg.prefill_chunk,
                            len(e.prefill_tokens()) - e.pos)
                st = self._ensure_blocks(e, e.pos + valid)
                if st == "never":
                    self._finish(e, finished)  # prompt can't fit: give up
                elif st == "ok":
                    prefill_plan.append((e, e.pos, valid))
            deferred = set()
            for e in list(self.sched.decode_entries()):
                if e.req.rid not in self.sched.active:
                    continue
                if spec is not None:
                    # cover the worst-case speculative or resync tail
                    # FIRST: rows that end up deferred must not burn
                    # drafting work; what a short proposal leaves unused
                    # the post-commit truncate returns
                    need = min(len(e.resync), S_spec) if e.resync \
                        else min(K, max(self.scfg.max_seq - e.ctx_len - 2,
                                        0)) + 1
                else:
                    need = 1
                st = self._ensure_blocks(e, e.ctx_len + need)
                if st == "never":
                    self._finish(e, finished)  # context ceiling reached
                elif st == "defer":
                    deferred.add(e.req.rid)    # wait for capacity
            prefill_plan = [(e, pos, v) for e, pos, v in prefill_plan
                            if e.req.rid in self.sched.active]
            run_rows = [e for e in self.sched.decode_entries()
                        if e.req.rid not in deferred]
            # interference class of this tick's committed tokens: prefill
            # rows in this batch, or (disagg) prefill in flight on the
            # paired engine
            self._tick_overlap = bool(prefill_plan) \
                or self.external_prefill_overlap

        # ---- 2) drafting (spec only) ----------------------------------
        # rows replaying after eviction re-feed committed tokens through
        # the same verify math that first wrote their KV ("resync":
        # forced acceptance, no emission)
        proposals: Dict[int, tuple] = {}
        if spec is not None and run_rows:
            with tr.span("draft", rows=len(run_rows), k=K):
                items = []
                for e in run_rows:
                    if e.resync:
                        proposals[e.req.rid] = (
                            "resync",
                            np.asarray(e.resync[:S_spec], np.int32), None)
                        continue
                    budget = min(K, self.scfg.max_seq - e.ctx_len - 2)
                    ctx = np.concatenate([
                        np.asarray(e.req.prompt, np.int32),
                        np.asarray(e.req.tokens_out, np.int32)])
                    items.append((e.req.rid, ctx, max(budget, 0)))
                for (rid, _, _), (toks, qd) in zip(items,
                                                   self._propose(items)):
                    proposals[rid] = ("draft", np.asarray(toks, np.int32),
                                      qd)
                    tr.event(rid, "spec_draft", k=len(toks))

        if not prefill_plan and not run_rows:
            return finished

        # ---- 3) one batched step ---------------------------------------
        with tr.span("batch_assemble"):
            rows: List[Tuple[int, int, np.ndarray, int]] = []
            for e, pos, valid in prefill_plan:
                rows.append((e.slot, PREFILL,
                             np.asarray(e.prefill_tokens()[pos:pos + valid],
                                        np.int32), pos))
            for e in run_rows:
                if spec is None:
                    rows.append((e.slot, DECODE,
                                 np.asarray([e.req.tokens_out[-1]],
                                            np.int32),
                                 e.ctx_len))
                    continue
                kind, toks, _ = proposals[e.req.rid]
                seq = toks if kind == "resync" else np.concatenate(
                    [np.asarray([e.req.tokens_out[-1]], np.int32), toks])
                rows.append((e.slot, VERIFY, seq, e.ctx_len))
                # pin across the step: a defrag must not move blocks the
                # step's block table has captured
                self.pool.pin(e.slot)
            # copy-on-write BEFORE the tables snapshot: a row whose write
            # span lands in a block referenced elsewhere (a prefix-shared
            # block, a rollback into a shared partial tail) gets a private
            # copy, so siblings never observe the write
            slot_rid = {e.slot: e.req.rid
                        for e in list(self.sched.active.values())}
            cow: List[Tuple[int, int]] = []
            for slot, _, toks, start in rows:
                copies = self.pool.cow_for_write(slot, start, len(toks))
                if copies:
                    tr.event(slot_rid.get(slot, -1), "cow",
                             n_blocks=len(copies))
                cow.extend(copies)
            if cow:
                self.runner.copy_blocks(cow)
            batch = self.runner.new_batch(max(len(r[2]) for r in rows),
                                          self.pool.tables())
            for slot, phase, toks, start in rows:
                batch.add_row(slot, phase, toks, start)
            if tr.enabled:
                # width = the bucket (the step's token width), which the
                # roofline profiler joins tick time to static cost by, as
                # it does the live keys kernel 1 reads
                valid_tokens = sum(len(r[2]) for r in rows)
                width = batch.tokens.shape[1]
                denom = self.scfg.max_batch * width
                tr.tick_attrs(
                    rows_prefill=len(prefill_plan),
                    rows_decode=len(run_rows) if spec is None else 0,
                    rows_verify=len(run_rows) if spec is not None else 0,
                    width=width, valid_tokens=valid_tokens,
                    pad_waste_frac=1.0 - valid_tokens / denom if denom
                    else 0.0,
                    n_keys=batch.live_keys(self.scfg.block_size))
        out = self.runner.step(batch)

        # ---- 4) sample + commit ----------------------------------------
        sample_pairs: List[Tuple[int, Request]] = []
        completing = set()
        for e, pos, valid in prefill_plan:
            if pos + valid >= len(e.prefill_tokens()):
                completing.add(e.req.rid)
                if not e.replay:
                    sample_pairs.append((e.slot, e.req))
        if spec is None:
            sample_pairs.extend((e.slot, e.req) for e in run_rows)
        tok_np = lp_np = None
        if sample_pairs:
            with tr.span("sample_sync", rows=len(sample_pairs)):
                tok_np, lp_np = self._sample_rows(sample_pairs,
                                                  out.last_logits)

        # prefill rows: advance the frontier; a completing row emits its
        # first token (a replayed row already knows its next token)
        with tr.span("postprocess"):
            for e, pos, valid in prefill_plan:
                self._record_prompt_logprobs(e, out, pos, valid)
                e.pos = pos + valid
                self.metrics.on_prefill_chunk(valid)
                tr.event(e.req.rid, "prefill_chunk", pos=pos, valid=valid)
                if e.req.rid not in completing:
                    continue
                e.ctx_len = e.pos
                e.state = State.RUNNING
                # the prompt's KV is final: publish its full blocks so
                # concurrent same-prefix requests share them now
                self.sched.index_prefix(e, e.prefill_tokens(), e.pos)
                if e.replay:
                    e.replay = False
                    tr.event(e.req.rid, "replay_done",
                             resync=e.resync_replay)
                    if e.resync_replay:
                        # prompt KV restored; the generated tokens' KV
                        # re-derives through verify steps (bit for bit as
                        # it was first written) before drafting resumes
                        e.resync = [int(t) for t in e.req.tokens_out[:-1]]
                        e.resync_replay = False
                else:
                    self._commit_emitted(e, self._one_token(tok_np, e.slot),
                                         lp_np[e.slot], finished,
                                         first=True)
                # disagg: a prefill-only request parks at HANDOFF once its
                # context is final (first token committed, or its replay
                # caught up) instead of decoding here. Requests that
                # finished on their first token (stop or max) and spec
                # entries mid-resync keep their normal lifecycle.
                if e.req.rid in self._handoff_rids \
                        and e.req.rid in self.sched.active \
                        and not e.resync:
                    self._park_handoff(e)
            if spec is None:
                self._commit_decode(run_rows, tok_np, lp_np, finished)
            else:
                self._commit_verify(run_rows, proposals, out, finished)
        return finished

    def _record_prompt_logprobs(self, e: SchedEntry, out: StepOutput,
                                pos: int, valid: int) -> None:
        """Fill req.prompt_logprobs_out[pos:pos+valid] from this prefill
        chunk's all-position logits: logits[j] predicts position pos+j+1,
        so position pos's own logprob comes from the PREVIOUS chunk's last
        row (kept on the entry as ``plp_prev``); position 0 has no prefix
        and records None. Replayed positions (already recorded) are
        skipped by the exact-length guard."""
        req = e.req
        if not req.sampling.prompt_logprobs:
            return
        P = len(np.asarray(req.prompt).reshape(-1))
        lps = req.prompt_logprobs_out
        toks = np.asarray(e.prefill_tokens()).reshape(-1)
        row = None
        for j in range(valid):
            p = pos + j
            if p >= P:
                break
            if p == 0:
                if not lps:
                    lps.append(None)
                continue
            if len(lps) != p:
                continue
            if j == 0:
                z = e.plp_prev
            else:
                if row is None:
                    row = out.row_logits(e.slot)
                z = row[j - 1]
            if z is not None:
                lps.append(sampling.token_logprob(z, int(toks[p])))
        if pos + valid < P:
            if row is None:
                row = out.row_logits(e.slot)
            e.plp_prev = np.array(row[valid - 1])
        else:
            e.plp_prev = None

    def _one_token(self, tok_np: np.ndarray, slot: int):
        """Row ``slot``'s sampled token: an int, or a codebook model's
        i32[nc]."""
        if self.cfg.n_codebooks:
            return tok_np[slot].copy()
        return int(tok_np[slot])

    def _commit_decode(self, rows: List[SchedEntry], tok_np, lp_np,
                       finished: List[int]) -> None:
        """Commit one sampled token per decode row."""
        if not rows:
            return
        kv_read = sum(e.ctx_len for e in rows) * self._kv_per_tok
        for e in rows:
            alive = self._commit_emitted(e, self._one_token(tok_np, e.slot),
                                         lp_np[e.slot], finished)
            e.ctx_len += 1
            if alive and e.ctx_len + 1 > self.scfg.max_seq:
                self._finish(e, finished)
        self.metrics.on_decode_step(len(rows), kv_bytes=kv_read)

    def _commit_verify(self, rows: List[SchedEntry], proposals, out,
                       finished: List[int]) -> None:
        """Acceptance and rollback for verify rows: commit the longest
        correct prefix plus the free target token, truncate the rejected
        tail's blocks, unpin."""
        if not rows:
            return
        logits = out.logits.float().cpu().numpy()   # one copy for all rows
        kv_read = 0.0
        drafted = accepted = emitted_total = 0
        for e in rows:
            kind, toks, qd = proposals[e.req.rid]
            m = len(toks)
            nv = m if kind == "resync" else m + 1  # query j reads ctx+j keys
            kv_read += (nv * e.ctx_len
                        + nv * (nv - 1) / 2) * self._kv_per_tok
            if kind == "resync":
                # committed history: KV now re-written, nothing to emit
                e.ctx_len += m
                del e.resync[:m]
                self.pool.unpin(e.slot)
                self.tracer.event(e.req.rid, "spec_resync", n=m,
                                  remaining=len(e.resync))
                continue
            row_logits = logits[e.slot, :m + 1]
            sp = self._sp(e.req)
            if sp.top_k > 0 or sp.top_p < 1.0 \
                    or sp.repetition_penalty != 1.0:
                # the request's full filters: acceptance against the law
                # the plain sampler draws from
                seen = list(np.asarray(e.req.prompt, np.int64)) \
                    + list(e.req.tokens_out)
                emitted, a = spec_mod.filtered_accept(
                    self._accept_rng(e.req.rid, sp), toks, qd, row_logits,
                    sp, seen)
            elif sp.temperature <= 0:
                emitted, a = spec_mod.greedy_accept(
                    toks, row_logits.argmax(axis=-1).astype(np.int32))
            else:
                emitted, a = spec_mod.rejection_accept(
                    self._accept_rng(e.req.rid, sp), toks, qd, row_logits,
                    sp.temperature)
            drafted += m
            accepted += a
            space = e.req.max_new - len(e.req.tokens_out)
            emitted = emitted[:space]
            P = len(np.asarray(e.req.prompt))
            alive = True
            row_emitted = 0
            for j, t in enumerate(emitted):
                lp = 0.0
                if sp.logprobs:
                    p = sampling.softmax(row_logits[j], 1.0)
                    lp = float(np.log(np.maximum(p[int(t)], 1e-30)))
                alive = self._commit_emitted(e, int(t), lp, finished)
                emitted_total += 1
                row_emitted += 1
                if not alive:
                    break
            self.metrics.on_spec_request(e.req.rid, m, a, row_emitted)
            self.tracer.event(e.req.rid, "spec_verify", drafted=m,
                              accepted=a, emitted=row_emitted)
            # committed frontier: the last emitted token's KV is written by
            # the NEXT verify step; a stop truncation shrinks tokens_out,
            # so re-derive rather than add
            e.ctx_len = P + max(len(e.req.tokens_out) - 1, 0)
            # rollback: free whole blocks past the committed frontier
            rolled = self.pool.truncate(e.slot, e.ctx_len)
            if a < m:
                self.tracer.event(e.req.rid, "spec_rollback",
                                  rejected=m - a, freed_blocks=rolled or 0)
            self.pool.unpin(e.slot)
            if alive and e.ctx_len + 1 > self.scfg.max_seq:
                self._finish(e, finished)
        draft_steps = getattr(self.drafter, "steps", 0)
        draft_w = (draft_steps - self._draft_steps_seen) \
            * self._draft_w_per_step
        self._draft_steps_seen = draft_steps
        self.metrics.on_spec_step(len(rows), drafted, accepted,
                                  emitted_total, kv_bytes=kv_read,
                                  draft_weight_bytes=draft_w)
        if self.spec.adaptive and drafted:
            self.kctl.update(accepted / drafted)

    def _finish(self, e: SchedEntry, finished: List[int]) -> None:
        self.metrics.on_finish(e.req.rid)
        self.tracer.event(e.req.rid, "finish",
                          n_tokens=len(e.req.tokens_out))
        self.sched.finish(e)
        if self.drafter is not None:
            self.drafter.forget(e.req.rid)
            self._accept_rngs.pop(e.req.rid, None)
        finished.append(e.req.rid)

    # ------------------------------------------------------------------
    # asynchronous tick pipeline (ServeConfig.async_cfg)
    #
    # Three tick flavors, chosen per tick:
    #   * loop    — pure-decode steady state: up to max_device_ticks
    #               forward+sample iterations chained on the device
    #               (runner.decode_burst: on CUDA, replays of a captured
    #               graph); the host then REPLAYS the emitted tokens
    #               through the synchronous commit path (token identity by
    #               construction).
    #   * overlap — double-buffered: dispatch tick t's step and its
    #               on-device sample WITHOUT waiting (runner.graph_step),
    #               reconcile tick t-1's pending tokens while t runs; tick
    #               t+1 chains on t's still-in-flight tokens via a device
    #               where().
    #   * sync    — the plain _tick_paged, used whenever anything beyond
    #               pure decode is in play (prefill, spec, admissions,
    #               eviction pressure, rep-penalty rows, forced cadence).
    #               Sync ticks always flush the pending overlap tick first,
    #               so admissions and preemptions never race an in-flight
    #               reconcile.
    #
    # Overrun is harmless by design: a row that finished at reconcile may
    # have one more step in flight. Its results are dropped by the
    # entry-identity check, and its stale KV writes are never read: the
    # sync path republishes host-truth lens and tables, and a freed block
    # is reused only by steps queued behind the in-flight one on the same
    # stream. Under tracing an async tick's phases run in the reference's
    # spans (schedule, batch_assemble, device_dispatch, sample_sync with
    # the tick it reconciles, device_wait, postprocess) and a burst's
    # tick records its device iterations as ``device_ticks``.

    def flush_async(self) -> None:
        """Reconcile any in-flight overlap tick now, so that out-of-band
        mutators (defrag, metric-window resets) see fully committed host
        state; rids finished during a flush are returned by the next
        step() call."""
        if self._pending is not None:
            self._flushed_finished.extend(self._reconcile_pending())

    def _tick_paged_async(self) -> List[int]:
        acfg = self._async
        self._async_tick_no += 1
        pre = self._flushed_finished
        self._flushed_finished = []
        force = acfg.sync_every > 0 \
            and self._async_tick_no % acfg.sync_every == 0
        rows = None if force else self._async_decode_rows()
        if rows is None:
            fin = self._reconcile_pending()
            self._async_stats["sync_ticks"] += 1
            return pre + fin + self._tick_paged()
        if acfg.max_device_ticks > 1 and self.mesh is None:
            # loop mode wants committed state: flush the pending overlap
            # tick, drop rows it finished, then burst on the device (a
            # sharded engine keeps loop mode off, as the reference's)
            fin = self._reconcile_pending()
            rows = [e for e in rows
                    if self.sched.active.get(e.req.rid) is e]
            out = self._tick_async_loop(rows) if rows else None
            if out is not None:
                return pre + fin + out
            self._async_stats["sync_ticks"] += 1
            return pre + fin + self._tick_paged()
        out = self._tick_async_overlap(rows)
        if out is None:
            fin = self._reconcile_pending()
            self._async_stats["sync_ticks"] += 1
            return pre + fin + self._tick_paged()
        return pre + out

    def _async_decode_rows(self) -> Optional[List[SchedEntry]]:
        """The decode rows an async tick may run, or None when this tick
        needs the synchronous path. Conservative by design: anything that
        samples from host state (the repetition penalty), mutates
        scheduling state (admission, prefill, eviction, speculation's
        drafting and resync) or exports state mid-stream (a disagg
        handoff) falls back to sync — identity first, overlap second.
        Profiling keeps every tick sync: its buckets are the runner's
        eager steps."""
        if self.spec is not None or self.cfg.n_codebooks \
                or self.profiler is not None:
            return None
        if not self.sched.decode_only():
            return None
        rows = list(self.sched.decode_entries())
        if not rows:
            return None
        for e in rows:
            sp = self._sp(e.req)
            if sp.repetition_penalty != 1.0 or e.resync \
                    or not e.req.tokens_out \
                    or e.req.rid in self._handoff_rids:
                return None
        return rows

    def _reconcile_pending(self) -> List[int]:
        """Commit the deferred overlap tick: wait for its tokens (the only
        host wait of the pair of ticks), then replay them through the
        synchronous commit path. Rows whose entry is no longer the active
        one for their rid (finished or evicted since dispatch) are
        overrun: their tokens are dropped."""
        pend = self._pending
        if pend is None:
            return []
        self._pending = None
        tr = self.tracer
        finished: List[int] = []
        host = pend["host"]
        with tr.span("sample_sync", rows=len(pend["entries"]),
                     reconciles_tick=pend["tick"]):
            with tr.device_wait(host.clock):
                tok_np, lp_np = host.wait()
        live = [e for e in pend["entries"]
                if self.sched.active.get(e.req.rid) is e]
        prev = self._tick_overlap
        self._tick_overlap = pend["overlap"]
        try:
            with tr.span("postprocess"):
                self._commit_decode(live, tok_np, lp_np, finished)
        finally:
            self._tick_overlap = prev
        return finished

    def _sampling_arrays(self, rows: List[SchedEntry]):
        """Per-slot temperature, top-k and top-p of ``rows``, and whether
        any of them samples."""
        B = self.scfg.max_batch
        temp = np.zeros((B,), np.float32)
        top_k = np.zeros((B,), np.int32)
        top_p = np.ones((B,), np.float32)
        for e in rows:
            sp = self._sp(e.req)
            temp[e.slot], top_k[e.slot], top_p[e.slot] = (
                sp.temperature, sp.top_k, sp.top_p)
        return temp, top_k, top_p, bool(np.any(temp > 0))

    def _tick_async_overlap(self, rows: List[SchedEntry]
                            ) -> Optional[List[int]]:
        """Double-buffered decode tick: dispatch this tick's step and its
        on-device sample, then reconcile LAST tick's pending tokens while
        this one runs. Rows with a pending token chain on it through a
        device where(): their input token never touches the host. Returns
        None (state untouched, the caller falls back to sync) when
        capacity would need eviction or a row is at its context ceiling.
        """
        tr = self.tracer
        scfg = self.scfg
        pend = self._pending
        prids = pend["rids"] if pend is not None else frozenset()
        B = scfg.max_batch
        with tr.span("schedule"):
            need_blocks = 0
            needs = []
            for e in rows:
                off = 1 if e.req.rid in prids else 0
                need = e.ctx_len + off + 1
                nb = self.pool.blocks_for(need)
                if need > scfg.max_seq \
                        or nb > self.pool.max_blocks_per_seq:
                    return None
                have = len(self.pool.owned.get(e.slot, ()))
                need_blocks += max(nb - have, 0)
                needs.append((e, off, need))
            if need_blocks > self.pool.n_free:
                return None                    # eviction is sync work
            for e, off, need in needs:
                ok = self.pool.allocate(e.slot, need)
                assert ok, "n_free precheck covered this allocation"
            self._tick_overlap = self.external_prefill_overlap
        with tr.span("batch_assemble"):
            cow: List[Tuple[int, int]] = []
            for e, off, _ in needs:
                cow.extend(self.pool.cow_for_write(e.slot,
                                                   e.ctx_len + off, 1))
            if cow:
                self.runner.copy_blocks(cow)
            batch = self.runner.new_batch(1, self.pool.tables())
            chain = np.zeros((B,), bool)
            for e, off, _ in needs:
                if off:
                    # placeholder token: overridden on the device by the
                    # still-in-flight pending sample for this row
                    batch.add_row(e.slot, DECODE, [0], e.ctx_len + 1)
                    chain[e.slot] = True
                else:
                    batch.add_row(e.slot, DECODE,
                                  [int(e.req.tokens_out[-1])], e.ctx_len)
            # sample THIS tick on the device too; the host wait is
            # deferred to next tick's reconcile
            temp, top_k, top_p, sampled = self._sampling_arrays(rows)
            keys = np.zeros((B, 2), np.int64)
            for e in rows:
                sp = self._sp(e.req)
                ctr = self._draw_ctr.get(e.req.rid, 0)
                self._draw_ctr[e.req.rid] = ctr + 1
                keys[e.slot] = sampling.request_key(sp.seed, e.req.rid, ctr)
            if tr.enabled:
                tr.tick_attrs(rows_decode=len(rows), width=1,
                              valid_tokens=len(rows),
                              pad_waste_frac=1.0 - len(rows) / B,
                              n_keys=batch.live_keys(scfg.block_size),
                              device_ticks=1, async_mode="overlap")
        tok_dev, lp_dev, host = self.runner.graph_step(
            batch, sampled, keys, temp, top_k, top_p, chain=chain,
            pending=pend["tok"] if pend is not None and chain.any()
            else None)
        new_pend = {"entries": list(rows),
                    "rids": frozenset(e.req.rid for e in rows),
                    "tok": tok_dev, "lp": lp_dev, "host": host,
                    "tick": getattr(tr, "n_ticks", 0),
                    "overlap": self._tick_overlap}
        finished = self._reconcile_pending()
        self._pending = new_pend
        self._async_stats["overlap_ticks"] += 1
        return finished

    def _tick_async_loop(self, rows: List[SchedEntry]
                         ) -> Optional[List[int]]:
        """Device-resident burst: chain up to max_device_ticks decode
        iterations on the device (one host wait), then replay the emitted
        tokens through the synchronous commit path. Returns None (state
        untouched) when the burst cannot pre-allocate without eviction."""
        tr = self.tracer
        scfg = self.scfg
        K = self._async.max_device_ticks
        B = scfg.max_batch
        with tr.span("schedule"):
            budgets: Dict[int, int] = {}
            need_blocks = 0
            for e in rows:
                b = min(K, e.req.max_new - len(e.req.tokens_out),
                        scfg.max_seq - e.ctx_len)
                if b < 1:
                    return None        # at a ceiling: a sync tick finishes
                nb = self.pool.blocks_for(e.ctx_len + b)
                if nb > self.pool.max_blocks_per_seq:
                    return None
                budgets[e.slot] = b
                have = len(self.pool.owned.get(e.slot, ()))
                need_blocks += max(nb - have, 0)
            if need_blocks > self.pool.n_free:
                return None                    # eviction is sync work
            for e in rows:
                ok = self.pool.allocate(e.slot,
                                        e.ctx_len + budgets[e.slot])
                assert ok, "n_free precheck covered this allocation"
            self._tick_overlap = self.external_prefill_overlap
        with tr.span("batch_assemble"):
            cow: List[Tuple[int, int]] = []
            for e in rows:
                cow.extend(self.pool.cow_for_write(e.slot, e.ctx_len,
                                                   budgets[e.slot]))
            if cow:
                self.runner.copy_blocks(cow)
            temp, top_k, top_p, sampled = self._sampling_arrays(rows)
            tok0 = np.zeros((B,), np.int32)
            lens0 = np.zeros((B,), np.int32)
            alive0 = np.zeros((B,), np.int32)
            budget = np.zeros((B,), np.int32)
            hist0 = np.full((B, STOP_L), -1, np.int32)
            stops = np.full((B, STOP_NS, STOP_L), -1, np.int32)
            stop_len = np.zeros((B, STOP_NS), np.int32)
            keys = np.zeros((K, B, 2), np.int64)
            k_burst = max(budgets.values())
            ctr0: Dict[int, int] = {}
            for e in rows:
                s, sp = e.slot, self._sp(e.req)
                tok0[s] = int(e.req.tokens_out[-1])
                lens0[s] = e.ctx_len
                alive0[s] = 1
                budget[s] = budgets[s]
                tail = e.req.tokens_out[-STOP_L:]
                if tail:
                    hist0[s, STOP_L - len(tail):] = tail
                ns = 0
                for seq in sp.stop:
                    # longer stops (or more than STOP_NS of them) match on
                    # the host at replay: the device match only buys early
                    # exit
                    if 0 < len(seq) <= STOP_L and ns < STOP_NS:
                        stops[s, ns, STOP_L - len(seq):] = seq
                        stop_len[s, ns] = len(seq)
                        ns += 1
                ctr0[s] = self._draw_ctr.get(e.req.rid, 0)
                if sampled:
                    for k in range(budgets[s]):
                        keys[k, s] = sampling.request_key(
                            sp.seed, e.req.rid, ctr0[s] + k)
            tr.tick_attrs(rows_decode=len(rows), width=1,
                          valid_tokens=len(rows),
                          pad_waste_frac=1.0 - len(rows) / B,
                          async_mode="loop")
        with tr.span("device_dispatch", width=1, has_prefill=False,
                     loop_k=k_burst):
            host = self.runner.decode_burst(
                sampled, K, self.pool.tables(), tok0, lens0, alive0, budget,
                stops, stop_len, hist0, keys, temp, top_k, top_p, k_burst)
        finished: List[int] = []
        with tr.span("sample_sync", rows=len(rows),
                     reconciles_tick=getattr(tr, "n_ticks", 0)):
            with tr.device_wait(host.clock):
                em_np, lp_np, n_dev = host.wait()
        iters_dev = int(n_dev.max()) if rows else 0
        self._loop_device_ticks += iters_dev
        self._async_stats["loop_bursts"] += 1
        self._async_stats["loop_device_ticks"] += iters_dev
        tr.tick_attrs(device_ticks=max(iters_dev, 1))
        with tr.span("postprocess"):
            committed: Dict[int, int] = {}
            for e in rows:
                s = e.slot
                n = 0
                alive = True
                for j in range(int(n_dev[s])):
                    t = int(em_np[s, j])
                    if t < 0:
                        break
                    alive = self._commit_emitted(e, t, float(lp_np[s, j]),
                                                 finished)
                    e.ctx_len += 1
                    n += 1
                    if alive and e.ctx_len + 1 > scfg.max_seq:
                        self._finish(e, finished)
                        alive = False
                    if not alive:
                        break                  # overrun tokens dropped
                committed[s] = n
                self._draw_ctr[e.req.rid] = ctr0[s] + n
                if alive:
                    # return unused burst blocks so pool pressure matches
                    # the synchronous engine's one-token-at-a-time walk
                    self.pool.truncate(e.slot, e.ctx_len)
            # replay the synchronous engine's per-tick decode metrics:
            # burst iteration j had exactly the rows with > j commits
            # live, reading their (lens0 + j)-token contexts
            for j in range(max(committed.values(), default=0)):
                live = [e for e in rows if committed[e.slot] > j]
                kv = sum(int(lens0[e.slot]) + j for e in live) \
                    * self._kv_per_tok
                self.metrics.on_decode_step(len(live), kv_bytes=kv)
        return finished

    @property
    def device_ticks(self) -> int:
        """Device decode, verify and prefill steps dispatched: the
        runner's steps plus the iterations of device-resident bursts."""
        r = getattr(self, "runner", None)
        return ((r.n_steps if r is not None else 0)
                + self._loop_device_ticks)

    def async_stats(self) -> dict:
        """Tick-flavor counters plus ``overlap_frac``: the fraction of
        device steps whose host bookkeeping overlapped device execution
        (overlap ticks and every iteration of a loop burst)."""
        total = self.device_ticks
        overlapped = (self._async_stats["overlap_ticks"]
                      + self._async_stats["loop_device_ticks"])
        return dict(self._async_stats, device_ticks=total,
                    overlap_frac=overlapped / total if total else 0.0)

    # ------------------------------------------------------------------
    # disaggregated prefill/decode handoff seam (serve.disagg)
    #
    # Lifecycle, driven by the DisaggCoordinator:
    #   prefill engine:  submit_prefill -> [chunked prefill ticks] ->
    #                    park at State.HANDOFF (slot pinned, blocks held)
    #   coordinator:     export_handoff -> decode.adopt_handoff ->
    #                    release_handoff
    # A parked entry stays preemptable: eviction resets it to WAITING,
    # export_handoff returns None, and the replayed prefill parks it again;
    # the coordinator retries on a later tick.

    def submit_prefill(self, req: Request) -> bool:
        """Admit ``req`` for PREFILL ONLY: it runs chunked prefill here,
        emits its first token, then parks at State.HANDOFF for a decode
        engine to adopt (paged mode only)."""
        if not self.scfg.paged:
            raise ValueError("disagg handoff requires the paged engine")
        if self.spec is not None:
            raise ValueError(
                "disagg prefill engines must not speculate: drafting and "
                "verify are decode work (they run on the adopter)")
        self._handoff_rids.add(req.rid)
        if not self.add_request(req):
            self._handoff_rids.discard(req.rid)
            return False
        return True

    def _park_handoff(self, e: SchedEntry) -> None:
        e.state = State.HANDOFF
        # pin: the exported block ids must stay put until the importer has
        # copied them; defrag treats pinned slots' blocks as immovable
        self.pool.pin(e.slot)
        self.tracer.event(e.req.rid, "handoff_ready", ctx_len=e.ctx_len,
                          n_blocks=len(self.pool.owned.get(e.slot, ())))

    def handoff_ready(self) -> List[int]:
        """rids parked at State.HANDOFF, ready for export_handoff."""
        return sorted(rid for rid, e in self.sched.active.items()
                      if e.state is State.HANDOFF)

    def export_handoff(self, rid: int) -> Optional[HandoffPacket]:
        """Snapshot a parked request for adoption. None when ``rid`` is not
        (or no longer: preempted mid-handoff) parked; the entry parks
        again after its replay, retry then."""
        self.flush_async()    # the exported draw_ctr/ctx must be committed
        e = self.sched.active.get(rid)
        if e is None or e.state is not State.HANDOFF:
            return None
        return HandoffPacket(req=e.req, ctx_len=e.ctx_len,
                             blocks=self.pool.export_blocks(e.slot),
                             draw_ctr=self._draw_ctr.get(rid, 0),
                             metrics=self.metrics.requests.get(rid))

    def release_handoff(self, rid: int) -> None:
        """Drop a parked request after a decode engine adopted it: free
        the slot and its block references (the prompt's full blocks stay
        in THIS engine's prefix index, indexed at prefill completion, so
        same-prefix arrivals still skip their cached chunks). The Request
        lives on, owned by the adopter: neither ``req.done`` nor the
        finish-side metrics are touched here."""
        e = self.sched.active.get(rid)
        if e is None or e.state is not State.HANDOFF:
            raise RuntimeError(f"release_handoff({rid}): not parked")
        self.pool.unpin(e.slot)
        self.pool.free_slot(e.slot)
        self.sched.slots.release(rid)
        del self.sched.active[rid]
        e.state = State.DONE
        e.slot = None
        self._requests.pop(rid, None)
        self.metrics.requests.pop(rid, None)   # the record moved with it
        self._draw_ctr.pop(rid, None)
        self._handoff_rids.discard(rid)
        self.tracer.event(rid, "handoff_release")

    def adopt_handoff(self, packet: HandoffPacket, src_runner) -> bool:
        """Adopt a prefilled request from another engine: allocate fresh
        private blocks here, copy the source blocks' KV into them
        (``ModelRunner.import_blocks_from``: bit for bit, int8 scales
        included) and register the request as a RUNNING decode row whose
        next step feeds tokens_out[-1] at position ctx_len, the state a
        single engine is in after the prefill completes. All-or-nothing:
        False (state unchanged) when no slot or not enough blocks are
        free; the source stays parked, retry after capacity frees."""
        req = packet.req
        rid = req.rid
        self.flush_async()    # the adopter's pool state must be committed
        if rid in self.sched.active or not self.sched.slots.free:
            return False
        slot = self.sched.slots.alloc(rid)
        dst = self.pool.import_blocks(slot, packet.ctx_len)
        if dst is None:
            self.pool.free_slot(slot)
            self.sched.slots.release(rid)
            return False
        self.runner.import_blocks_from(src_runner, packet.blocks, dst)
        e = SchedEntry(req=req, seq=self.sched._seq, state=State.RUNNING,
                       slot=slot, pos=packet.ctx_len,
                       ctx_len=packet.ctx_len)
        self.sched._seq += 1
        self.sched.active[rid] = e
        self._requests[rid] = req
        self._draw_ctr[rid] = packet.draw_ctr
        self._seed_presence(slot, req)
        m = packet.metrics
        if m is None:
            # the source collector no longer tracks it (reset or
            # forgotten): make a record so the finish-side accounting lands
            self.metrics.on_arrival(rid,
                                    len(np.asarray(req.prompt).reshape(-1)))
            if req.tokens_out:
                self.metrics.on_first_token(rid)
                self.metrics.requests[rid].n_generated = len(req.tokens_out)
        else:
            self.metrics.requests[rid] = m
        # move the matched-prefix ownership: index the handed-off context
        # in THIS engine's radix tree, so decode-side multi-turn traffic and
        # same-prefix adoptions reuse the imported blocks. Indexed full
        # blocks below ctx_len are never written again (writes land past
        # the frontier; copy-on-write guards the partial tail).
        prompt = np.asarray(req.prompt).reshape(-1)
        gen = np.asarray(req.tokens_out[:-1] if req.tokens_out else [],
                         prompt.dtype)
        self.sched.index_prefix(e, np.concatenate([prompt, gen]),
                                packet.ctx_len)
        self.tracer.event(rid, "handoff_adopt", slot=slot,
                          n_blocks=len(dst), ctx_len=packet.ctx_len)
        return True

    # ------------------------------------------------------------------
    # legacy fixed-slot mode

    def _init_slots(self) -> None:
        scfg = self.scfg
        self.alloc = kv_cache.SlotAllocator(scfg.max_batch)
        self.cache = self.model.init_cache(scfg.max_batch, scfg.max_seq,
                                           device=self.device)
        self._active: Dict[int, Request] = {}
        self._done_at_admit: List[int] = []    # finished during prefill
        self._host_rngs: Dict[int, np.random.Generator] = {}

    def _finish_slot(self, req: Request) -> None:
        req.done = True
        self.alloc.release(req.rid)
        self._active.pop(req.rid, None)
        self._host_rngs.pop(req.rid, None)
        self.metrics.on_finish(req.rid)
        self.tracer.event(req.rid, "finish", n_tokens=len(req.tokens_out))

    def _add_request_slots(self, req: Request) -> bool:
        # a prompt length the prefill refuses raises before any state
        # changes; a codebook model's prompt is [L, nc]
        prompt = np.asarray(req.prompt, np.int32)
        if not self.cfg.n_codebooks:
            prompt = prompt.reshape(-1)
        self.model.check_prompt_len(len(prompt))
        slot = self.alloc.alloc(req.rid)
        if slot is None:
            return False
        self._requests[req.rid] = req
        self._active[req.rid] = req
        self.metrics.on_arrival(req.rid, len(prompt))
        self.tracer.event(req.rid, "arrival", prompt_len=len(prompt))
        self.tracer.event(req.rid, "admitted", slot=slot)
        # prefill into a batch-1 cache, then splice that row into the live
        # cache at ``slot`` (slots advance independently via lens[b])
        tmp = self.model.init_cache(1, len(prompt), device=self.device)
        with torch.no_grad():
            logits, tmp = self.model.prefill(
                self.params, torch.tensor(prompt[None], device=self.device),
                tmp)
        self.model.merge_slot(self.cache, tmp, slot, len(prompt))
        self._seed_presence(slot, req)
        if self.cfg.n_codebooks:
            # greedy only: a per-codebook argmax
            tok = logits[0, 0].argmax(dim=-1).to(torch.int32).cpu().numpy()
            lp = 0.0
        else:
            # the first token is drawn on the host, from a per-request
            # numpy generator (the reference's slot engine does the same)
            sp = self._sp(req)
            rng = self._host_rngs.setdefault(
                req.rid, np.random.default_rng(np.random.SeedSequence(
                    entropy=0 if sp.seed is None else sp.seed,
                    spawn_key=(req.rid & 0xFFFFFFFF,))))
            seen = prompt.astype(np.int64) \
                if sp.repetition_penalty != 1.0 else ()
            tok, lp = sampling.sample_np(
                logits[0, 0].float().cpu().numpy(), sp, rng, seen=seen)
        status = self._append_token(req, slot, tok, lp)
        if status != "stop":
            self.metrics.on_first_token(req.rid)
            self.tracer.event(req.rid, "first_token")
        if status != "ok":                     # same checks the paged
            self._finish_slot(req)             # path makes after prefill
            self._done_at_admit.append(req.rid)
        return True

    def _step_slots(self) -> List[int]:
        """One batched decode step across all slots (idle slots decode a
        padding token that nobody reads)."""
        finished = self._done_at_admit
        self._done_at_admit = []
        if not self._active:
            return finished
        tr = self.tracer
        reqs = list(self._active.values())
        slots = {req.rid: self.alloc.active[req.rid] for req in reqs}
        B = self.scfg.max_batch
        with tr.span("batch_assemble"):
            nc = self.cfg.n_codebooks
            tok = np.zeros((B, 1, nc) if nc else (B, 1), np.int32)
            for req in reqs:
                tok[slots[req.rid], 0] = req.tokens_out[-1]
            tr.tick_attrs(rows_prefill=0, rows_decode=len(reqs),
                          rows_verify=0, width=1, valid_tokens=len(reqs),
                          pad_waste_frac=1.0 - len(reqs) / B)
        with tr.span("device_dispatch", rows=len(reqs)):
            clock = tr.device_clock(self.device)
            with torch.no_grad():
                logits, self.cache = self.model.decode_step(
                    self.params, torch.tensor(tok, device=self.device),
                    self.cache)
            if clock is not None:
                clock.stop()
        if clock is not None:
            with tr.device_wait(clock):
                pass
        with tr.span("sample_sync", rows=len(reqs)):
            tok_np, lp_np = self._sample_rows(
                [(slots[req.rid], req) for req in reqs], logits[:, 0])
        done_now = []
        with tr.span("postprocess"):
            for req in reqs:
                slot = slots[req.rid]
                status = self._append_token(
                    req, slot, self._one_token(tok_np, slot), lp_np[slot])
                if status != "stop":
                    self.metrics.on_token(req.rid)
                if status != "ok":
                    self._finish_slot(req)
                    done_now.append(req.rid)
            self.metrics.on_decode_step(len(reqs))
        return finished + done_now
