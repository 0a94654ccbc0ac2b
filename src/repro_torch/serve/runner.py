"""ModelRunner: ONE batched ``step(StepBatch) -> StepOutput`` for serving,
and the async engine's device-resident decode burst.

One call of ``Model.forward_step`` serves chunked-prefill rows and decode
rows in the same fixed-width batch. The per-tick token width is bucketed
as in the reference — {1} for pure decode ticks, the prefill chunk width
and k_max+1 under speculation — so a step's shapes match the reference's
step for the same tick.
The runner owns the device cache; the engine republishes the host-truth
``lens`` and block tables before every step. ``copy_blocks`` (copy-on-write)
and ``apply_perm`` (defrag) mirror the host pool's block moves on every
layer's pool leaves, int8 scales included, and ``import_blocks_from``
copies a disagg handoff's blocks in from another runner's pools.

Host arrays reach the device through pinned host buffers, packed into one
buffer and moved by one ``non_blocking`` copy a call (``_stage``): the
host never waits for the stream to drain. PyTorch's caching host
allocator keeps a pinned block until the copy that reads it has run, so a
buffer is never refilled while its copy is still queued.

The async engine's ticks (``decode_burst`` and ``graph_step``) run one
decode iteration (``transformer.decode_iteration``) over static tensors.
On a CUDA device that iteration is captured once per (sampled, k_max) as
a ``torch.cuda.CUDAGraph`` and replayed: one launch of the graph stands
for the hundreds of small launches of an eager step, as one jitted
dispatch does in the reference. On the CPU the same iteration runs
eagerly.

Sharded serving (``mesh`` + ``policy``): the runner is the mesh-aware
boundary. Weights are placed per ``dist.sharding.params_shardings`` and
the block pool per ``cache_shardings(paged=True)``: its KV-head axis
splits over 'model', each shard's slice a slab of its own (with trash
blocks behind it) on its device. ``step`` runs ``forward_step`` under
the activation-sharding scope. Everything above (engine, scheduler,
paged_kv, prefix cache) sees the same host-side world as on one device:
block ids, refcounts, COW pairs and tables are global, only the device
bytes behind them are partitioned, so ``copy_blocks``, ``apply_perm`` and
``import_blocks_from`` act on every shard's slice alike. A mesh runner
runs its async ticks eagerly (no CUDA graph) and has no decode bursts.

The engine's tracer (``tracer``, repro_torch.obs) times the runner's
host work by phase: an eager ``step`` in ``device_dispatch``, the graph
work of ``decode_burst`` and ``graph_step`` in ``graph_dispatch``. Nothing
here waits for the device. With tracing on a ``DeviceClock`` also times
each step's device work: on a CUDA device a pair of timing events on the
stream around the step's launches (around the replays, never inside a
capture), which the tracer reads once the engine's own waits have passed
them; with tracing off no event is made.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ServeConfig
from repro_torch.dist import sharding as shd
from repro_torch.kernels import build
from repro_torch.models import transformer
from repro_torch.obs.trace import CountingTracer
from repro_torch.serve import sampling

# row phases (StepBatch.phase values)
IDLE, PREFILL, DECODE, VERIFY = 0, 1, 2, 3

BACKENDS = ("naive", "flash")

# device-side stop-sequence bounds for the async decode burst: stops up
# to STOP_L tokens, STOP_NS per request, get on-device early exit;
# longer or extra stops still match on the host at replay (identity is
# unaffected: the device match only trims overrun compute)
STOP_L = 4
STOP_NS = 2

_NUMPY = {torch.int32: np.int32, torch.int64: np.int64,
          torch.float32: np.float32, torch.bool: np.bool_}


class _Layout:
    """Named arrays packed into one byte buffer, each at a 16-byte aligned
    offset: one host->device copy moves them all, and each is a typed view
    of the device buffer. ``fields`` is (name, dtype, shape) each."""

    def __init__(self, fields: Sequence[Tuple[str, torch.dtype, tuple]]):
        self.fields: Dict[str, tuple] = {}
        off = 0
        for name, dtype, shape in fields:
            n = int(np.prod(shape, dtype=np.int64)) \
                * torch.empty((), dtype=dtype).element_size()
            self.fields[name] = (off, n, dtype, tuple(shape))
            off += -(-n // 16) * 16
        self.nbytes = off

    def views(self, buf: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {name: buf[off:off + n].view(dtype).view(shape)
                for name, (off, n, dtype, shape) in self.fields.items()}

    def pack(self, buf: np.ndarray, arrays: Dict[str, np.ndarray]) -> None:
        for name, a in arrays.items():
            off, n, dtype, shape = self.fields[name]
            buf[off:off + n].view(_NUMPY[dtype]).reshape(shape)[...] = a


class HostCopy:
    """Device tensors on their way to the host: the copies are queued on
    the stream when this is made, and ``wait`` blocks until they landed
    (on a CUDA device the one host wait of an async tick)."""

    def __init__(self, host: List[torch.Tensor], event=None):
        self._host, self._event = host, event

    def wait(self) -> List[np.ndarray]:
        if self._event is not None:
            self._event.synchronize()
        return [h.numpy() for h in self._host]


@dataclasses.dataclass
class _Burst:
    """The static tensors of one (sampled, k_max) decode iteration: the
    inputs and outputs in one device byte buffer (``layout``, ``buf``) and
    their views, and the pools (``state``); its
    sampler; on a CUDA device its captured graph and the kernel launches
    one replay makes (``tally``)."""
    layout: _Layout
    buf: torch.Tensor
    state: dict
    sample_fn: object
    graph: Optional[object] = None
    tally: Optional[Dict[str, int]] = None


@dataclasses.dataclass
class StepBatch:
    """Host-side description of one step: tokens i32[B, S] (i32[B, S, nc]
    for a codebook model; row b's valid tokens occupy [0, n_valid[b])),
    the absolute position of each row's
    first token (``row_start``), the row phase and the block tables.
    PREFILL rows use the dense FFN, DECODE and VERIFY (K+1 speculative)
    rows the sparse one, IDLE rows are masked out (sentinel tables,
    garbage logits)."""

    tokens: np.ndarray
    row_start: np.ndarray
    n_valid: np.ndarray
    phase: np.ndarray
    tables: np.ndarray

    @classmethod
    def empty(cls, max_batch: int, width: int, tables: np.ndarray,
              n_codebooks: int = 0) -> "StepBatch":
        shape = (max_batch, width, n_codebooks) if n_codebooks \
            else (max_batch, width)
        return cls(tokens=np.zeros(shape, np.int32),
                   row_start=np.zeros((max_batch,), np.int32),
                   n_valid=np.zeros((max_batch,), np.int32),
                   phase=np.full((max_batch,), IDLE, np.int32),
                   tables=np.array(tables, np.int32))

    def add_row(self, slot: int, phase: int, tokens, start: int) -> None:
        toks = np.asarray(tokens, np.int32)
        self.tokens[slot, :len(toks)] = toks
        self.row_start[slot] = start
        self.n_valid[slot] = len(toks)
        self.phase[slot] = phase

    def live_keys(self, block_size: int) -> int:
        """Keys the paged-attention kernel reads for this step: each live
        row's ``row_start + n_valid``, rounded up to whole blocks."""
        live = self.n_valid > 0
        ends = self.row_start[live].astype(np.int64) + self.n_valid[live]
        return int((-(-ends // block_size) * block_size).sum())


@dataclasses.dataclass
class StepOutput:
    """Device results of one step: ``logits[b, j]`` is the distribution of
    the token following tokens[b, j]; ``last_logits[b]`` is row b's logits
    at its last valid position. ``row_logits`` copies one row to the host
    on first use (prompt log-probabilities need every position)."""

    logits: torch.Tensor         # f32[B, S, V] ([B, S, nc, V] codebooks)
    last_logits: torch.Tensor    # f32[B, V] ([B, nc, V] codebooks)
    _rows: Dict[int, np.ndarray] = dataclasses.field(default_factory=dict)

    def row_logits(self, slot: int) -> np.ndarray:
        row = self._rows.get(slot)
        if row is None:
            row = self._rows[slot] = self.logits[slot].float().cpu().numpy()
        return row



def _pool_leaves(cache: dict) -> Dict[str, torch.Tensor]:
    """Every block pool leaf of a paged cache, "b{j}/name" -> [n_units,
    n_blocks, ...] (a tensor, or ``Sharded`` on the KV-head axis): each
    block position of the pattern unit has its own pools (an attention
    block and an MoE block in llama4-maverick's)."""
    return {f"{pos}/{name}": leaf for pos, pools in cache["units"].items()
            for name, leaf in pools.items()}


def _pool_tensors(leaf) -> Tuple[torch.Tensor, ...]:
    """The tensors behind a pool leaf: its shards, or the leaf itself."""
    return leaf.shards if isinstance(leaf, shd.Sharded) else (leaf,)


def _head_rows(leaf, idx: torch.Tensor, home: torch.device) -> torch.Tensor:
    """Storage rows ``idx`` of pool leaf ``leaf`` ([U, n, bs, Kv, ...]),
    every KV head, on ``home``: a sharded leaf's head slices
    concatenated."""
    return torch.cat([t[:, idx.to(t.device)].to(home)
                      for t in _pool_tensors(leaf)], dim=3)


def _set_head_rows(leaf, idx: torch.Tensor, rows: torch.Tensor) -> None:
    """Write ``rows`` (every KV head) into storage rows ``idx`` of
    ``leaf``, each shard its head slice."""
    h0 = 0
    for t in _pool_tensors(leaf):
        h = t.shape[3]
        t[:, idx.to(t.device)] = rows[:, :, :, h0:h0 + h].to(t.device,
                                                             t.dtype)
        h0 += h

class ModelRunner:
    """Owns the device-side paged cache; the engine builds a StepBatch
    per tick and calls ``step``, and its async ticks call ``graph_step``
    and ``decode_burst``."""

    def __init__(self, model, params: dict, scfg: ServeConfig,
                 device: torch.device, dtype: torch.dtype = torch.float32,
                 tracer=None, mesh=None, policy=None):
        """``mesh``/``policy`` (a launch.mesh.Mesh and a
        dist.sharding.ShardingPolicy) turn on sharded serving: the params
        and the block pool are placed on the mesh here, and ``device`` is
        its home device. Single-device serving passes neither."""
        if scfg.attn_backend not in BACKENDS:
            raise ValueError(f"unknown attn_backend "
                             f"{scfg.attn_backend!r}; known: {BACKENDS}")
        if scfg.attn_backend == "flash" and scfg.kv_quant:
            raise ValueError(
                "attn_backend='flash' reads fp block pools; int8 KV "
                "(kv_quant) needs the naive dequantizing gather")
        if mesh is not None and scfg.attn_backend != "naive":
            raise ValueError(
                "sharded serving (ServeConfig.mesh) needs the shardable "
                "attn_backend='naive' read path; the paged-attention "
                "kernel addresses one device's pool")
        self.model = model
        self.cfg = model.cfg
        self.scfg = scfg
        self.mesh = mesh
        self.policy = policy if policy is not None else shd.ShardingPolicy()
        self.device = device if mesh is None else mesh.home
        self.params = params if mesh is None else shd.shard_tree(
            params, shd.params_shardings(params, self.cfg, mesh,
                                         self.policy), mesh)
        self.tracer = tracer if tracer is not None else CountingTracer()
        self.buckets = sorted({1, scfg.prefill_chunk}
                              | ({scfg.spec.k_max + 1}
                                 if scfg.spec is not None else set()))
        self.cache = self._init_cache(model, dtype)
        self.n_steps = 0            # device steps dispatched (async
        #                             engines add burst iterations on top)
        self._layouts: Dict[int, _Layout] = {}
        self._bursts: Dict[Tuple[bool, int], _Burst] = {}
        self.graph_captures = 0
        self.graph_replays = 0
        acfg = scfg.async_cfg
        if acfg is not None and acfg.enabled and self.device.type == "cuda" \
                and mesh is None and not self.cfg.n_codebooks:
            # capture both graphs now, so their warm-up launches happen
            # before the engine serves (a codebook model's ticks are all
            # synchronous: the engine's async gate refuses them)
            for sampled in (False, True):
                self._burst(sampled, acfg.max_device_ticks)

    def _init_cache(self, model, dtype: torch.dtype) -> dict:
        """The paged cache on the device, or under a mesh placed per
        ``cache_shardings(paged=True)``: a KV-head-sharded pool is made
        shard by shard (each shard's slice a slab with its trash blocks,
        on its device); lens and tables stay on the home device."""
        scfg = self.scfg
        args = (scfg.max_batch, scfg.pool_blocks, scfg.block_size,
                scfg.blocks_per_seq)
        kw = dict(dtype=dtype, int8_kv=scfg.kv_quant,
                  max_width=max(self.buckets))
        mesh = self.mesh
        if mesh is None:
            return model.init_paged_cache(*args, device=self.device, **kw)
        fn = shd.cache_shardings(self.cfg, mesh, scfg.max_batch,
                                 policy=self.policy, paged=True)
        specs = shd.map_with_path(fn, model.init_paged_cache(
            *args, device="meta", **kw))
        head_sharded = any(shd.MODEL_AXIS in spec
                           for pools in specs["units"].values()
                           for spec in pools.values())
        if not head_sharded:
            return model.init_paged_cache(*args, device=self.device, **kw)
        n = mesh.size
        parts = [model.init_paged_cache(
            *args, device=dev, kv_heads=self.cfg.n_kv_heads // n, **kw)
            for dev in mesh.devices]
        cache = parts[0]
        cache["units"] = {pos: {name: shd.Sharded(
            [p["units"][pos][name] for p in parts], specs["units"][pos][name],
            leaf.shape[:3] + (self.cfg.n_kv_heads,) + leaf.shape[4:], mesh)
            for name, leaf in pools.items()}
            for pos, pools in parts[0]["units"].items()}
        return cache

    def check_cache_layout(self) -> None:
        """Under a mesh, every shard of every pool leaf stays on its
        device at its slice's shape (the reference re-pins its sharding
        after an eager block op; here the ops write in place, so this
        checks that nothing rebound a shard)."""
        if self.mesh is None:
            return
        for name, leaf in _pool_leaves(self.cache).items():
            if not isinstance(leaf, shd.Sharded):
                continue
            for i, t in enumerate(leaf.shards):
                want = tuple(s.stop - s.start for s in leaf.slices(i))
                if t.device != self.mesh.devices[i] or tuple(t.shape) != want:
                    raise AssertionError(
                        f"pool leaf {name} shard {i}: {tuple(t.shape)} on "
                        f"{t.device}, want {want} on {self.mesh.devices[i]}")

    def _scope(self):
        """The activation-sharding scope of a mesh runner's steps."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return shd.activation_sharding_scope(self.mesh, self.policy)

    def width_for(self, max_valid: int) -> int:
        """Smallest bucket covering ``max_valid`` tokens per row."""
        for b in self.buckets:
            if b >= max_valid:
                return b
        self.buckets.append(max_valid)
        self.buckets.sort()
        return max_valid

    def new_batch(self, max_valid: int, tables: np.ndarray) -> StepBatch:
        return StepBatch.empty(self.scfg.max_batch,
                               self.width_for(max_valid), tables,
                               n_codebooks=self.cfg.n_codebooks)

    # --- host -> device ---------------------------------------------------
    def _stage(self, layout: _Layout, arrays: Dict[str, np.ndarray],
               dst: Optional[torch.Tensor] = None
               ) -> Dict[str, torch.Tensor]:
        """Pack ``arrays`` into one host buffer and move it to the device
        with one copy that does not block the host (into ``dst``, a
        device byte buffer of ``layout``, where given); returns the typed
        views. On a CUDA device the host buffer is pinned; PyTorch's
        caching host allocator does not hand it out again before the copy
        that reads it has run."""
        pinned = self.device.type == "cuda"
        host = torch.empty(layout.nbytes, dtype=torch.uint8,
                           pin_memory=pinned)
        layout.pack(host.numpy(), arrays)
        if dst is None:
            if not pinned:
                return layout.views(host)
            dst = torch.empty(layout.nbytes, dtype=torch.uint8,
                              device=self.device)
        dst.copy_(host, non_blocking=True)
        return layout.views(dst)

    def _to_host(self, *tensors: torch.Tensor) -> HostCopy:
        """Queue copies of ``tensors`` to the host (pinned buffers, on the
        current stream) and return without waiting."""
        if self.device.type != "cuda":
            return HostCopy([t.clone() for t in tensors])
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for t in tensors]
        for h, t in zip(host, tensors):
            h.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return HostCopy(host, event)

    def _step_layout(self, width: int) -> _Layout:
        lay = self._layouts.get(width)
        if lay is None:
            B, MB = self.scfg.max_batch, self.scfg.blocks_per_seq
            nc = self.cfg.n_codebooks
            lay = self._layouts[width] = _Layout((
                ("lens", torch.int32, (B,)),
                ("tables", torch.int32, (B, MB)),
                ("n_valid", torch.int32, (B,)),
                ("tokens", torch.int32, (B, width, nc) if nc else (B, width)),
                ("is_prefill", torch.bool, (B,))))
        return lay

    # --- the one step -------------------------------------------------------
    def step(self, batch: StepBatch) -> StepOutput:
        """Republish host-truth lens/tables, run the step, return the
        per-position and the last-valid logits, without waiting for the
        device. The host's issue runs in the ``device_dispatch`` phase;
        under tracing a DeviceClock times the step's device work. (The
        reference's device ``tokens`` override comes with its first
        caller, ROADMAP queue 1 item 5: the overlap tick here chains its
        token in ``graph_step``.)"""
        width = batch.tokens.shape[1]
        has_prefill = bool(np.any(batch.phase == PREFILL))
        tr = self.tracer
        with tr.span("device_dispatch", width=width,
                     has_prefill=has_prefill):
            clock = tr.device_clock(self.device)
            t = self._stage(self._step_layout(width), {
                "lens": batch.row_start, "tables": batch.tables,
                "n_valid": batch.n_valid, "tokens": batch.tokens,
                "is_prefill": batch.phase == PREFILL})
            self.cache["lens"] = t["lens"]
            self.cache["block_tables"] = t["tables"]
            n_valid = t["n_valid"]
            with torch.no_grad(), self._scope():
                logits = self.model.forward_step(
                    self.params, t["tokens"], self.cache, n_valid,
                    t["is_prefill"], self.scfg.block_size,
                    backend=self.scfg.attn_backend, has_prefill=has_prefill)
                idx = (n_valid.long() - 1).clamp(0, logits.shape[1] - 1)
                last = logits[torch.arange(logits.shape[0],
                                           device=self.device), idx]
            if clock is not None:
                clock.stop()
            self.n_steps += 1
        return StepOutput(logits=logits, last_logits=last)

    # --- the async engine's decode iteration -----------------------------
    def _burst(self, sampled: bool, k_max: int) -> _Burst:
        """The static tensors of the (sampled, k_max) decode iteration,
        made at first use; on a CUDA device the iteration's graph is
        captured then."""
        key = (sampled, k_max)
        st = self._bursts.get(key)
        if st is not None:
            return st
        B, MB = self.scfg.max_batch, self.scfg.blocks_per_seq
        i32, f32 = torch.int32, torch.float32
        layout = _Layout((
            ("tables", i32, (B, MB)), ("tok", i32, (B,)),
            ("lens", i32, (B,)), ("alive", i32, (B,)),
            ("budget", i32, (B,)), ("stops", i32, (B, STOP_NS, STOP_L)),
            ("stop_len", i32, (B, STOP_NS)), ("hist", i32, (B, STOP_L)),
            ("keys", torch.int64, (k_max, B, 2)), ("temp", f32, (B,)),
            ("top_k", i32, (B,)), ("top_p", f32, (B,)),
            ("chain", torch.bool, (B,)),
            ("emitted", i32, (B, k_max)), ("lp", f32, (B, k_max)),
            ("n_emit", i32, (B,)), ("i", i32, ())))
        buf = torch.zeros(layout.nbytes, dtype=torch.uint8,
                          device=self.device)
        state = layout.views(buf)
        state["units"] = self.cache["units"]
        state["trash_rows"] = self.cache["trash_rows"]
        sampler = sampling.Sampler()
        if sampled:
            # repetition-penalty rows never reach the async ticks (they
            # need the host token stream): no presence, no penalty
            no_presence = torch.zeros((B, 1), dtype=torch.bool,
                                      device=self.device)
            no_rep = torch.ones(B, dtype=f32, device=self.device)

            def sample_fn(last, i):
                keys = state["keys"].index_select(0, i.view(1))[0]
                return sampler.device_call(
                    last, no_presence, state["temp"], state["top_k"],
                    state["top_p"], no_rep, keys, greedy_only=False)
        else:
            def sample_fn(last, i):
                return sampler.device_call(last, None, None, None, None,
                                           None, None, greedy_only=True)
        st = self._bursts[key] = _Burst(layout, buf, state, sample_fn)
        if self.device.type == "cuda" and self.mesh is None:
            self._capture(st)
        return st

    def _iteration(self, st: _Burst) -> None:
        with torch.no_grad(), self._scope():
            transformer.decode_iteration(
                self.params, self.cfg, st.state, st.sample_fn,
                self.scfg.block_size, self.scfg.attn_backend)

    def _capture(self, st: _Burst) -> None:
        """Capture ``st``'s decode iteration as a CUDA graph. A warm-up
        iteration runs first on a side stream, with every row dead (the
        zeroed state: nothing but the trash blocks is written), so that the
        first cuBLAS call, the kernels' build and load and their first
        launch happen outside the capture. A failed capture raises.
        Captures take turns (``build.CAPTURE_LOCK``) and check only this
        thread's calls (``capture_error_mode="thread_local"``): another
        thread may go on launching on the device's default stream
        meanwhile (a fleet router polling its replicas in parallel)."""
        with build.CAPTURE_LOCK:
            cur = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                self._iteration(st)
            cur.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with build.capturing() as tally, torch.cuda.graph(
                    graph, capture_error_mode="thread_local"):
                self._iteration(st)
        st.graph, st.tally = graph, tally
        self.graph_captures += 1

    def _iterate(self, st: _Burst, n: int) -> None:
        """``n`` decode iterations on ``st``: replays of its graph back to
        back on a CUDA device (each counts the launches it makes), eager
        iterations on the CPU; under tracing, one DeviceClock around
        them."""
        clock = self.tracer.device_clock(self.device)
        if st.graph is None:
            for _ in range(n):
                self._iteration(st)
        else:
            for _ in range(n):
                st.graph.replay()
            build.add_replay(st.tally, n)
            self.graph_replays += n
        if clock is not None:
            clock.stop()

    def _stage_burst(self, st: _Burst, tables: np.ndarray, tok0, lens0,
                     alive0, budget, stops, stop_len, hist0, keys, temp,
                     top_k, top_p, chain=None) -> None:
        B, k_max = st.state["emitted"].shape
        self._stage(st.layout, {
            "tables": tables, "tok": tok0, "lens": lens0, "alive": alive0,
            "budget": budget, "stops": stops, "stop_len": stop_len,
            "hist": hist0, "keys": keys, "temp": temp, "top_k": top_k,
            "top_p": top_p,
            "chain": np.zeros(B, bool) if chain is None else chain,
            "emitted": np.full((B, k_max), -1, np.int32),
            "lp": np.zeros((B, k_max), np.float32),
            "n_emit": np.zeros(B, np.int32), "i": np.zeros((), np.int32)},
            dst=st.buf)

    def decode_burst(self, sampled: bool, k_max: int, tables: np.ndarray,
                     tok0, lens0, alive0, budget, stops, stop_len, hist0,
                     keys, temp, top_k, top_p, k_burst: int) -> HostCopy:
        """A device-resident burst of ``k_burst`` <= ``k_max`` decode
        iterations (``transformer.decode_iteration``; the arguments are
        ``transformer.decode_burst``'s, as host arrays, plus the sampling
        inputs: keys i64[k_max, B, 2] (the uint32 words of each draw's
        key), temp/top_p f32[B], top_k i32[B]). The inputs go to the
        device in one copy; on a CUDA device the captured iteration is
        replayed ``k_burst`` times back to back, with no host wait between
        replays (an iteration after every row is dead changes nothing).
        Returns the host copy, in flight, of (emitted i32[B, k_max], lp
        f32[B, k_max], n_emit i32[B]). The host's work runs in the
        ``graph_dispatch`` phase."""
        assert self.mesh is None, \
            "decode_burst is single-device (the async engine keeps loop " \
            "mode off under ServeConfig.mesh)"
        with self.tracer.span("graph_dispatch", width=1, has_prefill=False,
                              loop_k=k_burst):
            st = self._burst(sampled, k_max)
            self._stage_burst(st, tables, tok0, lens0, alive0, budget, stops,
                              stop_len, hist0, keys, temp, top_k, top_p)
            self._iterate(st, k_burst)
            return self._to_host(st.state["emitted"], st.state["lp"],
                                 st.state["n_emit"])

    def graph_step(self, batch: StepBatch, sampled: bool, keys, temp,
                   top_k, top_p, chain: Optional[np.ndarray] = None,
                   pending: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, HostCopy]:
        """The overlap tick's step: one decode iteration (the k_max-1
        state of ``decode_burst``, one graph replay on a CUDA device) over
        the DECODE rows of ``batch`` (width 1), sampled on the device.
        Rows set in ``chain`` take their input token from ``pending``, the
        previous tick's sampled tokens still on the device, instead of
        ``batch.tokens``. Counts one runner step, as ``step`` does. Returns
        (tokens i32[B], logprobs f32[B]) on the device and their host copy
        in flight; nothing here waits for the device. The host's work runs
        in the ``graph_dispatch`` phase."""
        with self.tracer.span("graph_dispatch", width=1, has_prefill=False):
            st = self._burst(sampled, 1)
            B = self.scfg.max_batch
            alive = (batch.n_valid > 0).astype(np.int32)
            self._stage_burst(
                st, batch.tables, batch.tokens[:, 0], batch.row_start,
                alive, alive, np.full((B, STOP_NS, STOP_L), -1, np.int32),
                np.zeros((B, STOP_NS), np.int32),
                np.full((B, STOP_L), -1, np.int32), np.asarray(keys)[None],
                temp, top_k, top_p, chain=chain)
            if pending is not None:
                tok = st.state["tok"]
                tok.copy_(torch.where(st.state["chain"], pending, tok))
            self._iterate(st, 1)
            self.n_steps += 1
            tok = st.state["emitted"][:, 0].clone()
            lp = st.state["lp"][:, 0].clone()
            return tok, lp, self._to_host(tok, lp)

    # --- block maintenance --------------------------------------------------
    def apply_perm(self, perm: np.ndarray) -> None:
        """Apply a pool defrag permutation to the device block pools (new
        storage row i = old row perm[i]), every leaf of every layer."""
        perm = np.asarray(perm, np.int64)
        p = self._stage(_Layout((("perm", torch.int64, perm.shape),)),
                        {"perm": perm})["perm"]
        for leaf in _pool_leaves(self.cache).values():
            for t in _pool_tensors(leaf):
                t.copy_(t.index_select(1, p.to(t.device)))
        self.check_cache_layout()

    def copy_blocks(self, pairs: List[Tuple[int, int]]) -> None:
        """Copy-on-write: duplicate pool storage rows src -> dst across
        every layer's block pools (all leaves, int8 scales included), on
        the current stream, before the step that writes them. The host
        side (paged_kv.cow_for_write) already rewrote the block table;
        this mirrors the bytes so the writer's private copy starts
        bit-identical to the shared original."""
        if not pairs:
            return
        n = len(pairs)
        idx = self._stage(
            _Layout((("src", torch.int64, (n,)), ("dst", torch.int64, (n,)))),
            {"src": [a for a, _ in pairs], "dst": [b for _, b in pairs]})
        for leaf in _pool_leaves(self.cache).values():
            for t in _pool_tensors(leaf):
                t[:, idx["dst"].to(t.device)] = t[:, idx["src"].to(t.device)]
        self.check_cache_layout()

    def import_blocks_from(self, src: "ModelRunner", src_ids: Sequence[int],
                           dst_ids: Sequence[int]) -> None:
        """Disagg KV handoff (serve.disagg): copy storage rows ``src_ids``
        of ``src``'s block pools into rows ``dst_ids`` of this runner's,
        every leaf of every layer (int8 scales included, so quantized KV
        arrives bit for bit), in place and on the current stream. In place
        matters: an async engine's captured decode graph holds this pool's
        addresses, so a rebound pool would be a stale read at the next
        replay. Both ids lie in the pools proper, never in the trash
        blocks behind them. Two meshless runners must be on one device; a
        handoff between runners with different meshes (or one with and
        one without) reslices: the source's rows are gathered over its
        KV heads and cut again for this pool's shards."""
        mine, theirs = _pool_leaves(self.cache), _pool_leaves(src.cache)
        at = [next(iter(pool.values())).device for pool in (theirs, mine)]
        if self.mesh is None and src.mesh is None and at[0] != at[1]:
            raise ValueError(f"import_blocks_from: source pool on {at[0]}, "
                             f"this pool on {at[1]}; both engines must "
                             f"share one device")
        if len(src_ids) != len(dst_ids):
            raise ValueError(f"import_blocks_from: {len(src_ids)} source "
                             f"blocks for {len(dst_ids)} destinations")
        if not len(src_ids):
            return
        if mine.keys() != theirs.keys() or any(
                mine[k].shape[0] != theirs[k].shape[0]
                or mine[k].shape[2:] != theirs[k].shape[2:] for k in mine):
            raise ValueError("import_blocks_from: the two block pools hold "
                             "different leaves or block shapes")
        for ids, pool in ((src_ids, theirs), (dst_ids, mine)):
            n_blocks = next(iter(pool.values())).shape[1]
            if min(ids) < 0 or max(ids) >= n_blocks:
                raise ValueError(f"import_blocks_from: block ids {list(ids)}"
                                 f" outside the pool of {n_blocks} blocks")
        n = len(src_ids)
        idx = self._stage(
            _Layout((("src", torch.int64, (n,)), ("dst", torch.int64, (n,)))),
            {"src": list(src_ids), "dst": list(dst_ids)})
        for name, leaf in mine.items():
            if isinstance(leaf, shd.Sharded) \
                    or isinstance(theirs[name], shd.Sharded):
                _set_head_rows(leaf, idx["dst"], _head_rows(
                    theirs[name], idx["src"], self.device))
            else:
                leaf[:, idx["dst"]] = theirs[name][:, idx["src"]].to(
                    leaf.dtype)
        self.check_cache_layout()
