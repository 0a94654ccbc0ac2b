"""Draft proposers behind one ``Drafter`` protocol.

A drafter sees the full committed token stream of a request (prompt plus
generated so far) and proposes up to k continuation tokens, with their
proposal distributions when it samples (rejection sampling needs them;
None means the proposal is deterministic).

Drafters are host-side objects keyed by request id, outside the target's
step: the scheduler can preempt and replay a request at any time and the
drafter re-syncs from the token stream, so speculative state is never
part of the engine's recoverable state.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Protocol, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import Model, transformer
from repro_torch.serve.metrics import weight_traffic
from repro_torch.serve.sampling import categorical_np, softmax


class Drafter(Protocol):
    def propose(self, rid: int, ctx: np.ndarray, k: int
                ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Propose up to k tokens continuing ``ctx`` (i32[L], prompt +
        generated). Returns (tokens i32[m<=k], qdists f32[m, V] or None
        for deterministic proposals)."""
        ...

    def forget(self, rid: int) -> None:
        """Drop any per-request state (request finished)."""
        ...

    def weight_bytes_per_step(self, scfg) -> float:
        """Off-chip weight bytes one drafter decode step streams (0 for
        model-free drafters), folded into the engine's traffic counters."""
        ...

    # Optional: ``propose_batch(items)`` with items = [(rid, ctx, k)]
    # returning one (tokens, qdists) per item. Drafters that run a model
    # implement it to draft every slot per device step (ModelDrafter
    # below); the engine falls back to per-row propose() otherwise.


# ---------------------------------------------------------------------------
# Prompt-lookup / n-gram drafter (model-free)


class NGramDrafter:
    """Prompt-lookup decoding: if the last n tokens already occurred
    earlier in the stream, propose whatever followed them last time."""

    def __init__(self, n: int = 3):
        self.n = n

    def weight_bytes_per_step(self, scfg) -> float:
        return 0.0                    # table lookup: no weights streamed

    def propose(self, rid: int, ctx: np.ndarray, k: int
                ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        ctx = np.asarray(ctx, np.int32)
        L = len(ctx)
        empty = np.zeros((0,), np.int32)
        if k <= 0 or L < 2:
            return empty, None
        for n in range(min(self.n, L - 1), 0, -1):
            suffix = ctx[L - n:]
            wins = np.lib.stride_tricks.sliding_window_view(ctx, n)
            hits = np.nonzero((wins == suffix).all(axis=1))[0]
            hits = hits[hits < L - n]         # strictly before the suffix
            if hits.size == 0:
                continue
            # prefer the most recent occurrence that still has k tokens of
            # continuation; inside a repeated run the nearest match abuts
            # the suffix and would cap the draft at one token per step
            full = hits[hits + n + k <= L]
            i = int(full[-1]) if full.size else int(hits[0])
            cont = ctx[i + n:i + n + k]
            if cont.size:
                return cont.astype(np.int32), None
        return empty, None

    def forget(self, rid: int) -> None:
        pass


# ---------------------------------------------------------------------------
# Small-model drafter


class ModelDrafter:
    """Draft with a small autoregressive model sharing the target's vocab.

    The draft model decodes ALL in-flight requests per device step: one
    shared [max_batch, max_seq] contiguous cache on ``device``, one slot
    per request, per-row ``lens`` as the rollback cursor (rewinding a row
    is rewinding lens: stale KV past the frontier is masked by attention
    and overwritten by the next write). Rows not fed in a step are parked
    at lens = max_seq: ``attention.attn_decode`` drops their write and
    their logits are ignored, so rows at different catch-up depths batch
    together. Every propose re-syncs each row to its committed stream by
    longest common prefix, so accepted drafts cost nothing to replay.

    A recurrent draft model (zamba2, xLSTM) cannot park a row: its state
    would advance for idle rows and cannot rewind through lens. It drafts
    one request at a time instead (``_propose_seq``), as the reference's
    does, through a batch-1 cache per request.

    Each draft step is ``transformer.decode_step``: the decode-attention
    kernel (``ops.decode_attention``) for attention blocks and, under
    relu_sparse, the gather kernel (``ops.sparse_gather_matvec``).
    ``steps`` counts decode steps, batched or not: the draft weight
    stream is read once per step however many rows ride it."""

    def __init__(self, cfg: ModelConfig, params: dict, max_seq: int,
                 temperature: float = 0.0, seed: int = 0,
                 max_batch: int = 8,
                 device: Optional[Union[str, torch.device]] = None):
        # batched (parked-row) drafting needs attention blocks: parking
        # relies on the dropped KV write
        self._batched = all(b in transformer.KV_KINDS
                            for b in cfg.pattern_unit())
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = params
        self.max_seq = max_seq
        self.max_batch = max_batch
        self.temperature = temperature
        self.seed = seed
        self.model = Model(cfg)
        self._decode = self._make_decode()
        self._cache = None           # shared [max_batch, max_seq] cache
        self._caches: Dict[int, int] = {}   # rid -> slot
        self._free: List[int] = list(range(max_batch))
        self._fed: Dict[int, List[int]] = {}
        self._rngs: Dict[int, np.random.Generator] = {}
        self._seq_caches: Dict[int, dict] = {}   # rid -> batch-1 cache
        self.steps = 0               # decode steps spent drafting

    def _make_decode(self):
        """One drafter decode step: (params, tokens, cache) -> (logits,
        cache)."""
        return self.model.decode_step

    def _slot(self, rid: int, protect=()) -> int:
        """Slot for ``rid``, evicting the least recently proposed OTHER
        request when full, never one in ``protect`` (the rids of the
        propose_batch in flight). Evictees re-sync from their token
        stream on their next propose."""
        slot = self._caches.get(rid)
        if slot is not None:
            self._caches[rid] = self._caches.pop(rid)   # refresh recency
            return slot
        if not self._free:
            victim = next((r for r in self._caches if r not in protect),
                          None)
            if victim is None:
                raise RuntimeError(
                    f"draft cache: {len(protect)} live rows exceed "
                    f"max_batch={self.max_batch}")
            self.forget(victim)
        slot = self._free.pop(0)
        self._caches[rid] = slot
        self._fed[rid] = []
        return slot

    def _step(self, tok: np.ndarray, lens: np.ndarray) -> np.ndarray:
        """One BATCHED draft decode step. Rows with lens == max_seq are
        parked: their KV write drops and their logits row is garbage the
        caller ignores."""
        if self._cache is None:
            self._cache = self.model.init_cache(self.max_batch, self.max_seq,
                                                device=self.device)
        self._cache["lens"] = torch.tensor(lens, dtype=torch.int32,
                                           device=self.device)
        with torch.no_grad():
            logits, self._cache = self._decode(
                self.params, torch.tensor(tok, device=self.device),
                self._cache)
        self.steps += 1
        return logits[:, 0].float().cpu().numpy()

    def _rng_for(self, rid: int) -> np.random.Generator:
        """Per-request RNG, so a row's sample stream does not depend on
        the batch's composition."""
        rng = self._rngs.get(rid)
        if rng is None:
            rng = self._rngs[rid] = np.random.default_rng(
                np.random.SeedSequence(entropy=self.seed,
                                       spawn_key=(rid,)))
        return rng

    def propose(self, rid: int, ctx: np.ndarray, k: int
                ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        return self.propose_batch([(rid, ctx, k)])[0]

    def _sample_draft(self, rid: int, logits: np.ndarray, qdists: list
                      ) -> int:
        """One draft token from next-token logits: greedy, or a draw at
        the drafter's temperature (recording the proposal law)."""
        if self.temperature <= 0:
            return int(np.argmax(logits))
        q = softmax(logits, self.temperature)
        qdists.append(q.astype(np.float32))
        return categorical_np(self._rng_for(rid), q)

    def _propose_seq(self, rid: int, ctx_l: List[int], k: int):
        """Per-request sequential drafting for recurrent draft models: a
        batch-1 cache, one decode step per token. Recurrent state cannot
        rewind through lens, so a context that parts from the fed stream
        re-feeds the whole context through a fresh cache."""
        fed = self._fed.setdefault(rid, [])
        cp = 0
        for a, b in zip(fed, ctx_l):
            if a != b:
                break
            cp += 1
        cp = min(cp, len(ctx_l) - 1)  # always feed >= 1 for logits
        if rid not in self._seq_caches or cp < len(fed):
            self._seq_caches[rid] = self.model.init_cache(
                1, self.max_seq, device=self.device)
            fed.clear()
            cp = 0

        def feed(tok: int) -> np.ndarray:
            with torch.no_grad():
                logits, self._seq_caches[rid] = self._decode(
                    self.params, torch.tensor([[tok]], dtype=torch.int32,
                                              device=self.device),
                    self._seq_caches[rid])
            self.steps += 1
            return logits[0, 0].float().cpu().numpy()

        logits = None
        for t in ctx_l[cp:]:
            logits = feed(t)
            fed.append(t)
        toks: List[int] = []
        qdists: List[np.ndarray] = []
        for j in range(k):
            d = self._sample_draft(rid, logits, qdists)
            toks.append(d)
            if j + 1 < k and len(fed) + 1 < self.max_seq:
                logits = feed(d)
                fed.append(d)
            elif j + 1 < k:
                break                 # drafter cache full: stop early
        qd = np.stack(qdists) if qdists else None
        return np.asarray(toks, np.int32), qd

    def propose_batch(self, items):
        """Draft every requested row through shared batched decode steps:
        the catch-up (re-feeding committed tokens after a rollback) and
        the K draft-token steps each run ONE device step for all rows."""
        empty = np.zeros((0,), np.int32)
        results = [(empty, None)] * len(items)
        protect = {rid for rid, _, _ in items}
        live = []
        for i, (rid, ctx, k) in enumerate(items):
            ctx_l = [int(t) for t in np.asarray(ctx).tolist()]
            if k <= 0 or len(ctx_l) + 1 >= self.max_seq:
                continue
            if not self._batched:
                results[i] = self._propose_seq(rid, ctx_l, k)
                continue
            slot = self._slot(rid, protect)
            fed = self._fed[rid]
            cp = 0
            for a, b in zip(fed, ctx_l):
                if a != b:
                    break
                cp += 1
            cp = min(cp, len(ctx_l) - 1)  # always feed >= 1 for logits
            del fed[cp:]
            live.append({"i": i, "rid": rid, "slot": slot, "k": k,
                         "pending": ctx_l[cp:], "toks": [], "qd": [],
                         "logits": None, "done": False})
        if not live:
            return results

        B = self.max_batch

        def batched_feed(rows):
            """Feed each row's queued token in one device step."""
            tok = np.zeros((B, 1), np.int32)
            lens = np.full((B,), self.max_seq, np.int32)   # park the rest
            for r, t in rows:
                tok[r["slot"], 0] = t
                lens[r["slot"]] = len(self._fed[r["rid"]])
            logits = self._step(tok, lens)
            for r, t in rows:
                self._fed[r["rid"]].append(t)
                r["logits"] = logits[r["slot"]]

        # catch-up: rows at different depths re-sync together, one token
        # per row per step, until every row has next-token logits
        while any(r["pending"] for r in live):
            batched_feed([(r, r["pending"].pop(0))
                          for r in live if r["pending"]])

        # draft loop: sample one token per row, feed them all in one step
        for j in range(max(r["k"] for r in live)):
            feeds = []
            for r in live:
                if r["done"] or j >= r["k"]:
                    continue
                d = self._sample_draft(r["rid"], r["logits"], r["qd"])
                r["toks"].append(d)
                if j + 1 >= r["k"]:
                    r["done"] = True
                elif len(self._fed[r["rid"]]) + 1 < self.max_seq:
                    feeds.append((r, d))
                else:
                    r["done"] = True    # drafter cache full: stop early
            if not feeds:
                break
            batched_feed(feeds)

        for r in live:
            qd = np.stack(r["qd"]) if r["qd"] else None
            results[r["i"]] = (np.asarray(r["toks"], np.int32), qd)
        return results

    def weight_bytes_per_step(self, scfg) -> float:
        """One BATCHED draft step streams the whole draft-model weight set
        once, however many rows share it."""
        from repro_torch.serve.metrics import weight_traffic
        return weight_traffic(self.cfg, scfg)[0]

    def forget(self, rid: int) -> None:
        slot = self._caches.pop(rid, None)
        if slot is not None:
            self._free.append(slot)
        self._seq_caches.pop(rid, None)
        self._fed.pop(rid, None)
        self._rngs.pop(rid, None)
