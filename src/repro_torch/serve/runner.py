"""ModelRunner: ONE batched ``step(StepBatch) -> StepOutput`` for serving.

One call of ``Model.forward_step`` serves chunked-prefill rows and decode
rows in the same fixed-width batch. The per-tick token width is bucketed
as in the reference — {1} for pure decode ticks, the prefill chunk width
and k_max+1 under speculation — so a step's shapes match the reference's
step for the same tick.
The runner owns the device cache; the engine republishes the host-truth
``lens`` and block tables before every step. ``copy_blocks`` (copy-on-write)
and ``apply_perm`` (defrag) mirror the host pool's block moves on every
layer's pool leaves, int8 scales included.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ServeConfig

# row phases (StepBatch.phase values)
IDLE, PREFILL, DECODE, VERIFY = 0, 1, 2, 3

BACKENDS = ("naive", "flash")


@dataclasses.dataclass
class StepBatch:
    """Host-side description of one step: tokens i32[B, S] (row b's valid
    tokens occupy [0, n_valid[b])), the absolute position of each row's
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
    def empty(cls, max_batch: int, width: int,
              tables: np.ndarray) -> "StepBatch":
        return cls(tokens=np.zeros((max_batch, width), np.int32),
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


@dataclasses.dataclass
class StepOutput:
    """Device results of one step: ``logits[b, j]`` is the distribution of
    the token following tokens[b, j]; ``last_logits[b]`` is row b's logits
    at its last valid position. ``row_logits`` copies one row to the host
    on first use (prompt log-probabilities need every position)."""

    logits: torch.Tensor         # f32[B, S, V]
    last_logits: torch.Tensor    # f32[B, V]
    _rows: Dict[int, np.ndarray] = dataclasses.field(default_factory=dict)

    def row_logits(self, slot: int) -> np.ndarray:
        row = self._rows.get(slot)
        if row is None:
            row = self._rows[slot] = self.logits[slot].float().cpu().numpy()
        return row


class ModelRunner:
    """Owns the device-side paged cache; the engine builds a StepBatch
    per tick and calls ``step``."""

    def __init__(self, model, params: dict, scfg: ServeConfig,
                 device: torch.device, dtype: torch.dtype = torch.float32):
        if scfg.attn_backend not in BACKENDS:
            raise ValueError(f"unknown attn_backend "
                             f"{scfg.attn_backend!r}; known: {BACKENDS}")
        if scfg.attn_backend == "flash" and scfg.kv_quant:
            raise ValueError(
                "attn_backend='flash' reads fp block pools; int8 KV "
                "(kv_quant) needs the naive dequantizing gather")
        self.model = model
        self.cfg = model.cfg
        self.params = params
        self.scfg = scfg
        self.device = device
        self.cache = model.init_paged_cache(
            scfg.max_batch, scfg.pool_blocks, scfg.block_size,
            scfg.blocks_per_seq, dtype=dtype, device=device,
            int8_kv=scfg.kv_quant)
        self.buckets = sorted({1, scfg.prefill_chunk}
                              | ({scfg.spec.k_max + 1}
                                 if scfg.spec is not None else set()))
        self.n_steps = 0

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
                               self.width_for(max_valid), tables)

    def step(self, batch: StepBatch) -> StepOutput:
        """Republish host-truth lens/tables, run the step, return the
        per-position and the last-valid logits."""
        dev = self.device
        self.cache["lens"] = torch.tensor(batch.row_start, device=dev)
        self.cache["block_tables"] = torch.tensor(batch.tables, device=dev)
        n_valid = torch.tensor(batch.n_valid, device=dev)
        with torch.no_grad():
            logits = self.model.forward_step(
                self.params, torch.tensor(batch.tokens, device=dev),
                self.cache, n_valid,
                torch.tensor(batch.phase == PREFILL, device=dev),
                self.scfg.block_size, backend=self.scfg.attn_backend,
                has_prefill=bool(np.any(batch.phase == PREFILL)))
            idx = (n_valid.long() - 1).clamp(0, logits.shape[1] - 1)
            last = logits[torch.arange(logits.shape[0], device=dev), idx]
        self.n_steps += 1
        return StepOutput(logits=logits, last_logits=last)

    # --- block maintenance --------------------------------------------------
    def apply_perm(self, perm: np.ndarray) -> None:
        """Apply a pool defrag permutation to the device block pools (new
        storage row i = old row perm[i]), every leaf of every layer."""
        p = torch.as_tensor(np.asarray(perm), dtype=torch.long,
                            device=self.device)
        for leaf in self.cache["units"]["b0"].values():
            leaf.copy_(leaf.index_select(1, p))

    def copy_blocks(self, pairs: List[Tuple[int, int]]) -> None:
        """Copy-on-write: duplicate pool storage rows src -> dst across
        every layer's block pools (all leaves, int8 scales included), on
        the current stream, before the step that writes them. The host
        side (paged_kv.cow_for_write) already rewrote the block table;
        this mirrors the bytes so the writer's private copy starts
        bit-identical to the shared original."""
        if not pairs:
            return
        src = torch.tensor([a for a, _ in pairs], dtype=torch.long,
                           device=self.device)
        dst = torch.tensor([b for _, b in pairs], dtype=torch.long,
                           device=self.device)
        for leaf in self.cache["units"]["b0"].values():
            leaf[:, dst] = leaf[:, src]
