"""NMCE execution model — bank-partitioned weight-stationary GEMV (own copy
of ``repro.core.nmce``).

Paper Fig. 4/5: four near-memory compute engines, one per L2 bank. The CPU
programs each engine with (v1Reg: 64B stationary int8 vector, v2addr,
stride, count<=32); the engine streams ``count`` rows past v1Reg, producing
saturated int16 dot products; the CPU accumulates partials across
engines/chunks.

This module is the *semantic* model (plain tensor code, chunk-exact): it
plans the bank partition and emulates the per-command arithmetic. The
performance implementation is ``repro_torch.kernels.nmce_matvec``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import torch

from repro_torch.core import quant


@dataclasses.dataclass(frozen=True)
class NMCEConfig:
    n_banks: int = 4
    vreg_bytes: int = quant.NMCE_VREG_BYTES   # 64B int8 stationary operand
    max_count: int = quant.NMCE_MAX_COUNT     # rows per command
    saturating: bool = True                   # int16 saturation per command


@dataclasses.dataclass(frozen=True)
class BankPlan:
    """Row range each bank owns, plus the per-command chunking (Fig. 5)."""
    row_start: int
    row_count: int
    commands: int          # ceil(row_count / max_count)


def plan_matvec(n_rows: int, cfg: NMCEConfig) -> List[BankPlan]:
    """Partition ``n_rows`` output rows across banks as evenly as possible —
    the CPU-side scheduling loop from Fig. 5."""
    base, rem = divmod(n_rows, cfg.n_banks)
    plans, start = [], 0
    for b in range(cfg.n_banks):
        cnt = base + (1 if b < rem else 0)
        plans.append(BankPlan(row_start=start, row_count=cnt,
                              commands=math.ceil(cnt / cfg.max_count)
                              if cnt else 0))
        start += cnt
    return plans


def nmce_matvec(x_q: quant.QuantizedTensor, w_q: quant.QuantizedTensor,
                cfg: NMCEConfig = NMCEConfig(),
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Emulate the full NMCE matvec: y = W @ x with W int8[N, K], x int8[K].

    Chunks K into 64B v1Reg loads; each (bank, command, chunk) performs a
    saturating int16 dot; the CPU accumulates chunk partials and
    dequantizes. Matches hardware semantics chunk for chunk."""
    w, x = w_q.q.long(), x_q.q.long()
    n, k = w.shape
    pad_k = (-k) % cfg.vreg_bytes
    if pad_k:
        w = torch.nn.functional.pad(w, (0, pad_k))
        x = torch.nn.functional.pad(x, (0, pad_k))
    kc = w.shape[1] // cfg.vreg_bytes
    wv = w.reshape(n, kc, cfg.vreg_bytes)
    xv = x.reshape(kc, cfg.vreg_bytes)
    per_chunk = (wv * xv[None]).sum(dim=-1)
    if cfg.saturating:
        per_chunk = torch.clamp(per_chunk, quant.INT16_MIN, quant.INT16_MAX)
    acc = per_chunk.sum(dim=-1).to(torch.int32)

    scale_w = w_q.scale
    if w_q.axis is not None:
        if w_q.axis != 0:
            raise ValueError("matvec weights W[N,K] must be quantized "
                             "per-output-row (axis=0) or per-tensor")
        scale_w = scale_w.reshape(-1)  # per-row (output channel) of W[N,K]
    y = acc.float() * scale_w * x_q.scale
    return y.to(out_dtype)


def nmce_traffic_bytes(n: int, k: int, cfg: NMCEConfig = NMCEConfig()
                       ) -> dict:
    """Off-chip traffic model for one matvec (the paper's bottleneck):
    weights stream once (n*k int8 bytes), activations are loaded once per
    bank (k bytes each — v1Reg reloads), results written back (2B int16)."""
    return {
        "weight_bytes": n * k,
        "activation_bytes": k * cfg.n_banks,
        "result_bytes": 2 * n,
        "total": n * k + k * cfg.n_banks + 2 * n,
    }


def speedup_model(n: int, k: int, *, sw_gops: float = 0.0566,
                  mem_bw_gbps: float = 3.2) -> Tuple[float, float]:
    """Roofline model of Table II: software multi-core does 56.6 MOPs
    (0.0566 GOPs); the NMCE path is limited by the off-chip link streaming
    int8 weights. Returns (nmce_gops, speedup_vs_multicore)."""
    ops = 2.0 * n * k
    bytes_ = float(nmce_traffic_bytes(n, k)["total"])
    t_mem = bytes_ / (mem_bw_gbps * 1e9)
    nmce_gops = ops / t_mem / 1e9
    return nmce_gops, nmce_gops / sw_gops
