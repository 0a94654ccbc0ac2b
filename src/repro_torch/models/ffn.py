"""FFN: dense GLU / non-GLU, with the NeCTAr sparse decode path."""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import sparsity
from repro_torch.models import layers


def init_ffn(generator: torch.Generator, cfg: ModelConfig,
             dtype: torch.dtype, device: torch.device) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    p = {"w_up": layers.dense_init(generator, (d, f), dtype, device),
         "w_down": layers.dense_init(generator, (f, d), dtype, device)}
    if cfg.glu:
        p["w_gate"] = layers.dense_init(generator, (d, f), dtype, device)
    return p


def ffn_forward(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Dense path (prefill)."""
    act = "relu" if cfg.relu_sparse else cfg.act
    return sparsity.dense_ffn(x, p["w_up"], p["w_down"], act=act,
                              w_gate=p.get("w_gate"))


def ffn_decode(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Decode path: the top-k gathered down-projection under relu_sparse
    (the paper's technique), dense otherwise."""
    if not cfg.relu_sparse:
        return ffn_forward(p, cfg, x)
    k = sparsity.active_fraction_to_k(cfg.d_ff, cfg.sparse_k_frac)
    return sparsity.gathered_sparse_ffn(
        x, p["w_up"], p["w_down"], k=k, act="relu", w_gate=p.get("w_gate"))


def ffn_step(p: dict, cfg: ModelConfig, x: torch.Tensor,
             is_prefill: torch.Tensor, has_prefill: bool = True
             ) -> torch.Tensor:
    """Per-row FFN of the batched serving step: prefill rows take the
    dense path, decode/verify rows the sparse decode path, in one batch.
    x: [B, S, d]; is_prefill: bool[B].

    ``has_prefill`` is decided on the host: a step with no prefill row
    runs the sparse path alone and never reads the dense W_down. A mixed
    step computes both down-projections from one hidden activation and
    selects per row, as the reference does."""
    if not cfg.relu_sparse:
        return ffn_forward(p, cfg, x)
    if not has_prefill:
        return ffn_decode(p, cfg, x)
    h = sparsity.ffn_hidden(x, p["w_up"], "relu", p.get("w_gate"))
    down_d = sparsity.down_dense(h, p["w_down"])
    k = sparsity.active_fraction_to_k(cfg.d_ff, cfg.sparse_k_frac)
    down_s = sparsity.down_sparse(h, p["w_down"], k)
    return torch.where(is_prefill[:, None, None], down_d, down_s)
