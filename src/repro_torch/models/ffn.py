"""FFN: dense GLU / non-GLU, with the NeCTAr sparse decode path. Under
an activation-sharding scope (dist.sharding) the serving step runs
tensor parallel on column-sharded weights: kernel 2 once a shard, on its
column block of W_down."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import sparsity
from repro_torch.dist import sharding
from repro_torch.kernels import ops
from repro_torch.models import layers


def init_ffn(generator: torch.Generator, cfg: ModelConfig,
             dtype: torch.dtype, device: torch.device,
             d_ff: Optional[int] = None) -> dict:
    """W_up, W_down (and W_gate for a GLU) of width ``d_ff`` (default the
    config's; an MoE's shared expert is wider)."""
    d, f = cfg.d_model, d_ff or cfg.d_ff
    p = {"w_up": layers.dense_init(generator, (d, f), dtype, device),
         "w_down": layers.dense_init(generator, (f, d), dtype, device)}
    if cfg.glu:
        p["w_gate"] = layers.dense_init(generator, (d, f), dtype, device)
    return p


def ffn_forward(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Dense path (prefill). A non-GLU ReLU FFN, the nectar family's, is
    the fused ReLU-FFN kernel's function (``ops.relu_ffn_fused``); GLU and
    other activations stay dense."""
    act = "relu" if cfg.relu_sparse else cfg.act
    if act == "relu" and "w_gate" not in p:
        out = ops.relu_ffn_fused(x.reshape(-1, x.shape[-1]).contiguous(),
                                 p["w_up"], p["w_down"])
        return out.reshape(x.shape[:-1] + out.shape[-1:]).to(x.dtype)
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
    if sharding.current_scope() is not None:
        return _ffn_step_mesh(p, cfg, x, is_prefill, has_prefill)
    if not cfg.relu_sparse:
        return ffn_forward(p, cfg, x)
    if not has_prefill:
        return ffn_decode(p, cfg, x)
    h = sparsity.ffn_hidden(x, p["w_up"], "relu", p.get("w_gate"))
    down_d = sparsity.down_dense(h, p["w_down"])
    k = sparsity.active_fraction_to_k(cfg.d_ff, cfg.sparse_k_frac)
    down_s = sparsity.down_sparse(h, p["w_down"], k)
    return torch.where(is_prefill[:, None, None], down_d, down_s)


def _hidden_mesh(p: dict, act: str, x: torch.Tensor) -> torch.Tensor:
    """The hidden activation under a scope, gathered on the home device:
    each shard's columns of W_up (and W_gate) with the activation applied
    on its device, concatenated (``constrain_tp_exact``); a whole W_up
    once on the home device."""
    up, gate = sharding.column_parts(p["w_up"]), \
        sharding.column_parts(p.get("w_gate"))
    if up is None or ("w_gate" in p and gate is None):
        w_gate = p.get("w_gate")
        return sparsity.ffn_hidden(
            x, sharding.whole(p["w_up"]), act,
            None if w_gate is None else sharding.whole(w_gate))
    parts = [sparsity.ffn_hidden(x.to(u.device), u, act,
                                 None if gate is None else gate[i])
             for i, u in enumerate(up)]
    return sharding.constrain_tp_exact(parts)


def _down_sparse_mesh(h: torch.Tensor, w_down, k: int) -> torch.Tensor:
    """The gathered down-projection under a scope: the top-k runs once on
    the replicated h, then kernel 2 once a shard on that shard's
    contiguous [d_ff, d/n] column block of W_down, and the outputs are
    concatenated. A whole W_down takes one launch on the home device."""
    parts = sharding.column_parts(w_down)
    if parts is None:
        return sparsity.down_sparse(h, sharding.whole(w_down), k)
    hk, idx = sparsity.active_slots(h, k, w_down.shape[0])
    outs = [ops.sparse_gather_matvec(hk.to(w.device), idx.to(w.device), w)
            for w in parts]
    out = sharding.constrain_tp_exact(outs)
    return out.reshape(*h.shape[:-1], w_down.shape[1]).to(h.dtype)


def _ffn_step_mesh(p: dict, cfg: ModelConfig, x: torch.Tensor,
                   is_prefill: torch.Tensor, has_prefill: bool
                   ) -> torch.Tensor:
    """``ffn_step`` under an activation-sharding scope, as the reference's
    under exact_tp: h gathered from the column-sharded up-projection,
    then the per-shard down-projections on W_down's column blocks,
    gathered. No row-parallel product and no sum of partials."""
    act = "relu" if cfg.relu_sparse else cfg.act
    h = _hidden_mesh(p, act, x)
    if not cfg.relu_sparse:
        return sharding.colwise(h, p["w_down"])
    k = sparsity.active_fraction_to_k(cfg.d_ff, cfg.sparse_k_frac)
    down_s = _down_sparse_mesh(h, p["w_down"], k)
    if not has_prefill:
        return down_s
    down_d = sharding.colwise(h, p["w_down"])
    return torch.where(is_prefill[:, None, None], down_d, down_s)
