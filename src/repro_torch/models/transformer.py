"""The decoder stack: slot-cache prefill and decode, and the paged serving
step.

Parameters keep the reference's stacked layout: every per-layer leaf of
``params["units"]["b0"]`` carries a leading [n_units] axis, as
``repro.models.transformer.init_params`` builds it. The reference's
``lax.scan`` over units becomes a Python loop over views of those stacks.
This slice serves attention-only stacks with RoPE, as the nectar family is.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention, ffn, layers, rope


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a config outside this slice of the port."""
    missing = [name for name, off in (
        ("attention-only pattern", cfg.pattern_unit() == ("attn",)),
        ("rope positions", cfg.pos_emb == "rope" and not cfg.mrope),
        ("single token stream", not cfg.n_codebooks),
        ("no frontend", cfg.frontend == "none"),
        ("no qk_norm", not cfg.qk_norm),
        ("no qkv_bias", not cfg.qkv_bias)) if not off]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: the port serves dense attention stacks only; "
            f"this config needs {missing}")


def _stack(trees: List[dict]) -> dict:
    """Stack a list of same-structured dicts of tensors leaf by leaf."""
    return {k: _stack([t[k] for t in trees]) if isinstance(v, dict)
            else torch.stack([t[k] for t in trees])
            for k, v in trees[0].items()}


def _index(tree: dict, i: int) -> dict:
    """Views of unit ``i`` of a stacked tree (writes go to the stack)."""
    return {k: _index(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def init_block(generator: torch.Generator, cfg: ModelConfig,
               dtype: torch.dtype, device: torch.device) -> dict:
    ones = torch.ones(cfg.d_model, dtype=dtype, device=device)
    return {"norm1": ones,
            "attn": attention.init_attn(generator, cfg, dtype, device),
            "norm2": ones.clone(),
            "ffn": ffn.init_ffn(generator, cfg, dtype, device)}


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: Optional[Union[str, torch.device]] = None
                ) -> Dict[str, object]:
    """Random weights from ``generator`` (the reference's init law, not its
    bits), made on ``device`` (default CUDA)."""
    device = resolve_device(device)
    check_supported(cfg)
    dtype = getattr(torch, cfg.dtype)
    params: Dict[str, object] = {"embed": layers.embed_init(
        generator, cfg.vocab, cfg.d_model, dtype, device)}
    if not cfg.tie_embeddings:
        params["head"] = layers.dense_init(
            generator, (cfg.d_model, cfg.vocab), dtype, device)
    params["final_norm"] = torch.ones(cfg.d_model, dtype=dtype,
                                      device=device)
    params["units"] = {"b0": _stack([init_block(generator, cfg, dtype, device)
                                     for _ in range(cfg.n_units)])}
    return params


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.float32,
               device: Optional[Union[str, torch.device]] = None) -> dict:
    """Contiguous decode cache of the slot engine: one [batch, max_len, Kv,
    Dh] K/V pair per layer, stacked over units, plus per-row context
    lengths (slots advance independently)."""
    device = resolve_device(device)
    check_supported(cfg)
    kv = _stack([attention.init_kv_cache(cfg, batch, max_len, dtype, device)
                 for _ in range(cfg.n_units)])
    return {"lens": torch.zeros(batch, dtype=torch.int32, device=device),
            "units": {"b0": kv}}


def init_paged_cache(cfg: ModelConfig, batch: int, n_blocks: int,
                     block_size: int, max_blocks_per_seq: int,
                     dtype: torch.dtype = torch.float32,
                     device: Optional[Union[str, torch.device]] = None
                     ) -> dict:
    """Paged decode cache: one block pool per layer, stacked over units,
    plus per-slot block tables (sentinel-filled; serve.paged_kv assigns
    blocks)."""
    device = resolve_device(device)
    check_supported(cfg)
    pools = _stack([attention.init_paged_kv_cache(cfg, n_blocks, block_size,
                                                  dtype, device)
                    for _ in range(cfg.n_units)])
    return {"lens": torch.zeros(batch, dtype=torch.int32, device=device),
            "block_tables": torch.full((batch, max_blocks_per_seq), n_blocks,
                                       dtype=torch.int32, device=device),
            "units": {"b0": pools}}


def _embed_inputs(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens.long()]


def _rope_tables(cfg: ModelConfig, positions: torch.Tensor):
    return rope.rope_cos_sin(positions, cfg.d_head, cfg.rope_theta)


def block_forward(p: dict, cfg: ModelConfig, x: torch.Tensor, ctx: dict,
                  cache: Optional[dict]) -> torch.Tensor:
    """One attention block over a whole prompt: causal attention (writing
    the cache at [0, S) when given), then the dense FFN."""
    h = layers.rms_norm(x, p["norm1"], cfg.norm_eps)
    x = x + attention.attn_forward(p["attn"], cfg, h, ctx["cos"],
                                   ctx["sin"], cache=cache)
    h = layers.rms_norm(x, p["norm2"], cfg.norm_eps)
    return x + ffn.ffn_forward(p["ffn"], cfg, h)


def block_decode(p: dict, cfg: ModelConfig, x: torch.Tensor, ctx: dict,
                 cache: dict) -> torch.Tensor:
    """One attention block for one token per row: decode attention over
    the slot cache, then the decode FFN (sparse gather under
    relu_sparse)."""
    h = layers.rms_norm(x, p["norm1"], cfg.norm_eps)
    x = x + attention.attn_decode(p["attn"], cfg, h, ctx["cos"], ctx["sin"],
                                  cache, ctx["lens"])
    h = layers.rms_norm(x, p["norm2"], cfg.norm_eps)
    return x + ffn.ffn_decode(p["ffn"], cfg, h)


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            cache: Optional[dict] = None):
    """Full-sequence forward (prefill) of tokens i32[B, S] at positions
    [0, S). With ``cache`` each layer's K/V land at [0, S) of it in place
    and the returned cache has lens = S. Returns (hidden [B, S, d],
    cache or None); the reference also returns an MoE aux loss, which an
    attention-only stack does not have."""
    x = _embed_inputs(params, tokens)
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device)[None, :].expand(B, S)
    cos, sin = _rope_tables(cfg, positions)
    ctx = {"cos": cos, "sin": sin}
    units = params["units"]["b0"]
    for i in range(cfg.n_units):
        x = block_forward(_index(units, i), cfg, x, ctx,
                          None if cache is None
                          else _index(cache["units"]["b0"], i))
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cache is None:
        return x, None
    return x, {"lens": torch.full_like(cache["lens"], S),
               "units": cache["units"]}


def decode_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                cache: dict):
    """One-token decode of every row: tokens i32[B, 1] at positions
    cache["lens"]. The cache's K/V are written in place. Returns (logits
    f32[B, 1, V], the cache with lens + 1)."""
    x = _embed_inputs(params, tokens)
    lens = cache["lens"]
    cos, sin = _rope_tables(cfg, lens[:, None])
    ctx = {"cos": cos, "sin": sin, "lens": lens}
    units = params["units"]["b0"]
    for i in range(cfg.n_units):
        x = block_decode(_index(units, i), cfg, x, ctx,
                         _index(cache["units"]["b0"], i))
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return (project_logits(params, cfg, x),
            {"lens": lens + 1, "units": cache["units"]})


def block_step_paged(p: dict, cfg: ModelConfig, x: torch.Tensor, ctx: dict,
                     cache: dict) -> torch.Tensor:
    """One attention block of the serving step: paged attention, then the
    per-row FFN select (dense for prefill rows, sparse gather for decode
    and verify rows)."""
    h = layers.rms_norm(x, p["norm1"], cfg.norm_eps)
    x = x + attention.attn_step_paged(
        p["attn"], cfg, h, ctx["cos"], ctx["sin"], cache, ctx["lens"],
        ctx["n_valid"], ctx["tables"], ctx["block_size"],
        backend=ctx["backend"])
    h = layers.rms_norm(x, p["norm2"], cfg.norm_eps)
    return x + ffn.ffn_step(p["ffn"], cfg, h, ctx["is_prefill"],
                            has_prefill=ctx["has_prefill"])


def project_logits(params: dict, cfg: ModelConfig,
                   x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return (x @ params["embed"].t()).float()
    return (x @ params["head"]).float()


def forward_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                 cache: dict, n_valid: torch.Tensor,
                 is_prefill: torch.Tensor, block_size: int,
                 backend: str = "naive",
                 has_prefill: bool = True) -> torch.Tensor:
    """The serving entry point: one batched step through block tables
    serving chunked-prefill, decode and verify rows together.

    Row b feeds ``n_valid[b]`` tokens (0 = inactive row) at positions
    cache["lens"][b] + j; their KV is written into the cache's pools in
    place, and logits[b, j] is the distribution of the token following
    tokens[b, j]. ``lens`` and the tables never advance here: the engine
    republishes them before every step. ``is_prefill`` bool[B] routes each
    row's FFN; ``has_prefill`` is the host's no-prefill-rows fast path.
    Returns logits f32[B, S, V]."""
    x = _embed_inputs(params, tokens)
    S = tokens.shape[1]
    lens = cache["lens"]
    positions = lens[:, None] + torch.arange(S, dtype=lens.dtype,
                                             device=tokens.device)[None, :]
    cos, sin = _rope_tables(cfg, positions)
    pools = cache["units"]["b0"]
    n_blocks = pools["k"].shape[1]
    # IDLE rows read and write nothing: their tables become all-sentinel
    tables = torch.where(n_valid[:, None] > 0, cache["block_tables"],
                         n_blocks)
    ctx = {"cos": cos, "sin": sin, "lens": lens, "n_valid": n_valid,
           "is_prefill": is_prefill, "has_prefill": has_prefill,
           "tables": tables, "block_size": block_size, "backend": backend}
    units = params["units"]["b0"]
    for i in range(cfg.n_units):
        x = block_step_paged(_index(units, i), cfg, x, ctx, _index(pools, i))
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return project_logits(params, cfg, x)
