"""The decoder stack: the training forward and its chunked loss,
slot-cache prefill and decode over blocks of every kind the port serves,
and the paged serving step.

Parameters keep the reference's stacked layout: a config's
``pattern_unit()`` (nectar: one attention block; moonshot: one MoE block;
llama4-maverick: an attention block and an MoE block; zamba2: five Mamba2
blocks and one invocation of the shared attention block; xLSTM: mLSTM
blocks and an sLSTM block) is the loop body, and every per-block leaf of
``params["units"][f"b{j}"]`` carries a leading [n_units] axis, as
``repro.models.transformer.init_params`` builds it. The shared block
lives at ``params["shared"]``, outside the units, and is not stacked;
each of its invocations keeps a KV cache of its own. The reference's
``lax.scan`` over units becomes a Python loop over views of those stacks.
The paged serving step serves the stacks whose every block keeps a KV
cache (attention and MoE blocks), as the reference's does.

The frontends: a codebook model (musicgen) embeds nc token streams,
summed, and projects each through a head of its own; M-RoPE (qwen2-vl)
rotates three sections of the frequencies by three position channels;
sinusoidal positions (musicgen) are added to the embedding; and the
frontend stubs' embeddings (``vision_embeds``, ``audio_embeds``), given by
the caller, are added to the first positions of a prompt.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Union

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.dist import sharding
from repro_torch.models import attention, ffn, layers, moe, rope, ssm, xlstm

ATTN_KINDS = ("attn", "shared_attn")
# every kind whose state is a KV cache alone: the kinds a paged cache
# serves and a drafter can park
KV_KINDS = ATTN_KINDS + ("moe",)
RECURRENT_KINDS = ("mamba2", "mlstm", "slstm")


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a config with a block kind the port has no module for."""
    kinds = set(cfg.pattern_unit()) - set(KV_KINDS + RECURRENT_KINDS)
    if kinds:
        raise NotImplementedError(
            f"{cfg.name}: the port serves attention, moe, mamba2, mlstm "
            f"and slstm blocks; this config has {sorted(kinds)}")


def check_prompt_len(cfg: ModelConfig, S: int) -> None:
    """Raise ValueError for a prompt length the reference's prefill
    refuses: its chunked Mamba2 scan and its blockwise mLSTM need S at
    most one chunk or a multiple of it."""
    unit = cfg.pattern_unit()
    if "mamba2" in unit:
        ssm.check_prompt_len(S)
    if "mlstm" in unit:
        xlstm.check_prompt_len(S)


def merge_slot(cfg: ModelConfig, cache: dict, tmp: dict, slot: int,
               prompt_len: int) -> None:
    """Write a batch-1 prefill cache ``tmp`` (sized to the prompt) into
    row ``slot`` of every leaf of the slot cache ([U, B, ...]), in place,
    as the reference's merge sets it. An attention block's K/V fill the
    row's first ``prompt_len`` positions and the rest is zeroed, so the
    row ends as the reference's splice of a fresh max_seq-long cache
    leaves it; a recurrent block's state is the whole row."""
    for j, kind in enumerate(cfg.pattern_unit()):
        mine, theirs = cache["units"][f"b{j}"], tmp["units"][f"b{j}"]
        for name, leaf in mine.items():
            if kind in KV_KINDS:
                leaf[:, slot, :prompt_len] = theirs[name][:, 0]
                leaf[:, slot, prompt_len:] = 0
            else:
                leaf[:, slot] = theirs[name][:, 0]
    cache["lens"][slot] = prompt_len


def _stack(trees: List[dict]) -> dict:
    """Stack a list of same-structured dicts of tensors leaf by leaf."""
    return {k: _stack([t[k] for t in trees]) if isinstance(v, dict)
            else torch.stack([t[k] for t in trees])
            for k, v in trees[0].items()}


def _index(tree: dict, i: int) -> dict:
    """Views of unit ``i`` of a stacked tree (writes go to the stack)."""
    return {k: _index(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _write(cache: dict, new: dict) -> None:
    """Copy a recurrent block's new state into its views of the cache."""
    for name, leaf in new.items():
        cache[name].copy_(leaf)


def init_block(generator: torch.Generator, kind: str, cfg: ModelConfig,
               dtype: torch.dtype, device: torch.device) -> dict:
    if kind in KV_KINDS:
        ones = torch.ones(cfg.d_model, dtype=dtype, device=device)
        p = {"norm1": ones,
             "attn": attention.init_attn(generator, cfg, dtype, device),
             "norm2": ones.clone()}
        if kind == "moe":
            p["moe"] = moe.init_moe(generator, cfg, dtype, device)
        else:
            p["ffn"] = ffn.init_ffn(generator, cfg, dtype, device)
        return p
    if kind == "mamba2":
        return {"norm": torch.ones(cfg.d_model, dtype=dtype, device=device),
                "mamba": ssm.init_mamba2(generator, cfg, dtype, device)}
    if kind == "mlstm":
        return xlstm.init_mlstm_block(generator, cfg, dtype, device)
    if kind == "slstm":
        return xlstm.init_slstm_block(generator, cfg, dtype, device)
    raise ValueError(kind)


def init_block_cache(kind: str, cfg: ModelConfig, batch: int, max_len: int,
                     dtype: torch.dtype, device: torch.device) -> dict:
    if kind in KV_KINDS:
        return attention.init_kv_cache(cfg, batch, max_len, dtype, device)
    if kind == "mamba2":
        return ssm.init_mamba2_cache(cfg, batch, dtype, device)
    if kind == "mlstm":
        return xlstm.init_mlstm_cache(cfg, batch, dtype, device)
    if kind == "slstm":
        return xlstm.init_slstm_cache(cfg, batch, dtype, device)
    raise ValueError(kind)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: Optional[Union[str, torch.device]] = None
                ) -> Dict[str, object]:
    """Random weights from ``generator`` (the reference's init law, not its
    bits), made on ``device`` (default CUDA). Each block position of the
    unit draws its n_units copies in turn, then the shared block."""
    device = resolve_device(device)
    check_supported(cfg)
    dtype = getattr(torch, cfg.dtype)
    unit = cfg.pattern_unit()
    nc = cfg.n_codebooks
    # a codebook model embeds and projects each of its nc streams with a
    # table of its own: embed [nc, V, d], head [nc, d, V]
    params: Dict[str, object] = {"embed": layers.embed_init(
        generator, (nc or 1) * cfg.vocab, cfg.d_model, dtype, device)}
    if nc:
        params["embed"] = params["embed"].reshape(nc, cfg.vocab, cfg.d_model)
    if not cfg.tie_embeddings:
        params["head"] = layers.dense_init(
            generator, ((nc, cfg.d_model, cfg.vocab) if nc
                        else (cfg.d_model, cfg.vocab)), dtype, device)
    params["final_norm"] = torch.ones(cfg.d_model, dtype=dtype,
                                      device=device)
    params["units"] = {
        f"b{j}": _stack([init_block(generator, kind, cfg, dtype, device)
                         for _ in range(cfg.n_units)])
        for j, kind in enumerate(unit) if kind != "shared_attn"}
    if "shared_attn" in unit:
        params["shared"] = init_block(generator, "shared_attn", cfg, dtype,
                                      device)
    return params


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.float32,
               device: Optional[Union[str, torch.device]] = None) -> dict:
    """The slot engine's cache: per block position j, its state stacked
    over units under ``units[f"b{j}"]`` (a contiguous [batch, max_len,
    Kv, Dh] K/V pair for an attention block, every ``shared_attn``
    invocation its own; O(1) recurrent state for the others), plus
    per-row context lengths (slots advance independently)."""
    device = resolve_device(device)
    check_supported(cfg)
    units = {f"b{j}": _stack([init_block_cache(kind, cfg, batch, max_len,
                                               dtype, device)
                              for _ in range(cfg.n_units)])
             for j, kind in enumerate(cfg.pattern_unit())}
    return {"lens": torch.zeros(batch, dtype=torch.int32, device=device),
            "units": units}


def init_paged_cache(cfg: ModelConfig, batch: int, n_blocks: int,
                     block_size: int, max_blocks_per_seq: int,
                     dtype: torch.dtype = torch.float32,
                     device: Optional[Union[str, torch.device]] = None,
                     int8_kv: bool = False,
                     max_width: Optional[int] = None,
                     kv_heads: Optional[int] = None) -> dict:
    """Paged decode cache: one block pool per layer, stacked over units,
    plus per-slot block tables (sentinel-filled; serve.paged_kv assigns
    blocks). ``int8_kv`` stores int8 K/V with f32 per-(token, head)
    scales (``attention.init_paged_kv_cache``). Requires a pattern of
    attention and MoE blocks, as the reference's does: recurrent blocks keep
    O(1) state and are served through the slot engine instead.

    Each block position j of the unit has its pools under
    ``units[f"b{j}"]``. Each pool leaf [n_units, n_blocks, ...] is a view
    of a slab with trash blocks behind the pool, which no table names: the
    writes of sentinel entries (padding, IDLE rows) land there, so a step
    writes its KV with no host sync (``attention._store_paged``).
    ``cache["trash_rows"]`` is the trash's size in tokens: at least
    ``batch * max_width``, the entries of the widest step the caller
    makes (default: a step as wide as a sequence, ``max_blocks_per_seq *
    block_size``). A wider step raises. ``kv_heads`` (default the
    config's) makes one shard's head slice of a KV-head-sharded pool."""
    device = resolve_device(device)
    check_supported(cfg)
    unit = cfg.pattern_unit()
    bad = [k for k in unit if k not in KV_KINDS]
    if bad:
        raise ValueError(
            f"{cfg.name}: paged KV needs an attention-only pattern "
            f"(found {bad}); serve this family with ServeConfig(paged=False)")
    if max_width is None:
        max_width = max_blocks_per_seq * block_size
    n_trash = -(-batch * max_width // block_size)

    def pools():
        slabs = _stack([attention.init_paged_kv_cache(
            cfg, n_blocks + n_trash, block_size, dtype, device,
            int8_kv=int8_kv, kv_heads=kv_heads)
            for _ in range(cfg.n_units)])
        return {k: v[:, :n_blocks] for k, v in slabs.items()}
    return {"lens": torch.zeros(batch, dtype=torch.int32, device=device),
            "block_tables": torch.full((batch, max_blocks_per_seq), n_blocks,
                                       dtype=torch.int32, device=device),
            "units": {f"b{j}": pools() for j in range(len(unit))},
            "trash_rows": n_trash * block_size}


def _embed_inputs(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                  vision_embeds: Optional[torch.Tensor] = None,
                  audio_embeds: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """The residual stream's input [B, S, d]: the token embedding (a
    codebook model's tokens [B, S, nc] gather from the flattened [nc*V, d]
    table and sum over nc), plus the frontend stub's embeddings where the
    config has that frontend and the caller gives them: [B, S', d] added
    to the first S' positions."""
    parts = sharding.column_parts(params["embed"])
    rows = sharding.row_parts(params["embed"])
    if parts is not None:
        # embed sharded on d: each shard gathers its columns
        x = sharding.constrain_tp_exact([
            _embed_tokens(e, cfg, tokens.to(e.device)) for e in parts])
    elif rows is not None:
        x = _embed_rows(rows, tokens)
    else:
        x = _embed_tokens(sharding.whole(params["embed"]), cfg, tokens)
    stub = {"vision_stub": vision_embeds,
            "audio_stub": audio_embeds}.get(cfg.frontend)
    if stub is not None:
        pad = x.shape[1] - stub.shape[1]
        x = x + torch.nn.functional.pad(stub.to(x.dtype), (0, 0, 0, pad))
    return x


def _embed_rows(parts, tokens: torch.Tensor) -> torch.Tensor:
    """The lookup in a table split on its vocab rows (a tied embedding
    under the serving layout), on the tokens' device: each shard looks up
    every token in its block (clamped), and each token keeps the row of
    the shard whose block holds it. A selection, so exact."""
    x, lo = None, 0
    t = tokens.long()
    for e in parts:
        n = e.shape[0]
        y = e[(t.to(e.device) - lo).clamp(0, n - 1)].to(tokens.device)
        x = y if x is None else torch.where(
            ((t >= lo) & (t < lo + n))[..., None], y, x)
        lo += n
    return x


def _embed_tokens(emb: torch.Tensor, cfg: ModelConfig,
                  tokens: torch.Tensor) -> torch.Tensor:
    """The token embedding of ``tokens`` from the table ``emb`` (or a
    block of its columns)."""
    if cfg.n_codebooks:
        nc, V, d = emb.shape
        if tokens.dim() != 3 or tokens.shape[-1] != nc:
            # the reference's gather fails to broadcast such tokens too
            raise ValueError(f"{cfg.name}: a codebook model takes tokens "
                             f"[B, S, {nc}], got {tuple(tokens.shape)}")
        idx = tokens.long() + V * torch.arange(nc, device=tokens.device)
        return emb.reshape(nc * V, d)[idx].sum(dim=2)
    return emb[tokens.long()]


def _positions(cfg: ModelConfig, lens: torch.Tensor, S: int,
               mrope_positions: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """Each row's positions lens[b] + [0, S): i32[B, S], or for M-RoPE
    [3, B, S], the caller's ``mrope_positions`` where given, else the
    three channels equal (text only)."""
    if cfg.mrope and mrope_positions is not None:
        return mrope_positions
    pos = lens[:, None] + torch.arange(S, dtype=lens.dtype,
                                       device=lens.device)[None, :]
    return pos.expand(3, *pos.shape) if cfg.mrope else pos


def _mrope_sections(cfg: ModelConfig):
    """The M-RoPE split of the d_head//2 frequency slots into temporal,
    height and width sections: (16, 24, 24) at d_head 128."""
    half = cfg.d_head // 2
    t = half // 4
    h = (half - t) // 2
    return (t, h, half - t - h)


def _rope_tables(cfg: ModelConfig, positions: torch.Tensor):
    if cfg.pos_emb != "rope":
        # the identity rotation
        if cfg.mrope:
            positions = positions[0]
        shape = tuple(positions.shape) + (cfg.d_head // 2,)
        return (torch.ones(shape, dtype=torch.float32,
                           device=positions.device),
                torch.zeros(shape, dtype=torch.float32,
                            device=positions.device))
    if cfg.mrope:
        return rope.mrope_cos_sin(positions, cfg.d_head, cfg.rope_theta,
                                  sections=_mrope_sections(cfg))
    return rope.rope_cos_sin(positions, cfg.d_head, cfg.rope_theta)


def _add_positions(cfg: ModelConfig, x: torch.Tensor,
                   positions: torch.Tensor) -> torch.Tensor:
    """The sinusoidal position table added to the residual stream where
    the config has one (musicgen); M-RoPE's first channel where both."""
    if cfg.pos_emb != "sin":
        return x
    p1 = positions[0] if cfg.mrope else positions
    return x + layers.sinusoidal_positions(p1, cfg.d_model).to(x.dtype)


def block_forward(kind: str, p: dict, cfg: ModelConfig, x: torch.Tensor,
                  ctx: dict, cache: Optional[dict]):
    """One block over a whole prompt at positions [0, S). An attention
    block runs causal attention (writing the cache at [0, S) when given)
    and the dense FFN, an MoE block the same attention and the routed
    experts; a recurrent block runs its parallel form and, with a cache,
    leaves its final state there. Returns (x, the block's aux loss: the
    MoE load-balance term, else 0)."""
    if kind == "shared_attn":
        p = ctx["shared_params"]
    if kind in KV_KINDS:
        h = layers.rms_norm(x, p["norm1"], cfg.norm_eps)
        x = x + attention.attn_forward(p["attn"], cfg, h, ctx["cos"],
                                       ctx["sin"], cache=cache)
        h = layers.rms_norm(x, p["norm2"], cfg.norm_eps)
        if "moe" in p:
            y, aux = moe.moe_forward(p["moe"], cfg, h)
            return x + y, aux
        return x + ffn.ffn_forward(p["ffn"], cfg, h), 0.0
    if kind == "mamba2":
        h = layers.rms_norm(x, p["norm"], cfg.norm_eps)
        y, new = ssm.mamba2_forward(p["mamba"], cfg, h, cache=cache)
        x = x + y
    elif kind == "mlstm":
        x, new = xlstm.mlstm_block_forward(p, cfg, x, cache=cache)
    elif kind == "slstm":
        x, new = xlstm.slstm_block_forward(p, cfg, x, cache=cache)
    else:
        raise ValueError(kind)
    if cache is not None:
        _write(cache, new)
    return x, 0.0


def block_decode(kind: str, p: dict, cfg: ModelConfig, x: torch.Tensor,
                 ctx: dict, cache: dict) -> torch.Tensor:
    """One block for one token per row. An attention block runs decode
    attention over the slot cache (the decode-attention kernel) and the
    decode FFN (sparse gather under relu_sparse), an MoE block the same
    attention and the routed experts; a recurrent block runs its one-step
    recurrence. The cache is written in place."""
    if kind == "shared_attn":
        p = ctx["shared_params"]
    if kind in KV_KINDS:
        h = layers.rms_norm(x, p["norm1"], cfg.norm_eps)
        x = x + attention.attn_decode(p["attn"], cfg, h, ctx["cos"],
                                      ctx["sin"], cache, ctx["lens"])
        h = layers.rms_norm(x, p["norm2"], cfg.norm_eps)
        return x + _ffn_or_moe(p, cfg, h, ffn.ffn_decode)
    if kind == "mamba2":
        h = layers.rms_norm(x, p["norm"], cfg.norm_eps)
        y, new = ssm.mamba2_decode(p["mamba"], cfg, h, cache)
        x = x + y
    elif kind == "mlstm":
        x, new = xlstm.mlstm_block_decode(p, cfg, x, cache)
    elif kind == "slstm":
        x, new = xlstm.slstm_block_decode(p, cfg, x, cache)
    else:
        raise ValueError(kind)
    _write(cache, new)
    return x


def _ffn_or_moe(p: dict, cfg: ModelConfig, h: torch.Tensor,
                dense) -> torch.Tensor:
    """The second half of an attention or MoE block when serving: ``dense``
    (an FFN path of ``models.ffn``) for an attention block, the routed
    experts for an MoE block (every row routed; the aux loss is a training
    term, which ``forward`` alone returns)."""
    if "moe" in p:
        return moe.moe_forward(p["moe"], cfg, h)[0]
    return dense(p["ffn"], cfg, h)


def _unit_blocks(params: dict, cfg: ModelConfig, cache: Optional[dict],
                 i: int):
    """(kind, params, cache) of each block of unit ``i``: views of the
    stacks (the shared block's params come through ctx)."""
    for j, kind in enumerate(cfg.pattern_unit()):
        p = None if kind == "shared_attn" \
            else _index(params["units"][f"b{j}"], i)
        c = None if cache is None else _index(cache["units"][f"b{j}"], i)
        yield kind, p, c


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            cache: Optional[dict] = None,
            vision_embeds: Optional[torch.Tensor] = None,
            audio_embeds: Optional[torch.Tensor] = None,
            mrope_positions: Optional[torch.Tensor] = None):
    """Full-sequence forward (training, prefill) of tokens i32[B, S] (a
    codebook model's [B, S, nc]) at positions [0, S), M-RoPE's
    ``mrope_positions`` [3, B, S] where given; the frontend stubs'
    embeddings are added to the first positions (``_embed_inputs``).
    With ``cache`` each attention block's K/V land at [0, S) of it and
    each recurrent block's final state in it, in place, and the returned
    cache has lens = S. Returns (hidden [B, S, d], the aux loss f32[]
    summed over the blocks (the MoE load-balance term; 0 without MoE
    blocks), cache or None). Under ``cfg.remat``, with autograd recording
    and no cache, each unit runs under ``torch.utils.checkpoint``."""
    B, S = tokens.shape[:2]
    check_prompt_len(cfg, S)
    x = _embed_inputs(params, cfg, tokens, vision_embeds, audio_embeds)
    positions = _positions(
        cfg, torch.zeros(B, dtype=torch.int32, device=tokens.device), S,
        mrope_positions)
    cos, sin = _rope_tables(cfg, positions)
    x = _add_positions(cfg, x, positions)
    ctx = {"cos": cos, "sin": sin, "shared_params": params.get("shared")}
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)

    def unit(x, aux, i):
        for kind, p, c in _unit_blocks(params, cfg, cache, i):
            x, a = block_forward(kind, p, cfg, x, ctx, c)
            aux = aux + a
        return x, aux

    # the reference's jax.checkpoint(nothing_saveable) of the unit body:
    # the backward recomputes each unit's activations (values unchanged)
    remat = cfg.remat and cache is None and torch.is_grad_enabled()
    for i in range(cfg.n_units):
        if remat:
            x, aux = checkpoint(unit, x, aux, i, use_reentrant=False)
        else:
            x, aux = unit(x, aux, i)
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cache is None:
        return x, aux, None
    return x, aux, {"lens": torch.full_like(cache["lens"], S),
                    "units": cache["units"]}


def decode_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                cache: dict, vision_embeds: Optional[torch.Tensor] = None,
                audio_embeds: Optional[torch.Tensor] = None):
    """One-token decode of every row: tokens i32[B, 1] (a codebook model's
    [B, 1, nc]) at positions cache["lens"] (M-RoPE: all three channels
    there, as the reference's decode step sets them whatever its
    batch_extra holds). The frontend stubs' embeddings, where given, are
    added as in ``forward``. The cache is written in place. Returns
    (logits f32[B, 1, V] or [B, 1, nc, V], the cache with lens + 1)."""
    x = _embed_inputs(params, cfg, tokens, vision_embeds, audio_embeds)
    lens = cache["lens"]
    positions = _positions(cfg, lens, 1)
    cos, sin = _rope_tables(cfg, positions)
    x = _add_positions(cfg, x, positions)
    ctx = {"cos": cos, "sin": sin, "lens": lens,
           "shared_params": params.get("shared")}
    for i in range(cfg.n_units):
        for kind, p, c in _unit_blocks(params, cfg, cache, i):
            x = block_decode(kind, p, cfg, x, ctx, c)
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return (project_logits(params, cfg, x),
            {"lens": lens + 1, "units": cache["units"]})


def block_step_paged(p: dict, cfg: ModelConfig, x: torch.Tensor, ctx: dict,
                     cache: dict) -> torch.Tensor:
    """One attention or MoE block of the serving step: paged attention,
    then for an attention block the per-row FFN select (dense for prefill
    rows, sparse gather for decode and verify rows), for an MoE block the
    routed experts over every row of the step, idle and padding rows
    included (so ``moe.capacity`` counts them, as the reference's)."""
    h = sharding.constrain_tp_exact(
        layers.rms_norm(x, sharding.whole(p["norm1"]), cfg.norm_eps))
    x = x + attention.attn_step_paged(
        p["attn"], cfg, h, ctx["cos"], ctx["sin"], cache, ctx["lens"],
        ctx["n_valid"], ctx["tables"], ctx["block_size"],
        backend=ctx["backend"])
    h = sharding.constrain_tp_exact(
        layers.rms_norm(x, sharding.whole(p["norm2"]), cfg.norm_eps))
    return x + _ffn_or_moe(
        p, cfg, h, lambda fp, c, y: ffn.ffn_step(
            fp, c, y, ctx["is_prefill"], has_prefill=ctx["has_prefill"]))


# elements of a bf16 vocab matrix widened to f32 at a time
_LOGIT_SLICE = 1 << 22


def project_logits(params: dict, cfg: ModelConfig,
                   x: torch.Tensor) -> torch.Tensor:
    """x [B, S, d] -> f32 logits [B, S, V] (a codebook model's
    [B, S, nc, V], one head [d, V] per codebook). An f32 model multiplies
    as it is. A bf16 model keeps its operands' values and sums in f32, as
    the reference's ``preferred_element_type=jnp.float32`` does: the vocab
    matrix is widened to f32 one slice of columns at a time (exact), so
    the logits are never rounded to bf16 and no f32 copy of the matrix
    outlives the call."""
    if cfg.n_codebooks or not cfg.tie_embeddings:
        parts = sharding.column_parts(params["head"])
        if parts is not None:
            # the vocab-sharded head: each shard's logits, concatenated
            return sharding.constrain_tp_exact(
                [_project_head(x.to(h.device), h, cfg) for h in parts])
        return _project_head(x, sharding.whole(params["head"]), cfg)
    rows = sharding.row_parts(params["embed"])
    if rows is not None:
        # a tied embedding split on its vocab rows: each shard's logits,
        # concatenated
        return sharding.constrain_tp_exact(
            [_project(x.to(e.device), e.t()) for e in rows])
    return _project(x, sharding.whole(params["embed"]).t())


def _project_head(x: torch.Tensor, head: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    if cfg.n_codebooks:
        return torch.stack([_project(x, w) for w in head], dim=2)
    return _project(x, head)


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., d] @ w [d, V] in f32, a bf16 ``w`` widened a slice at a
    time."""
    if w.dtype == torch.float32:
        return x @ w
    xf = x.float()
    step = max(1, _LOGIT_SLICE // w.shape[0])
    return torch.cat([xf @ w[:, c:c + step].float()
                      for c in range(0, w.shape[1], step)], dim=-1)


def loss_fn(params: dict, cfg: ModelConfig, batch: dict,
            token_chunk: int = 0):
    """Next-token CE (+ the MoE aux loss) of a batch dict: ``tokens``,
    ``labels`` (i32[B, S], a codebook model's [B, S, nc]), an optional
    ``mask`` f32[B, S] and the inputs ``forward`` takes
    (``vision_embeds``, ``audio_embeds``, ``mrope_positions``).

    The loss is chunked over tokens so the [*, V] logits never exist for
    the whole sequence (vocab up to 202k): chunks of 2**26 // vocab tokens
    (cut to divide S), each under ``torch.utils.checkpoint`` while autograd
    records, so its logits are recomputed in the backward. A codebook
    model's mask counts once per codebook. Returns (ce + 0.01 * aux,
    {"ce", "aux", "ppl"})."""
    hidden, aux, _ = forward(
        params, cfg, batch["tokens"],
        vision_embeds=batch.get("vision_embeds"),
        audio_embeds=batch.get("audio_embeds"),
        mrope_positions=batch.get("mrope_positions"))
    labels, mask = batch["labels"], batch.get("mask")
    B, S, _ = hidden.shape
    if token_chunk <= 0:
        token_chunk = max(1, min(S, int(2 ** 26 // max(cfg.vocab, 1)) or 1))
    n_chunks = max(1, S // token_chunk)
    while S % n_chunks:
        n_chunks -= 1
    tc = S // n_chunks
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=hidden.device)

    def chunk_loss(h, y, m):
        logits = project_logits(params, cfg, h)
        if cfg.n_codebooks:
            m = m[..., None] * torch.ones(cfg.n_codebooks, device=m.device)
        return layers.softmax_cross_entropy(logits, y, m), m.sum()

    ces, ws = [], []
    for c in range(n_chunks):
        args = (hidden[:, c * tc:(c + 1) * tc], labels[:, c * tc:(c + 1) * tc],
                mask[:, c * tc:(c + 1) * tc])
        ce, w = (checkpoint(chunk_loss, *args, use_reentrant=False)
                 if torch.is_grad_enabled() else chunk_loss(*args))
        ces.append(ce)
        ws.append(w)
    ces, ws = torch.stack(ces), torch.stack(ws)
    ce = (ces * ws).sum() / torch.clamp(ws.sum(), min=1.0)
    return ce + 0.01 * aux, {"ce": ce, "aux": aux, "ppl": torch.exp(ce)}


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
    A codebook model's tokens are [B, S, nc]. M-RoPE positions are text
    only (three equal channels), as the reference's step sets them.
    Returns logits f32[B, S, V] (or [B, S, nc, V])."""
    x = sharding.constrain_tp_exact(_embed_inputs(params, cfg, tokens))
    S = tokens.shape[1]
    lens = cache["lens"]
    positions = _positions(cfg, lens, S)
    cos, sin = _rope_tables(cfg, positions)
    x = _add_positions(cfg, x, positions)
    n_blocks = cache["units"]["b0"]["k"].shape[1]
    # IDLE rows write nothing: their tables become all-sentinel (the
    # plain read fills zeros there, kernel 1 reads block 0, each as the
    # reference's read of that backend does)
    tables = torch.where(n_valid[:, None] > 0, cache["block_tables"],
                         n_blocks)
    ctx = {"cos": cos, "sin": sin, "lens": lens, "n_valid": n_valid,
           "is_prefill": is_prefill, "has_prefill": has_prefill,
           "tables": tables, "block_size": block_size, "backend": backend}
    for i in range(cfg.n_units):
        for j, kind in enumerate(cfg.pattern_unit()):
            p = params["shared"] if kind == "shared_attn" \
                else _index(params["units"][f"b{j}"], i)
            layer = dict(_index(cache["units"][f"b{j}"], i),
                         trash_rows=cache["trash_rows"])
            x = sharding.constrain_residual(
                block_step_paged(p, cfg, x, ctx, layer))
    x = sharding.constrain_tp_exact(
        layers.rms_norm(x, params["final_norm"], cfg.norm_eps))
    return project_logits(params, cfg, x)


# ---------------------------------------------------------------------------
# device-resident decode burst (the async engine's loop ticks)


def decode_iteration(params: dict, cfg: ModelConfig, state: dict,
                     sample_fn, block_size: int, backend: str) -> None:
    """One iteration of ``decode_burst``, in place on ``state``, its loop
    state as ``decode_burst`` makes it: the pools under "units" and their
    ``trash_rows`` (``init_paged_cache``), the block
    ``tables``, and ``tok``, ``lens``, ``alive``, ``budget``, ``stops``,
    ``stop_len``, ``hist``, ``emitted``, ``lp``, ``n_emit`` and the
    iteration index ``i`` (a 0-d tensor). The iteration is a width-1
    ``forward_step`` of every live row with no prefill row, a sample, and
    the loop's bookkeeping. A dead row (``alive`` 0) is an IDLE runner
    row: its table goes all-sentinel, so it reads no block and writes only
    the trash blocks. A row dies when it has emitted ``budget`` tokens or
    the last L tokens of its stream (``hist``) end with one of its
    ``stops``. Every shape here is fixed and no device value is read on
    the host, so the iteration can be captured as a CUDA graph and
    replayed (``serve.runner.ModelRunner.decode_burst``). Where ``state``
    has ``logits``, the iteration's f32[B, V] logits are copied there."""
    tok, lens, alive = state["tok"], state["lens"], state["alive"]
    hist, stops, stop_len = state["hist"], state["stops"], state["stop_len"]
    emitted, lp, n_emit, i = (state["emitted"], state["lp"],
                              state["n_emit"], state["i"])
    B, L = hist.shape
    cache = {"lens": lens, "block_tables": state["tables"],
             "units": state["units"], "trash_rows": state["trash_rows"]}
    logits = forward_step(params, cfg, tok[:, None], cache, alive,
                          torch.zeros(B, dtype=torch.bool, device=tok.device),
                          block_size, backend=backend, has_prefill=False)
    last = logits[:, 0].float()
    if "logits" in state:
        state["logits"].copy_(last)
    ntok, nlp = sample_fn(last, i)
    ntok = ntok.to(torch.int32)
    live = alive > 0
    col = (torch.arange(emitted.shape[1], device=tok.device)[None, :] == i) \
        & live[:, None]
    emitted.copy_(torch.where(col, ntok[:, None], emitted))
    lp.copy_(torch.where(col, nlp[:, None].to(lp.dtype), lp))
    hist.copy_(torch.where(live[:, None],
                           torch.cat([hist[:, 1:], ntok[:, None]], dim=1),
                           hist))
    n_emit.add_(live.to(n_emit.dtype))
    pos_mask = torch.arange(L, device=tok.device)[None, None, :] \
        < (L - stop_len[:, :, None])
    matched = ((pos_mask | (hist[:, None, :] == stops)).all(dim=-1)
               & (stop_len > 0)).any(dim=-1)
    alive.copy_((live & ~matched & (n_emit < state["budget"]))
                .to(alive.dtype))
    tok.copy_(torch.where(live, ntok, tok))
    lens.add_(live.to(lens.dtype))
    i.add_(1)


def decode_burst(params: dict, cfg: ModelConfig, cache: dict,
                 tables: torch.Tensor, tok0: torch.Tensor,
                 lens0: torch.Tensor, alive0: torch.Tensor,
                 budget: torch.Tensor, stops: torch.Tensor,
                 stop_len: torch.Tensor, hist0: torch.Tensor, sample_fn,
                 block_size: int, backend: str, k_ticks: int, k_max: int):
    """Device-resident decode loop: ``k_ticks`` single-token decode steps
    (``decode_iteration``), each feeding its sampled token back as the
    next step's input without a host round trip.

    Row b goes dead once it has emitted ``budget[b]`` tokens or its
    generated stream ends with a stop: ``stops`` i32[B, NS, L]
    right-aligned (-1 padded) with lengths ``stop_len`` i32[B, NS] (0 =
    unused); ``hist0`` i32[B, L] holds the last L tokens already
    generated, so a stop across the burst boundary still matches. Longer
    stops match on the host at replay. ``sample_fn(last_logits, i) ->
    (tokens [B], logprobs f32[B])`` samples iteration ``i`` (a 0-d device
    tensor, which selects the draw's key).

    The reference's ``lax.while_loop`` also stops once every row is dead;
    this plain loop runs all ``k_ticks`` iterations, and an iteration with
    every row dead changes no state that is read. The pools of ``cache`` are written in
    place (the reference donates them).

    Returns (emitted i32[B, k_max], -1 past each row's last live step;
    logprobs f32[B, k_max]; the cache with the final lens; the final lens;
    n_emit i32[B])."""
    dev = tok0.device
    B = tok0.shape[0]
    # the loop state, updated in place; the inputs are copied, so the
    # caller's tensors stay as they were
    state = {"units": cache["units"], "trash_rows": cache["trash_rows"],
             "tables": tables.clone(),
             "tok": tok0.clone(), "lens": lens0.clone(),
             "alive": alive0.clone(), "budget": budget.clone(),
             "stops": stops.clone(), "stop_len": stop_len.clone(),
             "hist": hist0.clone(),
             "emitted": torch.full((B, k_max), -1, dtype=torch.int32,
                                   device=dev),
             "lp": torch.zeros((B, k_max), dtype=torch.float32, device=dev),
             "n_emit": torch.zeros(B, dtype=torch.int32, device=dev),
             "i": torch.zeros((), dtype=torch.int32, device=dev)}
    for _ in range(int(k_ticks)):
        decode_iteration(params, cfg, state, sample_fn, block_size, backend)
    new_cache = dict(cache, lens=state["lens"])
    return (state["emitted"], state["lp"], new_cache, state["lens"],
            state["n_emit"])
