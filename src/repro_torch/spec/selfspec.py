"""Self-speculation: the target model drafts for itself through a cheap
pass.

The Deja-Vu-style predictor (``core.sparsity.SparsityPredictor``) guesses
the FFN's active set from the FFN input, so a draft pass gathers only k of
d_ff up-projection columns AND down-projection rows; attention runs
unchanged. The draft model is the target's own weights behind that FFN:
no second set of weights, and drafts agree with the target wherever the
predictor's active set covers the true one (its recall at k).

The down projection is exactly the gather kernel's function
(``ops.sparse_gather_matvec``, the paper's C2 gather) with idx from the
predictor's top-k; attention is the decode-attention kernel
(``attention.attn_decode``). Calibration trains the predictors against the
target's own FFN activations at build time.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import sparsity
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import attention, layers, transformer
from repro_torch.spec.drafter import ModelDrafter


def predicted_sparse_ffn(pffn: dict, cfg: ModelConfig,
                         pred: sparsity.SparsityPredictor, x: torch.Tensor,
                         k: int) -> torch.Tensor:
    """FFN whose k active units the predictor picks BEFORE the
    up-projection: up columns and down rows are both gathered. x: [B, S,
    d] -> [B, S, d]."""
    act = "relu" if cfg.relu_sparse else cfg.act
    B, S, d = x.shape
    idx, _ = pred.predict_topk(x, k)                       # [B, S, k]
    il = idx.long()
    up_sel = pffn["w_up"].t()[il]                          # [B, S, k, d]
    h = torch.einsum("bsd,bskd->bsk", x, up_sel)
    if "w_gate" in pffn:
        gate_sel = pffn["w_gate"].t()[il]
        h = sparsity.apply_act(
            torch.einsum("bsd,bskd->bsk", x, gate_sel), act) * h
    else:
        h = sparsity.apply_act(h, act)
    out = ops.sparse_gather_matvec(h.reshape(-1, k).float().contiguous(),
                                   idx.reshape(-1, k).contiguous(),
                                   pffn["w_down"])
    return out.reshape(B, S, pffn["w_down"].shape[1]).to(x.dtype)


def selfspec_decode_step(params: dict, cfg: ModelConfig,
                         preds: sparsity.SparsityPredictor, k: int,
                         tokens: torch.Tensor, cache: dict):
    """One draft decode step on a contiguous cache: the target's attention
    and the predictor-gathered FFN. The signature of
    ``transformer.decode_step`` (so ModelDrafter's feed loop is reused);
    the cache's K/V are written in place."""
    x = transformer._embed_inputs(params, cfg, tokens)
    lens = cache["lens"]
    positions = lens[:, None]
    cos, sin = transformer._rope_tables(cfg, positions)
    x = transformer._add_positions(cfg, x, positions)
    units = params["units"]["b0"]
    for i in range(cfg.n_units):
        p = transformer._index(units, i)
        h = layers.rms_norm(x, p["norm1"], cfg.norm_eps)
        x = x + attention.attn_decode(
            p["attn"], cfg, h, cos, sin,
            transformer._index(cache["units"]["b0"], i), lens)
        h = layers.rms_norm(x, p["norm2"], cfg.norm_eps)
        x = x + predicted_sparse_ffn(p["ffn"], cfg, preds.unit(i), h, k)
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return (transformer.project_logits(params, cfg, x),
            {"lens": lens + 1, "units": cache["units"]})


def calibration_targets(cfg: ModelConfig, params: dict,
                        xs: torch.Tensor) -> torch.Tensor:
    """The target's FFN hidden activations at probe inputs xs [N, d], per
    unit: [n_units, N, d_ff]."""
    act = "relu" if cfg.relu_sparse else cfg.act
    ffn_p = params["units"]["b0"]["ffn"]
    return torch.stack([
        sparsity.ffn_hidden(xs, ffn_p["w_up"][u], act,
                            ffn_p["w_gate"][u] if "w_gate" in ffn_p
                            else None)
        for u in range(cfg.n_units)])


def calibrate_predictors(cfg: ModelConfig, params: dict, rank: int,
                         n_samples: int = 256, steps: int = 120,
                         seed: int = 0,
                         device: Optional[Union[str, torch.device]] = None
                         ) -> sparsity.SparsityPredictor:
    """Train one low-rank predictor per unit against the target's own FFN
    hidden activations on random probe inputs. Probe inputs and initial
    predictors come from a ``torch.Generator`` seeded with ``seed`` on
    ``device``. Returns a stacked SparsityPredictor (leading axis:
    units)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    xs = torch.randn((n_samples, cfg.d_model), generator=gen, device=device)
    hs = calibration_targets(cfg, params, xs)
    trained = [sparsity.train_predictor(
        sparsity.SparsityPredictor.init(gen, cfg.d_model, cfg.d_ff,
                                        rank=rank),
        xs, hs[u], steps=steps) for u in range(cfg.n_units)]
    return sparsity.SparsityPredictor(
        torch.stack([p.w_in for p in trained]),
        torch.stack([p.w_out for p in trained]))


class SelfSpecDrafter(ModelDrafter):
    """ModelDrafter whose small model is the target itself behind the
    predictor-gathered sparse FFN: no extra weights, and draft quality
    tracks the predictor's recall at the chosen active fraction.
    ``preds`` injects trained predictors (a stack, leading axis units)
    in place of the calibration."""

    def __init__(self, cfg: ModelConfig, params: dict, max_seq: int, *,
                 frac: float = 0.0625, rank: int = 16,
                 temperature: float = 0.0, seed: int = 0,
                 calibration_steps: int = 120, max_batch: int = 8,
                 device: Optional[Union[str, torch.device]] = None,
                 preds: Optional[sparsity.SparsityPredictor] = None):
        if cfg.pattern_unit() != ("attn",):
            raise ValueError(
                f"{cfg.name}: self-speculation supports plain attention "
                f"stacks only (pattern {cfg.pattern_unit()})")
        self.k_active = sparsity.active_fraction_to_k(cfg.d_ff, frac,
                                                      multiple=16)
        device = resolve_device(device)
        self.preds = preds if preds is not None else calibrate_predictors(
            cfg, params, rank, seed=seed, steps=calibration_steps,
            device=device)
        super().__init__(cfg, params, max_seq, temperature=temperature,
                         seed=seed, max_batch=max_batch, device=device)

    def _make_decode(self):
        preds, k, cfg = self.preds, self.k_active, self.cfg
        return lambda p, t, c: selfspec_decode_step(p, cfg, preds, k, t, c)

    def weight_bytes_per_step(self, scfg) -> float:
        """One self-spec draft step: all attention weights plus the
        predictor-gathered FFN (up columns and down rows at k/d_ff, plus
        the low-rank predictor)."""
        cfg = self.cfg
        bpe = 1 if scfg.int8_decode else 2
        attn = cfg.n_layers * 2 * cfg.d_model \
            * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.d_head * bpe / 2
        rank = self.preds.w_in.shape[-1]
        ffn = cfg.n_layers * sparsity.ffn_weight_bytes_predicted(
            cfg.d_model, cfg.d_ff, bpe, cfg.glu,
            self.k_active / cfg.d_ff, rank)
        return attn + ffn
