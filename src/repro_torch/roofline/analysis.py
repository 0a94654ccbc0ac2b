"""Roofline analysis over the port's dry-run records.

Reads build/dryrun/<arch>__<shape>__pod.json (``launch.dryrun``) and
derives, per cell:

  compute term    = FLOPs_global            / (chips * peak_bf16)
  memory term     = HBM_bytes_global        / (chips * hbm_bw)
  collective term = collective_bytes_global / (chips * link_bw)

The port has no XLA, so every term is the reference's analytic model
(its fallback branch, ``method == "analytic"``): the FLOPs are
``analytic_hlo_flops`` (the matmul term with the backward and remat
multipliers, plus attention, SSD, mLSTM and sLSTM terms), the bytes
``analytic_hlo_bytes`` and the link bytes ``analytic_collective_bytes``.
MODEL_FLOPS is the analytic 6*N*D (train) / 2*N*D (prefill) /
2*N_active*B (decode) with N = non-embedding params (active only, for
MoE). The chip defaults to the H100 SXM the port runs on; ``fits_hbm``
judges a cell's analytic per-device memory against that chip's
``hbm_gib``.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict, Optional

from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES, ModelConfig, applicable_shapes
from repro_torch.roofline import hw

ART_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "build", "dryrun")


def n_moe_layers(cfg: ModelConfig) -> int:
    return sum(1 for k in cfg.layer_kinds() if k == "moe")


def non_embed_params(cfg: ModelConfig, active_only: bool = True) -> float:
    """Analytic non-embedding param count; MoE counts routed-active +
    shared experts when active_only."""
    total = cfg.param_count()
    emb = cfg.vocab * cfg.d_model * (cfg.n_codebooks or 1)
    head = 0 if cfg.tie_embeddings else emb
    n = total - emb - head
    if cfg.n_experts and active_only:
        e_f = (3 if cfg.glu else 2) * cfg.d_model * cfg.d_ff
        inactive = (cfg.n_experts - cfg.top_k) * e_f * n_moe_layers(cfg)
        n -= inactive
    return float(n)


def model_flops(cfg: ModelConfig, shape_name: str) -> float:
    """Analytic useful FLOPs per step (attention excluded: conservative,
    so the ratio to the counted FLOPs exposes causal and remat
    overcompute)."""
    sh = SHAPES[shape_name]
    tokens = sh["batch"] * sh["seq"]
    n = non_embed_params(cfg)
    if sh["kind"] == "train":
        return 6.0 * n * tokens
    if sh["kind"] == "prefill":
        return 2.0 * n * tokens
    return 2.0 * n * sh["batch"]  # decode: one token per row


def model_bytes(cfg: ModelConfig, shape_name: str) -> float:
    """Analytic minimum HBM bytes per step (params touched once + KV/state
    stream at decode + residual activations)."""
    sh = SHAPES[shape_name]
    bpe = 2.0  # bf16
    n_total = cfg.param_count()
    if cfg.n_experts and sh["kind"] != "train":
        e_f = (3 if cfg.glu else 2) * cfg.d_model * cfg.d_ff
        n_total -= (cfg.n_experts - cfg.top_k) * e_f * n_moe_layers(cfg)
    params_bytes = n_total * bpe
    if sh["kind"] == "train":
        # fwd read + bwd read + grad write + opt update r/w (approx 4x)
        return 4.0 * params_bytes
    if sh["kind"] == "prefill":
        act = sh["batch"] * sh["seq"] * cfg.d_model * bpe * cfg.n_layers
        return params_bytes + act
    # decode: weights + full KV/state read per token
    n_attn = sum(1 for k in cfg.layer_kinds()
                 if k in ("attn", "shared_attn", "moe"))
    kv = (2 * n_attn * sh["batch"] * sh["seq"] * cfg.n_kv_heads
          * cfg.d_head * bpe)
    return params_bytes + kv


def slstm_correction_flops(cfg: ModelConfig, shape_name: str) -> float:
    """Analytic FLOPs of sLSTM recurrences: per step, 4 block-diagonal
    [P,P] matmuls per head: 8*B*S*d*P."""
    if cfg.family != "ssm" or not cfg.slstm_every:
        return 0.0
    sh = SHAPES[shape_name]
    n_slstm = sum(1 for k in cfg.layer_kinds() if k == "slstm")
    P = cfg.d_model // cfg.n_heads
    toks = sh["batch"] * sh["seq"] if sh["kind"] != "decode" else sh["batch"]
    mult = 3.0 if sh["kind"] == "train" else 1.0  # fwd+bwd
    return 8.0 * toks * cfg.d_model * P * n_slstm * mult


def attention_flops(cfg: ModelConfig, shape_name: str) -> float:
    """Analytic attention FLOPs (full blocks, no causal discount, matching
    the blockwise implementation). train: fwd + bwd(2x) + remat-refwd(1x)."""
    sh = SHAPES[shape_name]
    n_attn = sum(1 for k in cfg.layer_kinds()
                 if k in ("attn", "shared_attn", "moe"))
    d_attn = cfg.n_heads * cfg.d_head
    if sh["kind"] == "decode":
        return 4.0 * sh["batch"] * sh["seq"] * d_attn * n_attn
    fwd = 4.0 * sh["batch"] * sh["seq"] ** 2 * d_attn * n_attn
    mult = 4.0 if sh["kind"] == "train" and cfg.remat else \
        (3.0 if sh["kind"] == "train" else 1.0)
    return fwd * mult


def ssd_flops(cfg: ModelConfig, shape_name: str, chunk: int = 128) -> float:
    """Analytic SSD chunked-scan FLOPs (mamba2 blocks)."""
    n_mamba = sum(1 for k in cfg.layer_kinds() if k == "mamba2")
    if not n_mamba:
        return 0.0
    sh = SHAPES[shape_name]
    from repro_torch.models.ssm import ssm_dims
    d_in, H, P, N = ssm_dims(cfg)
    B, S = sh["batch"], sh["seq"]
    if sh["kind"] == "decode":
        per_tok = 2.0 * H * P * N * 2  # state update + readout
        return per_tok * B * n_mamba
    Q = min(chunk, S)
    nc = S // Q
    per_chunk = (2.0 * Q * Q * N            # C.B scores
                 + 2.0 * Q * Q * H * P      # intra y
                 + 4.0 * Q * H * P * N)     # inter y + state update
    mult = 4.0 if sh["kind"] == "train" and cfg.remat else \
        (3.0 if sh["kind"] == "train" else 1.0)
    return per_chunk * nc * B * n_mamba * mult


def mlstm_flops(cfg: ModelConfig, shape_name: str, block: int = 256) -> float:
    n_m = sum(1 for k in cfg.layer_kinds() if k == "mlstm")
    if not n_m:
        return 0.0
    sh = SHAPES[shape_name]
    d_in = 2 * cfg.d_model
    H = cfg.n_heads
    P = d_in // H
    B, S = sh["batch"], sh["seq"]
    if sh["kind"] == "decode":
        return 4.0 * B * H * P * P * n_m
    blk = min(block, S)
    nb = S // blk
    per_blk = (2.0 * blk * blk * H * P * 2      # qk scores + Sv
               + 4.0 * blk * H * P * P)         # inter + state update
    mult = 4.0 if sh["kind"] == "train" and cfg.remat else \
        (3.0 if sh["kind"] == "train" else 1.0)
    return per_blk * nb * B * n_m * mult


def analytic_hlo_flops(cfg: ModelConfig, shape_name: str) -> float:
    """The step's FLOPs: matmul term (with the backward and remat
    multipliers) + attention + SSD + mLSTM + sLSTM terms."""
    sh = SHAPES[shape_name]
    tokens = sh["batch"] * sh["seq"] if sh["kind"] != "decode" \
        else sh["batch"]
    n = non_embed_params(cfg)
    if sh["kind"] == "train":
        base = (8.0 if cfg.remat else 6.0) * n * tokens
    else:
        base = 2.0 * n * tokens
    return (base + attention_flops(cfg, shape_name)
            + ssd_flops(cfg, shape_name) + mlstm_flops(cfg, shape_name)
            + slstm_correction_flops(cfg, shape_name))


def _expert_params(cfg: ModelConfig) -> float:
    """Routed-expert params (the weight-stationary candidates)."""
    if not cfg.n_experts:
        return 0.0
    e_f = (3 if cfg.glu else 2) * cfg.d_model * cfg.d_ff
    return float(cfg.n_experts * e_f * n_moe_layers(cfg))


def analytic_hlo_bytes(cfg: ModelConfig, shape_name: str,
                       chips: int = 256, tp: int = 16,
                       weight_bpe: float = 2.0, kv_bpe: float = 2.0,
                       ffn_down_frac: float = 1.0,
                       fused_attention: bool = False,
                       moe_ws: bool = False,
                       ws_dense: bool = False) -> float:
    """ACHIEVED global HBM bytes per step for the baseline implementation
    (ideal minimum is model_bytes; the ratio is the memory efficiency).

    Includes the real overheads of the baseline design:
      * train: FSDP gather amplification (every chip writes and reads the
        full gathered weights 3x: fwd, remat-refwd, bwd) plus grads,
        activations (4 passes), f32 logits chunks.
      * decode: weight-stream replication across the dp axis (weights are
        re-read per batch shard, the memory-bound regime the paper
        attacks), full KV read, f32 probs round-trip (a non-fused
        attention; a flash-decode kernel removes it).
      * prefill: params once per dp shard + activations + flash-fused
        attention (no probs round-trip; blockwise path).
    """
    sh = SHAPES[shape_name]
    B, S, kind = sh["batch"], sh["seq"], sh["kind"]
    dp = chips // tp
    bpe = 2.0
    n_total = cfg.param_count()
    if cfg.n_experts and kind != "train":
        e_f = (3 if cfg.glu else 2) * cfg.d_model * cfg.d_ff
        n_total -= (cfg.n_experts - cfg.top_k) * e_f * n_moe_layers(cfg)
    # ReLU-sparse gather: only ffn_down_frac of W_down rows are read
    n_dense_ffn = sum(1 for k in cfg.layer_kinds()
                      if k in ("attn", "shared_attn"))
    w_down_params = n_dense_ffn * cfg.d_model * cfg.d_ff \
        + n_moe_layers(cfg) * (cfg.top_k + cfg.n_shared_experts) \
        * cfg.d_model * cfg.d_ff
    n_eff = n_total - (1.0 - ffn_down_frac) * w_down_params
    params_b = n_eff * weight_bpe
    n_attn = sum(1 for k in cfg.layer_kinds()
                 if k in ("attn", "shared_attn", "moe"))
    kv_b = 2 * n_attn * B * S * cfg.n_kv_heads * cfg.d_head * kv_bpe

    if kind == "train":
        full_params = cfg.param_count() * weight_bpe
        gather_amp = 6.0 * full_params * chips / 1.0 / tp  # 3x (w+r), TP-
        # sharded gathered copies (each chip holds 1/tp of each layer)
        acts = 4.0 * cfg.n_layers * B * S * cfg.d_model * bpe
        logits = 2.0 * B * S * cfg.vocab * 4.0 / tp
        opt_traffic = 3.0 * cfg.param_count() * 4.0
        return gather_amp + acts + logits + opt_traffic
    # serve: weight-stationary MoE reads each expert shard ONCE per step
    # (sharded over all chips); everything else re-reads per dp shard
    if ws_dense:
        weight_traffic = params_b        # every shard read once, globally
    elif moe_ws:
        exp_b = min(_expert_params(cfg) * weight_bpe, params_b)
        weight_traffic = exp_b + (params_b - exp_b) * dp
    else:
        weight_traffic = params_b * dp
    if kind == "prefill":
        acts = 2.0 * cfg.n_layers * B * S * cfg.d_model * bpe
        return weight_traffic + acts + kv_b
    # decode
    probs = 0.0 if fused_attention else \
        2.0 * n_attn * B * cfg.n_heads * S * 4.0  # f32 probs w+r
    acts = 2.0 * cfg.n_layers * B * cfg.d_model * bpe
    logits = B * cfg.vocab * 4.0
    return weight_traffic + kv_b + probs + acts + logits


def analytic_collective_bytes(cfg: ModelConfig, shape_name: str,
                              chips: int = 256, tp: int = 16,
                              seq_shard: Optional[bool] = None,
                              moe_ws: bool = False,
                              ws_dense: bool = False) -> float:
    """Per-step GLOBAL link bytes (sum over chips) from the sharding design.

    train: FSDP weight all-gathers (fwd + remat-refwd + bwd) + gradient
    reduce-scatter + Megatron-SP seq gathers/scatters + vocab-parallel
    logits psum. serve: FSDP gathers (big models) + TP epilogue
    all-reduces (+ LSE partials for seq-sharded KV at decode).
    """
    sh = SHAPES[shape_name]
    dp = chips // tp
    B, S, kind = sh["batch"], sh["seq"], sh["kind"]
    B_l = max(B // dp, 1)
    bpe = 2.0
    params_b = cfg.param_count() * bpe  # full (incl. all experts: FSDP
    # gathers stream every expert's weights regardless of routing)
    if seq_shard is None:
        resid = cfg.n_units * B_l * S * cfg.d_model * bpe / tp
        seq_shard = kind == "train" and resid * tp > 6 * 2 ** 30

    per_chip = 0.0
    if kind == "train":
        per_chip += 3.0 * params_b / tp       # FSDP AG x (fwd, refwd, bwd)
        per_chip += params_b / tp             # grad reduce-scatter
        if seq_shard:
            act = B_l * S * cfg.d_model * bpe
            per_chip += 6.0 * act * cfg.n_layers  # 2 AG + 2 RS per layer x3
        else:
            act = B_l * S * cfg.d_model * bpe
            per_chip += 2.0 * act * cfg.n_layers  # TP all-reduce epilogues
        per_chip += 4.0 * B_l * S * 4.0       # logits lse psums (f32)
        if cfg.n_experts:
            per_chip += 2.0 * B_l * S * cfg.d_model * bpe \
                * n_moe_layers(cfg) / cfg.n_layers * cfg.n_layers / tp
    else:
        big = cfg.param_count() > 30e9
        if big:
            gathered = params_b
            if ws_dense:
                # nothing gathered; every matmul psums its activations
                # ([B, d] partials, tiny at decode) instead
                gathered = 0.0
                per_chip += 5.0 * B_l * cfg.d_model * bpe * cfg.n_layers
            elif moe_ws:
                # expert weights never cross links; their (tiny)
                # activations psum instead: [E/tp, cap, f/dp] partials
                gathered = params_b - min(_expert_params(cfg) * bpe,
                                          params_b)
                cap = max(8, B * cfg.top_k // max(cfg.n_experts, 1))
                per_chip += (cfg.n_experts * cap * cfg.d_ff * bpe
                             * n_moe_layers(cfg) / tp)
            per_chip += gathered / tp
        act = B_l * max(S if kind == "prefill" else 1, 1) \
            * cfg.d_model * bpe
        per_chip += 2.0 * act * cfg.n_layers
        if kind == "decode":
            n_attn = sum(1 for k in cfg.layer_kinds()
                         if k in ("attn", "shared_attn", "moe"))
            lse = B_l * cfg.n_heads * (cfg.d_head + 2) * 4.0
            per_chip += lse * n_attn
    return per_chip * chips


def _policy_overrides(arch: str) -> dict:
    """``launch.dryrun.POLICY_OVERRIDES`` for ``arch``, read only where
    that module is loaded (importing this module never imports it)."""
    dr = sys.modules.get("repro_torch.launch.dryrun")
    return getattr(dr, "POLICY_OVERRIDES", {}).get(arch, {}) if dr else {}


def cell_roofline(arch: str, shape_name: str, chips: int = 256,
                  chip: hw.Chip = hw.H100_SXM) -> Optional[Dict]:
    """Three-term roofline of one dry-run record at ``chip``: compute from
    ``analytic_hlo_flops``, memory from ``analytic_hlo_bytes``, collective
    from ``analytic_collective_bytes`` (every row's ``method`` is
    "analytic"). The record's analytic collective count is kept as the
    diagnostic; there is no HLO byte count (NaN). None where the cell has
    no record."""
    path = os.path.join(ART_DIR, f"{arch}__{shape_name}__pod.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        rec = json.load(f)
    if not rec.get("ok"):
        return {"arch": arch, "shape": shape_name, "ok": False,
                "error": rec.get("error")}
    cfg = get_config(arch)
    moe_ws = bool(_policy_overrides(arch).get("moe_weight_stationary",
                                              False))
    flops_g = analytic_hlo_flops(cfg, shape_name)
    hlo_bytes_g = float("nan")
    hlo_coll_g = (rec["collectives_loopbody_once"]["total_bytes"]
                  * cfg.n_units * chips)
    bytes_g = analytic_hlo_bytes(cfg, shape_name, moe_ws=moe_ws)
    coll_g = analytic_collective_bytes(cfg, shape_name, chips,
                                       moe_ws=moe_ws)
    corr = slstm_correction_flops(cfg, shape_name)

    terms = hw.roofline_terms(flops_g, bytes_g, coll_g, chips, chip)
    mf = model_flops(cfg, shape_name)
    mb = model_bytes(cfg, shape_name)
    useful = mf / max(flops_g, 1.0)
    step_lb = terms["step_s_lower_bound"]
    # roofline fraction: useful work per second at the step lower bound vs
    # the machine's peak
    frac_compute = (mf / step_lb) / (chips * chip.peak_flops) \
        if step_lb > 0 else 0.0
    frac_memory = (mb / step_lb) / (chips * chip.hbm_bw) \
        if step_lb > 0 else 0.0
    return {
        "arch": arch, "shape": shape_name, "ok": True,
        "kind": rec["kind"], "method": "analytic",
        "compute_s": terms["compute_s"],
        "memory_s": terms["memory_s"],
        "collective_s": terms["collective_s"],
        "bound": terms["bound"].replace("_s", ""),
        "step_s_lower_bound": step_lb,
        "hlo_flops_global": flops_g,
        "hlo_bytes_global": bytes_g,
        "collective_bytes_global": coll_g,
        "hlo_bytes_diagnostic": hlo_bytes_g,
        "hlo_collective_diagnostic": hlo_coll_g,
        "model_flops": mf,
        "model_bytes": mb,
        "useful_flops_ratio": useful,
        "useful_bytes_ratio": mb / max(bytes_g, 1.0),
        "roofline_fraction": max(frac_compute, frac_memory),
        "mem_gib_per_device": rec.get("memory_analytic", {}).get(
            "total_gib", rec["memory"]["per_device_total_gib"]),
        "mem_gib_cpu_upper_bound": rec["memory"]["per_device_total_gib"],
        "fits_hbm": rec.get("memory_analytic", {}).get(
            "total_gib", 99.0) < chip.hbm_gib,
        "slstm_correction_flops": corr,
    }


def full_table(chips: int = 256, chip: hw.Chip = hw.H100_SXM):
    """``cell_roofline`` of every dry-run cell that has a record."""
    from repro_torch.launch.dryrun import ARCHS
    rows = []
    for arch in ARCHS:
        cfg = get_config(arch)
        for shape_name in applicable_shapes(cfg):
            row = cell_roofline(arch, shape_name, chips, chip)
            if row is not None:
                rows.append(row)
    return rows


def improvement_hint(row: Dict) -> str:
    """One sentence on what moves the dominant term down."""
    if not row.get("ok"):
        return "cell failed: fix sharding/memory first"
    b = row["bound"]
    if b == "compute":
        if row["useful_flops_ratio"] < 0.5:
            return ("compute-bound with <50% useful FLOPs: cut causal/remat "
                    "overcompute (bounded-kv flash blocks, remat policy)")
        return "compute-bound near useful peak: int8 tensor-core packing next"
    if b == "memory":
        return ("memory-bound: int8 weight streaming (NMCE path) + ReLU "
                "sparsity gather cut the dominant byte stream")
    return ("collective-bound: LSE-combine decode / hierarchical "
            "reduce + int8 gradient compression on the thin axis")


def format_table(rows, chips=256) -> str:
    hdr = (f"{'arch':28s} {'shape':12s} {'bound':10s} {'compute_s':>10s} "
           f"{'memory_s':>10s} {'collect_s':>10s} {'useful_f':>8s} "
           f"{'roofline':>8s} {'HBM_GiB':>8s}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        if not r["ok"]:
            lines.append(f"{r['arch']:28s} {r['shape']:12s} FAILED: "
                         f"{str(r.get('error'))[:60]}")
            continue
        lines.append(
            f"{r['arch']:28s} {r['shape']:12s} {r['bound']:10s} "
            f"{r['compute_s']:10.3e} {r['memory_s']:10.3e} "
            f"{r['collective_s']:10.3e} {r['useful_flops_ratio']:8.2f} "
            f"{r['roofline_fraction']:8.2%} {r['mem_gib_per_device']:8.2f}")
    return "\n".join(lines)


if __name__ == "__main__":
    rows = full_table()
    print(format_table(rows))
    for r in rows:
        if r["ok"]:
            print(f"  {r['arch']} x {r['shape']}: {improvement_hint(r)}")
