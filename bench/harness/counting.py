"""The yardstick's arithmetic: the card's peaks, a model's operations per
token, and kernel 1's operations and bytes per launch.

Frozen here with the benchmark: nothing reads the program's own cost
model or roofline tables (``repro_torch.obs.costmodel``,
``repro_torch.roofline``), so a change to the program cannot move the
yardstick.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np

# NVIDIA H100 SXM5 datasheet (nvidia.com, "NVIDIA H100 Tensor Core GPU",
# SXM column, dense rates without sparsity), at its 700 W power limit; a
# run prints the card's own power.limit beside the shares it reads.
PEAKS = {"NVIDIA H100 80GB HBM3": {"bf16_flops": 989.4e12,
                                   "f32_flops": 66.9e12,
                                   "hbm_bytes": 3.35e12}}


def _dims(hf: dict):
    dh = hf.get("head_dim") or hf["hidden_size"] // hf["num_attention_heads"]
    return (hf["num_hidden_layers"], hf["hidden_size"],
            hf["num_attention_heads"], hf["num_key_value_heads"], dh,
            hf["intermediate_size"], hf["vocab_size"])


def matmul_params(hf: dict) -> int:
    """Weights a token multiplies by: q, k, v, o and the SwiGLU's three
    matrices in every layer, and the (tied) head once. Norms and biases
    (adds, not products) are left out."""
    n, d, hq, kv, dh, f, v = _dims(hf)
    per_layer = d * hq * dh + 2 * d * kv * dh + hq * dh * d + 3 * d * f
    return n * per_layer + d * v


def weight_bytes(hf: dict, dtype_bytes: int = 2) -> int:
    """Bytes of every weight, norms and biases included."""
    n, d, hq, kv, dh, f, v = _dims(hf)
    extra = n * 2 * d + d
    if hf["model_type"] == "qwen2":
        extra += n * (hq + 2 * kv) * dh
    else:
        extra += n * 2 * dh
    tied = 0 if hf.get("tie_word_embeddings", True) else d * v
    return (matmul_params(hf) + extra + tied) * dtype_bytes


def token_flops(hf: dict, ctx: np.ndarray) -> float:
    """Model operations of tokens that attend to ``ctx`` keys each (the
    token's position + 1): 2 per weight of ``matmul_params``, and in every
    layer 4 * heads * head_dim per key (q.k and p.v)."""
    n, d, hq, kv, dh, f, v = _dims(hf)
    ctx = np.asarray(ctx, np.float64)
    return float(ctx.size * 2.0 * matmul_params(hf)
                 + 4.0 * n * hq * dh * ctx.sum())


def attention_launch(hf: dict, starts: Iterable[int],
                     valid: Iterable[int], pool_bytes: int = 4):
    """(operations, bytes) that one launch of kernel 1 (one layer of one
    step) needs for its live rows: row r has ``valid[r]`` queries at
    positions starts[r] + j, each attending to starts[r] + j + 1 keys.
    Bytes: the row's live K and V, starts[r] + valid[r] tokens, read once
    as the pool stores them, plus q read and the output written in f32.
    Padding queries and IDLE rows are not work these inputs need."""
    n, d, hq, kv, dh, f, v = _dims(hf)
    s = np.asarray(list(starts), np.float64)
    m = np.asarray(list(valid), np.float64)
    live = m > 0
    s, m = s[live], m[live]
    keys = (s * m + m * (m + 1) / 2).sum()
    ops = 4.0 * hq * dh * keys
    nbytes = (2.0 * kv * dh * pool_bytes * (s + m).sum()
              + 2.0 * hq * dh * 4 * m.sum())
    return float(ops), float(nbytes)


def least_seconds(ops: float, nbytes: float, flops_per_s: float,
                  bytes_per_s: float) -> float:
    """The roofline: the larger of the compute and the memory time."""
    return max(ops / flops_per_s, nbytes / bytes_per_s)
