"""Plain float32 reference of the Qwen2 and Qwen3 decoders.

Written from the published descriptions (the Qwen2 technical report,
arXiv:2407.10671, and the Hugging Face ``Qwen2ForCausalLM`` /
``Qwen3ForCausalLM`` definitions of ``config.json``'s keys): token
embedding; per layer an RMSNorm, grouped-query attention with rotary
positions (the half-split "rotate_half" pairing, inverse frequencies
``theta ** (-2i / head_dim)``), a bias on q, k and v (Qwen2) or an RMSNorm
of every q and k head (Qwen3), the output projection, a second RMSNorm and
the SwiGLU feed-forward ``down(silu(gate(x)) * up(x))``; a final RMSNorm and
the tied head ``x @ embed.T``.

Only ``torch`` is used: no kernel, cache or batching of the program under
test. Every product runs in float32 with TF32 off (``f32_matmul``). The
weights are the benchmark's own dict (``harness.weights``), read in any
float dtype and widened a layer at a time, so the whole model never
exists in float32 at once.

``quant="fp8"`` is the control of the correctness check: the same forward
with every weight matrix and every activation that enters a matrix
product rounded to float8 e4m3 (per output column and per token, scaled
to the format's largest value), the nearest precision below the bfloat16
that the configurations state.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence

import torch

FP8_MAX = 448.0          # largest finite float8 e4m3fn value
Q_BLOCK = 1024           # query rows of one block of the attention


@contextlib.contextmanager
def f32_matmul():
    """Products in true float32: TF32 off for cuBLAS and cuDNN."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def fp8_round(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along ``dim``
    (amax over ``dim`` mapped to the format's largest value), returned in
    float32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _mm(x: torch.Tensor, w: torch.Tensor, quant: Optional[str]
        ) -> torch.Tensor:
    """x [T, k] @ w [k, n] in float32 (``quant="fp8"``: both operands
    rounded to e4m3 first, x per token, w per output column)."""
    w = w.float()
    if quant == "fp8":
        x, w = fp8_round(x, -1), fp8_round(w, 0)
    return x @ w


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x [T, H, Dh] rotated by positions pos [T] (rotate_half pairing)."""
    dh = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float64,
                                        device=x.device) / dh))
    ang = pos.double()[:, None] * inv[None, :]
    cos = torch.cat([ang.cos(), ang.cos()], -1).float()[:, None, :]
    sin = torch.cat([ang.sin(), ang.sin()], -1).float()[:, None, :]
    half = dh // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], -1)
    return x * cos + rot * sin


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
              ) -> torch.Tensor:
    """Causal grouped-query attention of one sequence, q [T, Hq, Dh], k and
    v [T, Kv, Dh], in query blocks of Q_BLOCK rows. Returns [T, Hq, Dh]."""
    T, hq, dh = q.shape
    g = hq // k.shape[1]
    k = k.repeat_interleave(g, dim=1).transpose(0, 1)      # [Hq, T, Dh]
    v = v.repeat_interleave(g, dim=1).transpose(0, 1)
    out = torch.empty_like(q)
    for s in range(0, T, Q_BLOCK):
        e = min(T, s + Q_BLOCK)
        qb = q[s:e].transpose(0, 1)                         # [Hq, b, Dh]
        sc = (qb @ k[:, :e].transpose(1, 2)) * dh ** -0.5   # [Hq, b, e]
        keep = torch.arange(e, device=q.device)[None, :] \
            <= torch.arange(s, e, device=q.device)[:, None]
        sc = sc.masked_fill(~keep, float("-inf"))
        out[s:e] = (sc.softmax(-1) @ v[:, :e]).transpose(0, 1)
    return out


def forward(weights: Dict[str, object], hf: dict, tokens: torch.Tensor,
            judge: Sequence[int], quant: Optional[str] = None
            ) -> torch.Tensor:
    """float32 logits [len(judge), vocab] of one sequence ``tokens`` [T] at
    the positions ``judge`` (logits at position p predict token p + 1).

    ``hf`` holds the configuration's published keys (``model_type``
    "qwen2" or "qwen3", hidden_size, num_attention_heads,
    num_key_value_heads, head_dim where given, rms_norm_eps, rope_theta).
    ``weights``: "embed" [V, d], "final_norm" [d] and under "layers" the
    per-layer leaves stacked on a leading [n_layers] axis, each product's
    weight stored [in, out]."""
    eps = float(hf["rms_norm_eps"])
    theta = float(hf["rope_theta"])
    hq, kv = hf["num_attention_heads"], hf["num_key_value_heads"]
    dh = hf.get("head_dim") or hf["hidden_size"] // hq
    qk_norm = hf["model_type"] == "qwen3"
    L = weights["layers"]
    n_layers = L["q_proj"].shape[0]
    T = tokens.shape[0]
    pos = torch.arange(T, device=tokens.device)
    with f32_matmul(), torch.no_grad():
        x = weights["embed"][tokens.long()].float()
        for i in range(n_layers):
            h = rms_norm(x, L["input_norm"][i], eps)
            q = _mm(h, L["q_proj"][i], quant)
            k = _mm(h, L["k_proj"][i], quant)
            v = _mm(h, L["v_proj"][i], quant)
            if "q_bias" in L:
                q = q + L["q_bias"][i].float()
                k = k + L["k_bias"][i].float()
                v = v + L["v_bias"][i].float()
            q, k, v = (q.view(T, hq, dh), k.view(T, kv, dh),
                       v.view(T, kv, dh))
            if qk_norm:
                q = rms_norm(q, L["q_norm"][i], eps)
                k = rms_norm(k, L["k_norm"][i], eps)
            q, k = rope(q, pos, theta), rope(k, pos, theta)
            o = attention(q, k, v).reshape(T, hq * dh)
            x = x + _mm(o, L["o_proj"][i], quant)
            h = rms_norm(x, L["post_norm"][i], eps)
            act = torch.nn.functional.silu(_mm(h, L["gate_proj"][i], quant))
            x = x + _mm(act * _mm(h, L["up_proj"][i], quant),
                        L["down_proj"][i], quant)
        x = rms_norm(x[list(judge)], weights["final_norm"], eps)
        return _mm(x, weights["embed"].t(), quant)
