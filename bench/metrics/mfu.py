"""Model step: the model operations of the real tokens the window's
device passes processed, prefill and decode (every weight product with
the tied head, and attention at each token's own context;
``counting.token_flops``), over the window's length times the card's
datasheet bf16 dense peak."""

from bench.harness import counting, window_math


def read(run):
    peak = run.peaks.get("bf16_flops")
    if not peak:
        return None
    n = keys = 0
    for s in run.window.steps:
        for starts, valid, _ in window_math.rows(s):
            t, k = window_math.ctx_sum(starts, valid)
            n += t
            keys += k
    if not n:
        return None
    per_token = 2.0 * counting.matmul_params(run.hf)
    hf = run.hf
    dh = hf.get("head_dim") or hf["hidden_size"] // hf["num_attention_heads"]
    attn = 4.0 * hf["num_hidden_layers"] * hf["num_attention_heads"] * dh
    return 100.0 * (n * per_token + attn * keys) / (run.seconds * peak)
