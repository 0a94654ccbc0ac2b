"""The yardstick's arithmetic against values worked by hand for both
configurations (the figures 8.04 GFLOP and 8.04 GB a token of
qwen3-4b, 6.17 and 6.17 of qwen2.5-3b, 288 and 72 KiB of f32 KV), kernel
1's operations and bytes for a small launch, and the datasheet peaks."""

import json

import numpy as np
import pytest

from bench.harness import cell, counting, model, window_math


def _hf(name):
    return json.loads((cell.BENCH / "configs" / f"{name}.json")
                      .read_text())["config"]


@pytest.mark.parametrize("name,params,flops,nbytes,kv", [
    # per layer 10,485,760 + 5,242,880 + 10,485,760 + 74,711,040, x 36,
    # + the head 2560 x 151936; norms (and qk norms) 196,096 more weights
    ("qwen3-4b", 4_022_272_000, 8_044_544_000, 8_044_936_192, 294_912),
    # per layer 4,194,304 + 1,048,576 + 4,194,304 + 67,633,152, x 36,
    # + the head 2048 x 151936; norms and biases 241,664 more weights
    ("qwen2.5-3b", 3_085_697_024, 6_171_394_048, 6_171_877_376, 73_728),
])
def test_hand_worked_sizes(name, params, flops, nbytes, kv):
    hf = _hf(name)
    assert counting.matmul_params(hf) == params
    assert counting.token_flops(hf, np.zeros(1)) == flops
    assert counting.weight_bytes(hf) == nbytes
    assert model.kv_bytes_per_token(hf) == kv
    assert kv == (288 if name == "qwen3-4b" else 72) * 1024


def test_attention_flops_per_key():
    hf = _hf("qwen3-4b")
    # one token at position 99 attends to 100 keys: 4 * 32 * 128 a key a
    # layer, 36 layers
    extra = counting.token_flops(hf, [100]) - counting.token_flops(hf, [0])
    assert extra == 4 * 32 * 128 * 36 * 100


def test_kernel1_launch_by_hand():
    hf = _hf("qwen3-4b")
    # a decode row at 100, a 4-token chunk at 0, an IDLE row
    ops, nbytes = counting.attention_launch(hf, [100, 0, 50], [1, 4, 0])
    keys = 101 + (1 + 2 + 3 + 4)
    assert ops == 4 * 32 * 128 * keys == 1_818_624
    kv_tok = 2 * 8 * 128 * 4
    assert nbytes == kv_tok * (101 + 4) + 2 * 32 * 128 * 4 * 5 == 1_024_000
    t = counting.least_seconds(ops, nbytes, 66.9e12, 3.35e12)
    assert t == pytest.approx(nbytes / 3.35e12)


def test_peaks_are_the_datasheet_values():
    p = counting.PEAKS["NVIDIA H100 80GB HBM3"]
    assert (p["bf16_flops"], p["f32_flops"], p["hbm_bytes"]) == \
        (989.4e12, 66.9e12, 3.35e12)
    assert "cpu" not in counting.PEAKS      # no device share off the card


def test_window_rows_of_a_burst():
    # a burst of 3 iterations: row 0 emits 3 tokens from 10, row 1 two from
    # 20, row 2 is idle
    step = ("burst", 3, np.array([10, 20, 0]), np.array([3, 2, 0]), None)
    passes = list(window_math.rows(step))
    assert [int(v.sum()) for _, v, _ in passes] == [2, 2, 1]
    assert list(window_math.decode_rows(step)) == [2, 2, 1]
    n, keys = 0, 0.0
    for s, v, _ in passes:
        t, k = window_math.ctx_sum(s, v)
        n, keys = n + t, keys + k
    assert (n, keys) == (5, (11 + 12 + 13) + (21 + 22))
    eager = ("step", 4, np.array([0, 7]), np.array([4, 1]), np.array([1, 2]))
    assert list(window_math.decode_rows(eager)) == [1]
    assert window_math.ctx_sum(eager[2], eager[3]) == (5, 10 + 8)
