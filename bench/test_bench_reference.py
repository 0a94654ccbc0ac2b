"""The plain reference (``bench/reference/qwen.py``) against the program at
SMOKE widths on the CPU, in float32: both read the benchmark's weights, so
a fault in the reference (or in the tree the harness hands the program)
shows as a difference of logits far above float32 rounding."""

import json

import numpy as np
import pytest
import torch

from bench.harness import cell, model, smoke
from bench.reference import qwen

CONFIGS = ("qwen3-4b", "qwen2.5-3b")


def _smoke_conf(name):
    conf = json.loads((cell.BENCH / "configs" / f"{name}.json").read_text())
    conf["config"].update(smoke.SMOKE_SIZES)
    return conf


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_matches_the_program_forward(name):
    from repro_torch.models import transformer
    torch.manual_seed(0)
    conf = _smoke_conf(name)
    hf = conf["config"]
    cfg = model.model_config(conf, "float32")
    w = model.make_weights(hf, torch.float32, 1234, torch.device("cpu"))
    tokens = torch.randint(0, hf["vocab_size"], (1, 40))
    with torch.no_grad():
        hidden, _, _ = transformer.forward(model.port_params(w), cfg, tokens)
        ours = transformer.project_logits(model.port_params(w), cfg, hidden)
    ref = qwen.forward(w, hf, tokens[0], list(range(40)))
    assert torch.allclose(ours[0], ref, atol=2e-5, rtol=1e-4), \
        (ours[0] - ref).abs().max()


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_parts_are_used(name):
    """Each published part changes the reference's logits: the qk norms
    (qwen3) or the q/k/v biases (qwen2), and the norm eps."""
    hf = _smoke_conf(name)["config"]
    w = model.make_weights(hf, torch.float32, 7, torch.device("cpu"))
    toks = torch.arange(12) % hf["vocab_size"]
    base = qwen.forward(w, hf, toks, list(range(12)))
    part = "q_norm" if hf["model_type"] == "qwen3" else "k_bias"
    saved = w["layers"][part].clone()
    w["layers"][part].mul_(0.5)
    moved = qwen.forward(w, hf, toks, list(range(12)))
    w["layers"][part].copy_(saved)
    assert (moved - base).abs().max() > 1e-3


def test_fp8_control_is_coarser_than_f32():
    hf = _smoke_conf("qwen3-4b")["config"]
    w = model.make_weights(hf, torch.float32, 3, torch.device("cpu"))
    toks = torch.arange(30) % hf["vocab_size"]
    ref = qwen.forward(w, hf, toks, list(range(30)))
    low = qwen.forward(w, hf, toks, list(range(30)), quant="fp8")
    err = (low - ref).abs().max().item()
    assert 1e-3 < err < 1.0
    x = torch.randn(64, 32)
    r = qwen.fp8_round(x, -1)
    assert torch.all((r - x).abs() <= x.abs().amax(-1, keepdim=True) / 16)


def test_port_tree_views_the_same_tensors():
    hf = _smoke_conf("qwen2.5-3b")["config"]
    w = model.make_weights(hf, torch.bfloat16, 5, torch.device("cpu"))
    p = model.port_params(w)
    assert p["units"]["b0"]["attn"]["bk"].data_ptr() \
        == w["layers"]["k_bias"].data_ptr()
    assert p["embed"].dtype == torch.bfloat16
    w2 = model.make_weights(hf, torch.bfloat16, 5, torch.device("cpu"))
    assert torch.equal(w["layers"]["down_proj"], w2["layers"]["down_proj"])
    w3 = model.make_weights(hf, torch.bfloat16, 6, torch.device("cpu"))
    assert not torch.equal(w["embed"], w3["embed"])


def test_model_config_follows_the_published_keys():
    conf = json.loads((cell.BENCH / "configs" / "qwen3-4b.json").read_text())
    cfg = model.model_config(conf, "bfloat16")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_head, cfg.d_ff, cfg.vocab) == (36, 2560, 32, 8, 128, 9728,
                                                  151936)
    assert cfg.qk_norm and not cfg.qkv_bias and cfg.tie_embeddings
    assert cfg.norm_eps == 1e-6 and cfg.rope_theta == 1e6
    conf = json.loads((cell.BENCH / "configs" / "qwen2.5-3b.json")
                      .read_text())
    cfg = model.model_config(conf, "bfloat16")
    assert cfg.qkv_bias and not cfg.qk_norm and cfg.d_head == 128
    assert np.isclose(cfg.norm_eps, 1e-6)
