"""A configuration file to the program's ModelConfig and ServeConfig, and
the weights the benchmark makes from the seed.

A configuration file (``bench/configs/<name>.json``) holds the published
``config.json`` keys under ``config``, the registry entry of the program
that serves the family (``registry``), the serving settings (``serve``,
ServeConfig fields; a traffic mix may set more), and ``source``,
``reduced``, ``assumed`` and ``deployment``.

The weights are the benchmark's, not the program's: one dict of stacked
leaves (``reference.qwen``'s layout) made on the device from the seed by
one ``torch.Generator``, one draw a leaf over all layers at once, in the
dtype served. The program gets views of the same tensors in its parameter
tree (``port_params``); the reference reads the dict itself.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

NORM_JITTER = 0.1       # norm weights 1 + N(0, 0.1): every norm is used
BIAS_STD = 0.1          # q/k/v biases N(0, 0.1)

# published config.json key -> the program's ModelConfig field
_FIELDS = {"num_hidden_layers": "n_layers", "hidden_size": "d_model",
           "num_attention_heads": "n_heads",
           "num_key_value_heads": "n_kv_heads",
           "intermediate_size": "d_ff", "vocab_size": "vocab",
           "head_dim": "d_head", "rms_norm_eps": "norm_eps",
           "rope_theta": "rope_theta",
           "tie_word_embeddings": "tie_embeddings"}


def head_dim(hf: dict) -> int:
    return hf.get("head_dim") or hf["hidden_size"] // hf["num_attention_heads"]


def model_config(conf: dict, dtype: str):
    """The program's ModelConfig: its registry entry with every published
    size and constant of ``conf["config"]`` set, so the run follows the
    published model where the registry differs (the registry's norm eps
    is 1e-5; both models publish 1e-6)."""
    from repro_torch.configs.registry import get_config
    hf = conf["config"]
    base = get_config(conf["registry"])
    kw = {_FIELDS[k]: v for k, v in hf.items() if k in _FIELDS}
    kw["d_head"] = head_dim(hf)
    kw["qk_norm"] = hf["model_type"] == "qwen3"
    kw["qkv_bias"] = hf["model_type"] == "qwen2"
    if hf["hidden_act"] != "silu" or not base.glu:
        raise ValueError(f"{conf['registry']}: the reference is SwiGLU")
    return dataclasses.replace(base, dtype=dtype, **kw)


def serve_config(serve: dict):
    """ServeConfig from JSON: its fields by name, ``async_cfg`` as the
    fields of AsyncConfig."""
    from repro_torch.configs.base import AsyncConfig, ServeConfig
    kw = dict(serve)
    if kw.get("async_cfg") is not None:
        kw["async_cfg"] = AsyncConfig(**kw["async_cfg"])
    names = {f.name for f in dataclasses.fields(ServeConfig)}
    unknown = set(kw) - names
    if unknown:
        raise ValueError(f"not ServeConfig fields: {sorted(unknown)}")
    return ServeConfig(**kw)


def kv_bytes_per_token(hf: dict, pool_bytes: int = 4) -> int:
    """K and V of one token over every layer, as the pool stores them."""
    return (2 * hf["num_hidden_layers"] * hf["num_key_value_heads"]
            * head_dim(hf) * pool_bytes)


def pool_blocks(hf: dict, serve: dict) -> int:
    """Blocks of a pool of ``serve["pool_gib"]`` GiB."""
    per_block = kv_bytes_per_token(hf) * serve["block_size"]
    return int(serve["pool_gib"] * 2 ** 30 // per_block)


def make_weights(hf: dict, dtype: torch.dtype, seed: int,
                 device) -> Dict[str, object]:
    """Random weights from ``seed``: each leaf one normal draw over all
    layers on ``device`` in ``dtype``, scaled by its fan-in ** -0.5 (the
    embedding by d ** -0.5), norms 1 + N(0, NORM_JITTER), biases
    N(0, BIAS_STD)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    d, f, v = hf["hidden_size"], hf["intermediate_size"], hf["vocab_size"]
    n, dh = hf["num_hidden_layers"], head_dim(hf)
    nq, nkv = hf["num_attention_heads"] * dh, hf["num_key_value_heads"] * dh

    def draw(shape, std, mean=0.0):
        t = torch.randn(shape, generator=g, device=device, dtype=dtype)
        t.mul_(std)
        if mean:
            t.add_(mean)
        return t

    layers = {"input_norm": draw((n, d), NORM_JITTER, 1.0),
              "q_proj": draw((n, d, nq), d ** -0.5),
              "k_proj": draw((n, d, nkv), d ** -0.5),
              "v_proj": draw((n, d, nkv), d ** -0.5),
              "o_proj": draw((n, nq, d), nq ** -0.5),
              "post_norm": draw((n, d), NORM_JITTER, 1.0),
              "gate_proj": draw((n, d, f), d ** -0.5),
              "up_proj": draw((n, d, f), d ** -0.5),
              "down_proj": draw((n, f, d), f ** -0.5)}
    if hf["model_type"] == "qwen2":
        for name, width in (("q_bias", nq), ("k_bias", nkv),
                            ("v_bias", nkv)):
            layers[name] = draw((n, width), BIAS_STD)
    else:
        layers["q_norm"] = draw((n, dh), NORM_JITTER, 1.0)
        layers["k_norm"] = draw((n, dh), NORM_JITTER, 1.0)
    return {"embed": draw((v, d), d ** -0.5),
            "final_norm": draw((d,), NORM_JITTER, 1.0),
            "layers": layers}


def port_params(w: Dict[str, object]) -> dict:
    """The program's parameter tree over the same tensors (no copy): one
    attention block a unit, every leaf stacked over the units."""
    L = w["layers"]
    attn = {"wq": L["q_proj"], "wk": L["k_proj"], "wv": L["v_proj"],
            "wo": L["o_proj"]}
    for ours, theirs in (("bq", "q_bias"), ("bk", "k_bias"),
                         ("bv", "v_bias"), ("q_norm", "q_norm"),
                         ("k_norm", "k_norm")):
        if theirs in L:
            attn[ours] = L[theirs]
    return {"embed": w["embed"], "final_norm": w["final_norm"],
            "units": {"b0": {"norm1": L["input_norm"], "attn": attn,
                             "norm2": L["post_norm"],
                             "ffn": {"w_gate": L["gate_proj"],
                                     "w_up": L["up_proj"],
                                     "w_down": L["down_proj"]}}}}
