"""How far two correct runs of the paper's 60-step training drift apart.

Trains nectar-relu-llama-1.7m for 60 steps (B 8, S 64, lr 3e-3, warm-up
5: ``tests/test_system.py``'s end-to-end setting) from the reference's
``init(PRNGKey(0))`` three ways on the CPU: the reference's train step
jitted, the same step eager (op by op), and the port
(``repro_torch.train.loop.run_training``). Prints the largest |ce
difference| over the first 20 steps and over all 60 of eager against
jitted (the reference against itself) and of the port against jitted:
the drift the bars of ``tests/test_torch_train.py`` must allow. The eager
run takes a few minutes.

    PYTHONPATH=src python tools/train_drift.py
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.models import Model as JaxModel
from repro.train import data as jdata
from repro.train import optimizer as jopt
from repro.train.loop import make_train_step
from repro_torch.configs import get_config as torch_get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.models import Model
from repro_torch.train import data
from repro_torch.train.loop import run_training
from repro_torch.weights import from_jax_params

NAME, STEPS = "nectar-relu-llama-1.7m", 60
KW = dict(lr=3e-3, warmup_steps=5, total_steps=STEPS, seed=0)


def reference_ce(jit: bool):
    cfg = get_config(NAME)
    step = make_train_step(cfg, JaxTrainConfig(**KW))
    step = jax.jit(step) if jit else step
    src = jdata.TinyStoriesSynth(jdata.DataConfig(
        seq_len=64, batch_size=8, vocab_size=cfg.vocab))
    params = JaxModel(cfg).init(jax.random.PRNGKey(0))
    state = jopt.adam_init(params)
    ce = []
    for i in range(STEPS):
        batch = {k: jnp.asarray(v) for k, v in src.batch_at(i).items()}
        params, state, metrics = step(params, state, batch)
        ce.append(float(metrics["ce"]))
    return ce


def port_ce():
    tcfg = torch_get_config(NAME)
    params = from_jax_params(jax.tree.map(
        np.asarray, JaxModel(get_config(NAME)).init(jax.random.PRNGKey(0))),
        tcfg, device="cpu")
    src = data.TinyStoriesSynth(data.DataConfig(
        seq_len=64, batch_size=8, vocab_size=tcfg.vocab))
    _, _, info = run_training(Model(tcfg), tcfg, TrainConfig(**KW), src,
                              steps=STEPS, params=params, log_every=1,
                              device="cpu")
    return [m["ce"] for _, m in info["history"]]


def drift(a, b):
    d = [abs(x - y) for x, y in zip(a, b)]
    return {"first20": max(d[:20]), "all": max(d),
            "at_step": int(np.argmax(d))}


def main():
    jax.config.update("jax_default_matmul_precision", "highest")
    torch.set_num_threads(1)
    jitted = reference_ce(jit=True)
    eager = reference_ce(jit=False)
    port = port_ce()
    print(json.dumps({"reference_eager_vs_jitted": drift(eager, jitted),
                      "port_vs_reference_jitted": drift(port, jitted),
                      "ce_first_last": [jitted[0], jitted[-1]]}))


if __name__ == "__main__":
    main()
