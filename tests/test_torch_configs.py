"""The dense GLU configs of the port's registry (llama3.2-1b and
granite-34b, CONFIG and SMOKE), on the CPU, against the JAX reference.

Their SMOKE configs have d_head 16 (granite's a single KV head): both
engines of the port serve them on the reference's weights
(``init_params(PRNGKey(0))`` through ``from_jax_params``) with greedy
tokens identical to the reference's.
"""

import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import get_config
from repro.configs.base import ServeConfig as JaxServeConfig
from repro.models import Model as JaxModel
from repro.serve.engine import Engine as JaxEngine
from repro.serve.scheduler import Request as JaxRequest
from repro_torch.configs import get_config as torch_get_config
from repro_torch.configs.base import ServeConfig
from repro_torch.serve.engine import Engine
from repro_torch.serve.scheduler import Request
from repro_torch.weights import from_jax_params


@pytest.mark.parametrize("name", ["llama3.2-1b", "llama3.2-1b-smoke",
                                  "granite-34b", "granite-34b-smoke"])
def test_config_copies_equal_the_reference(name):
    assert dataclasses.asdict(torch_get_config(name)) \
        == dataclasses.asdict(get_config(name))


@pytest.mark.parametrize("kw", [
    dict(paged=True, attn_backend="flash"),
    dict(paged=True, prefix_cache=True),
    dict(paged=False),
])
@pytest.mark.parametrize("name", ["llama3.2-1b-smoke", "granite-34b-smoke"])
def test_smoke_configs_serve_like_the_reference(name, kw):
    cfg = get_config(name)
    assert cfg.d_head == 16
    jparams = JaxModel(cfg).init(jax.random.PRNGKey(0))
    tcfg = torch_get_config(name)
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    rng = np.random.default_rng(4)
    head = rng.integers(0, cfg.vocab, 16, dtype=np.int32)
    prompts = [np.concatenate([head, rng.integers(0, cfg.vocab, int(n),
                                                  dtype=np.int32)])
               for n in (3, 30, 9)]
    base = dict(max_batch=2, max_seq=96, block_size=8, prefill_chunk=16)
    jeng = JaxEngine(cfg, jparams, JaxServeConfig(**dict(base, **kw)))
    want = jeng.run([JaxRequest(rid=i, prompt=p, max_new=8)
                     for i, p in enumerate(prompts)], max_steps=1000)
    eng = Engine(tcfg, tparams, ServeConfig(**dict(base, **kw)),
                 device="cpu")
    got = eng.run([Request(rid=i, prompt=p, max_new=8)
                   for i, p in enumerate(prompts)], max_steps=1000)
    for rid in want:
        assert got[rid].tokens_out == [int(t) for t in want[rid].tokens_out]
    if kw.get("prefix_cache"):
        assert eng.metrics.prefix_hits == jeng.metrics.prefix_hits >= 1
