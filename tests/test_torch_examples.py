"""The port's remaining public names and four of its examples
(``repro_torch.examples``) on the CPU, against the reference.

  * ``configs.list_configs``, ``serve.sampling.GREEDY``,
    ``models.layers.layer_norm`` (within 1e-6) and
    ``ops.paged_decode_attention`` (the S=1 wrapper over kernel 1's plain
    version; kv_len counts the in-flight token) against the reference's,
    the last in interpret mode, with kv_len 1 and sentinel entries;
  * quickstart: three training steps, then its greedy decode equal to the
    reference model's prefill and decode steps on the same weights;
  * sparse_serving and profile_serve: the example's serve against the
    same calls through the reference's engine on the reference's weights
    (``Model(cfg).init(PRNGKey(0))`` through ``from_jax_params``): greedy
    tokens and integer counters equal;
  * multipod_dryrun_demo: the dry run of one cell in process, into a
    temporary directory, and its row.
Each example's ``main`` also runs under ``--device cpu``.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.configs import list_configs as jax_list_configs
from repro.configs.base import ObsConfig as JaxObsConfig
from repro.configs.base import ServeConfig as JaxServeConfig
from repro.kernels import decode_attn as jax_decode_attn
from repro.models import Model as JaxModel
from repro.models import layers as jax_layers
from repro.serve import sampling as jax_sampling
from repro.serve.engine import Engine as JaxEngine
from repro.serve.scheduler import Request as JaxRequest
from repro_torch import configs
from repro_torch.configs import get_config as torch_get_config
from repro_torch.examples import (multipod_dryrun_demo, profile_serve,
                                  quickstart, sparse_serving)
from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.roofline import analysis
from repro_torch.serve import sampling
from repro_torch.weights import from_jax_params


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for the module: the serves' small eager ops crawl
    when torch's threads oversubscribe a host that runs other test
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def nectar():
    cfg = get_config("nectar-relu-llama-1.7m")
    jparams = JaxModel(cfg).init(jax.random.PRNGKey(0))
    tcfg = torch_get_config(cfg.name)
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return cfg, jparams, tcfg, tparams


def to_jax(tree):
    """A port param tree as the reference's (same keys, jnp leaves)."""
    if isinstance(tree, dict):
        return {k: to_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree.detach().cpu().numpy())


def int_keys(summary):
    """The summary's integer entries (counters), bools left out."""
    return {k: v for k, v in summary.items()
            if isinstance(v, int) and not isinstance(v, bool)}


# ---------------------------------------------------------------------------
# the remaining public names


def test_list_configs_equals_the_references():
    assert configs.list_configs() == jax_list_configs()
    assert configs.list_configs() == sorted(configs.REGISTRY)


def test_greedy_equals_the_references():
    assert dataclasses.asdict(sampling.GREEDY) \
        == dataclasses.asdict(jax_sampling.GREEDY)
    assert sampling.GREEDY.is_greedy


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_equals_the_references(dtype):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((4, 7, 48)) * 3 + 1).astype(np.float32)
    gamma = rng.standard_normal(48).astype(np.float32)
    beta = rng.standard_normal(48).astype(np.float32)
    tdt = getattr(torch, dtype)
    got = layers.layer_norm(torch.tensor(x).to(tdt), torch.tensor(gamma),
                            torch.tensor(beta), eps=1e-5)
    want = jax_layers.layer_norm(jnp.asarray(x).astype(dtype),
                                 jnp.asarray(gamma), jnp.asarray(beta),
                                 eps=1e-5)
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=1e-6 if dtype == "float32" else 1e-2,
                               rtol=0 if dtype == "float32" else 1e-2)


@pytest.mark.parametrize("Hq,Kv,Dh,bs", [(4, 4, 32, 16), (8, 2, 16, 8)])
def test_paged_decode_attention_equals_the_reference_wrapper(Hq, Kv, Dh, bs):
    """kv_len 1, a context ending on a block boundary, one spanning
    several blocks with sentinels after it, and an IDLE row whose table is
    all sentinel (read as block 0 by both)."""
    rng = np.random.default_rng(Hq * Dh)
    nb, MB = 24, 8
    kv_len = np.array([1, 2 * bs, 3 * bs + 5, 1], np.int32)
    B = len(kv_len)
    tables = np.full((B, MB), nb, np.int32)
    free = list(rng.permutation(nb))
    for b in range(B - 1):
        n = -(-int(kv_len[b]) // bs)
        tables[b, :n] = [free.pop() for _ in range(n)]
    q = rng.standard_normal((B, Hq, Dh)).astype(np.float32)
    kp, vp = (rng.standard_normal((nb, bs, Kv, Dh)).astype(np.float32)
              for _ in range(2))
    got = ops.paged_decode_attention(*(torch.tensor(a) for a in
                                       (q, kp, vp, tables, kv_len)))
    want = jax_decode_attn.paged_decode_attention(
        *(jnp.asarray(a) for a in (q, kp, vp, tables, kv_len)),
        block_size=bs, interpret=True)
    assert got.shape == (B, Hq, Dh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# quickstart


def _reference_decode(cfg, params, prompt, n_new=12):
    """The reference example's greedy continuation."""
    model = JaxModel(cfg)
    cache = model.init_cache(1, 64, jnp.float32)
    logits, cache = model.prefill(
        params, {"tokens": jnp.asarray([prompt], jnp.int32)}, cache)
    toks = [int(jnp.argmax(logits[0, -1]))]
    for _ in range(n_new):
        lg, cache = model.decode_step(
            params, jnp.asarray([[toks[-1]]], jnp.int32), cache)
        toks.append(int(jnp.argmax(lg[0, 0])))
    return toks


def test_quickstart_trains_and_decodes_as_the_reference(nectar, capsys):
    cfg, _, tcfg, _ = nectar
    out = quickstart.main(["--device", "cpu", "--steps", "3"])
    assert [s for s, _ in out["history"]] == [0, 2]
    assert all(np.isfinite(m["ce"]) for _, m in out["history"])
    assert out["prompt"] == [int(t) for t in quickstart.source(tcfg)
                             .batch_at(999)["tokens"][0, :8]]
    assert len(out["decoded"]) == 13
    assert out["decoded"] == _reference_decode(cfg, to_jax(out["params"]),
                                               out["prompt"])
    assert "decoded:" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# sparse_serving


def test_sparse_serving_equals_the_references_engine(nectar):
    cfg, jparams, tcfg, tparams = nectar
    got = sparse_serving.serve(tcfg, tparams, "cpu")
    reqs = [JaxRequest(rid=r.rid, prompt=r.prompt, max_new=r.max_new)
            for r in sparse_serving.requests(tcfg)]
    eng = JaxEngine(cfg, jparams, JaxServeConfig(max_batch=2, max_seq=64))
    done = eng.run(reqs, max_steps=200)
    assert got["tokens"] == {rid: [int(t) for t in r.tokens_out]
                             for rid, r in sorted(done.items())}
    assert got["steps"] == len(eng.stats)
    assert got["n_slots"] == eng.alloc.n_slots
    s = eng.stats[-1]
    assert got["last_step"] == {
        "weight_bytes": s.weight_bytes, "kv_bytes": s.kv_bytes,
        "sparse_savings_bytes": s.sparse_savings_bytes}


def test_sparse_serving_main_reports_the_cards_placement(capsys):
    out = sparse_serving.main(["--device", "cpu"])
    from repro_torch.core import heterogeneous
    from repro_torch.roofline import hw
    cfg = torch_get_config("nectar-relu-llama-1.7m")
    assert out["regimes"] == heterogeneous.decode_regime_report(
        cfg.d_model, cfg.d_ff, cfg.vocab, batch=4, chip=hw.H100_SXM)
    assert len(out["tokens"]) == 6
    assert 0 < out["kv_rel_err"] < 0.01
    assert "at the H100 SXM" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# profile_serve


def test_profile_serve_equals_the_references_engine(nectar):
    cfg, jparams, tcfg, tparams = nectar
    got = profile_serve.serve(tcfg, tparams, "cpu")
    eng = JaxEngine(cfg, jparams, JaxServeConfig(
        max_batch=4, max_seq=96, paged=True, block_size=8, prefill_chunk=16,
        obs=JaxObsConfig(enabled=True, profile=True)))
    rng = np.random.default_rng(0)
    reqs = [JaxRequest(rid=i,
                       prompt=rng.integers(0, cfg.vocab,
                                           size=4 + int(rng.integers(0, 8)),
                                           dtype=np.int32),
                       max_new=12)
            for i in range(6)]
    eng.run(reqs, max_steps=2000)
    assert got["tokens"] == {r.rid: [int(t) for t in r.tokens_out]
                             for r in reqs}
    want_rows = eng.profiler.report(eng.tracer.tick_stats)
    assert [(r["bucket"], r["ticks"]) for r in got["rows"]] \
        == [(r["bucket"], r["ticks"]) for r in want_rows]
    assert int_keys(got["summary"]) \
        == int_keys(eng.metrics.summary())
    assert {r["bucket"] for r in got["summary"]["bucket_attainment"]} \
        == {"decode", "prefill16"}
    assert len(got["gauges"]) == len(want_rows)


def test_profile_serve_main_runs(capsys):
    out = profile_serve.main(["--device", "cpu"])
    assert 0 < out["decode"]["attain"] <= 1
    assert "bucket_attainment_attainment" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# multipod_dryrun_demo


def test_multipod_dryrun_demo_counts_one_cell(tmp_path, monkeypatch):
    monkeypatch.setattr(analysis, "ART_DIR", str(tmp_path))
    out = multipod_dryrun_demo.main(["--device", "cpu"])
    assert set(out["records"]) == {"pod", "multipod"}
    assert all(r["ok"] for r in out["records"].values())
    assert out["records"]["multipod"]["mesh"]["n_devices"] == 512
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "llama3.2-1b__decode_32k__multipod.json",
        "llama3.2-1b__decode_32k__pod.json"]
    # compared as JSON text: the row's HLO byte diagnostic is NaN
    assert json.dumps(out["row"]) == json.dumps(
        analysis.cell_roofline("llama3.2-1b", "decode_32k"))
    assert out["row"]["ok"] and out["hint"].startswith("memory-bound")
