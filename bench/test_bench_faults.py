"""The harness's correctness check, run end to end on the CPU at SMOKE size
(everything of a run but the look for a card): a sound run is correct,
and each fault a served cell can have, planted under the timed path,
turns ``correct`` false. The control (the reference in float8 e4m3 in the
program's place) reads far above a sound run. One chip, so no exchange
between chips to leave out."""

import pytest
import torch

from bench.harness import cell, smoke

CELL = "qwen3-4b.long-decode"
SEED = 2 ** 31 + 7
LIMIT = 0.1          # a SMOKE limit: sound bf16 runs read 0.017-0.024
#                      here, the control 0.39-0.45 (every request judged)


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _run(tmp_path, hook=None, control=False, cell_name=CELL):
    # every finished request judged: the readings do not hang on which
    # requests the CPU's speed lets the window finish
    b, spec = smoke.smoke_bench(tmp_path, cell_name, max_gap=LIMIT,
                                requests=1000)
    return cell.run(cell_name, SEED, 1.5, False, device="cpu", spec=spec,
                    bench=b, hook=hook, control=control)


def test_sound_run_is_correct_and_the_control_is_not(tmp_path):
    out = _run(tmp_path, control=True)
    assert out["correct"], out["checks"]
    assert out["checks"]["max_gap"]["value"] < LIMIT / 2
    assert out["control_max_gap"] > 2 * LIMIT
    assert out["samples"]["finished"] > 3
    assert list(out)[-1] == "checks"
    m = out["metrics"]
    # the long-decode cell reports no TPOT p95 (BENCHMARK.json lists it
    # for the doc cells only)
    assert set(m) == {"output_tokens_per_s", "ttft_p95_ms", "setup_s"}
    assert all(v["value"] > 0 for v in m.values())


CELLS = ("qwen3-4b.long-decode", "qwen2.5-3b.doc-repeat")


@pytest.mark.parametrize("cell_name", CELLS)
def test_a_token_altered_where_it_is_produced(tmp_path, cell_name):
    def hook(engine):
        commit = engine._commit_emitted
        n = [0]

        def altered(e, tok, lp, finished, first=False):
            n[0] += 1
            if n[0] % 7 == 0:
                tok = (int(tok) + 1) % engine.cfg.vocab
            return commit(e, tok, lp, finished, first=first)
        engine._commit_emitted = altered
    assert not _run(tmp_path, hook, cell_name=cell_name)["correct"]


@pytest.mark.parametrize("cell_name", CELLS)
def test_a_step_that_leaves_its_state_unchanged(tmp_path, monkeypatch,
                                                cell_name):
    from repro_torch.models import attention
    monkeypatch.setattr(attention, "_store_paged",
                        lambda cache, name, dst, val: None)
    assert not _run(tmp_path, cell_name=cell_name)["correct"]


@pytest.mark.parametrize("cell_name", CELLS)
def test_half_of_the_batch_left_out(tmp_path, monkeypatch, cell_name):
    from repro_torch.models import transformer
    step = transformer.forward_step

    def half(*a, **kw):
        logits = step(*a, **kw)
        B = logits.shape[0]
        logits[B // 2:] = logits[:B - B // 2].clone()
        return logits
    monkeypatch.setattr(transformer, "forward_step", half)
    assert not _run(tmp_path, cell_name=cell_name)["correct"]


def test_trace_run_reports_the_counter_metrics(tmp_path):
    b, spec = smoke.smoke_bench(tmp_path, "qwen2.5-3b.doc-repeat",
                                max_gap=LIMIT)
    out = cell.run("qwen2.5-3b.doc-repeat", SEED, 1.5, True, device="cpu",
                   spec=spec, bench=b)
    assert out["correct"], out["checks"]
    m = out["metrics"]
    # no device on the CPU: no share of a device peak, no trace
    assert set(m) == {"prefix_hit_token_pct", "step_padding_pct.prompt"}
    assert 0 < m["prefix_hit_token_pct"]["value"] < 100
    assert "busy_s" not in out["device"]
