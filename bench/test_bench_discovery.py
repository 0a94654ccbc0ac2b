"""A configuration, a traffic mix and a per-layer metric added as new files
(and entries), with no file of the harness edited: the harness finds each
by its name and runs the new cell (at SMOKE size, on the CPU)."""

import json

import torch

from bench.harness import cell, smoke

READER = '''"""Requests the window finished (a test's reader)."""


def read(run):
    return sum(1 for c in run.window.clients
               if c.done_t is not None and c.done_t <= run.window.t1)
'''


def test_new_files_make_a_new_cell(tmp_path):
    torch.set_num_threads(1)
    b, spec = smoke.smoke_bench(tmp_path, "qwen2.5-3b.doc-repeat")
    # a configuration: a file and an entry
    conf = json.loads((b / "configs" / "qwen2.5-3b.json").read_text())
    conf["name"] = "qwen2.5-3b-deep"
    conf["config"]["num_hidden_layers"] = 3
    (b / "configs" / "qwen2.5-3b-deep.json").write_text(json.dumps(conf))
    spec["configs"].append({"name": "qwen2.5-3b-deep", "source": "test",
                            "file": "bench/configs/qwen2.5-3b-deep.json",
                            "reduced": [], "why": "test"})
    # a traffic mix: data only, read by the one generator
    mix = dict(smoke.SMOKE_MIXES["qwen3-4b.long-decode"], clients=3)
    (b / "traffic" / "tiny.json").write_text(json.dumps(mix))
    spec["workloads"].append({"name": "qwen2.5-3b-deep.tiny",
                              "config": "qwen2.5-3b-deep",
                              "traffic": "tiny", "chips": 1, "why": "test"})
    (b / "checks" / "qwen2.5-3b-deep.tiny.json").write_text(
        json.dumps({"requests": 2, "max_gap": 1.0}))
    # a per-layer metric: its reader and an entry
    (b / "metrics" / "finished_requests.py").write_text(READER)
    spec["per_layer"].append({"name": "finished_requests", "unit": "requests",
                              "better": "higher", "source": "host_clock",
                              "layer": "front end", "moves":
                              "output_tokens_per_s",
                              "workloads": ["qwen2.5-3b-deep.tiny"]})
    out = cell.run("qwen2.5-3b-deep.tiny", 11, 1.0, True, device="cpu",
                   spec=spec, bench=b)
    assert out["correct"], out["checks"]
    assert out["metrics"]["finished_requests"]["value"] > 0
    assert "prefix_hit_token_pct" not in out["metrics"]
    assert "step_padding_pct.decode" not in out["metrics"]
