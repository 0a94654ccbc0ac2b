"""A cell cut to a size the CPU runs in seconds, for the tests: a copy of
``bench/`` whose configuration has the SMOKE widths of the registry's
Qwen entries and whose traffic mix serves a few short requests. The
harness runs it through the same code as a cell on the card."""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Optional, Tuple

from bench.harness import cell

SMOKE_SIZES = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                   num_attention_heads=4, num_key_value_heads=2, head_dim=16,
                   vocab_size=256)

SMOKE_MIXES = {
    "qwen3-4b.long-decode": dict(
        clients=4, prompt={"median": 24, "sigma": 0.6, "min": 8, "max": 64},
        output={"median": 24, "sigma": 0.6, "min": 8, "max": 64},
        serve={"max_seq": 160, "prefill_chunk": 16, "n_kv_blocks": 64}),
    "qwen2.5-3b.doc-repeat": dict(
        clients=4, prompt={"median": 8, "sigma": 0.6, "min": 4, "max": 16},
        output={"median": 8, "sigma": 0.6, "min": 4, "max": 16},
        shared={"doc": {"median": 48, "sigma": 0.6, "min": 32, "max": 96},
                "asks": 4, "spacing": 5},
        serve={"max_seq": 160, "prefill_chunk": 16, "n_kv_blocks": 128}),
}


def smoke_bench(tmp: Path, cell_name: str, dtype: str = "bfloat16",
                max_gap: float = 1.0, mix: Optional[dict] = None,
                requests: int = 3) -> Tuple[Path, dict]:
    """(a bench directory under ``tmp``, its spec) holding ``cell_name`` at
    SMOKE size; every other file is the repository's own."""
    src = cell.BENCH
    b = Path(tmp) / "bench"
    shutil.copytree(src, b, ignore=shutil.ignore_patterns(
        "__pycache__", "test_*.py", "conftest.py"))
    spec = cell.load_spec(src.parent)
    w = cell.find_cell(spec, cell_name)
    path = b.parent / next(c["file"] for c in spec["configs"]
                           if c["name"] == w["config"])
    conf = json.loads(path.read_text())
    conf["config"].update(SMOKE_SIZES)
    conf["dtype"] = dtype
    path.write_text(json.dumps(conf))
    tpath = b / "traffic" / f"{w['traffic']}.json"
    tmix = json.loads(tpath.read_text())
    tmix.update(SMOKE_MIXES[cell_name] if mix is None else mix)
    tpath.write_text(json.dumps(tmix))
    (b / "checks" / f"{cell_name}.json").write_text(
        json.dumps({"requests": requests, "max_gap": max_gap}))
    return b, spec
