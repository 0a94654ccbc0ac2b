"""What the harness records around the program's calls: the shapes of a
known request's device steps, read from the runner's arguments by name,
and a stop, not a wrong count, where the program renames one."""

import json

import numpy as np
import pytest
import torch

from bench.harness import cell, driver, model, smoke


@pytest.fixture
def engine(tmp_path):
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    b, _ = smoke.smoke_bench(tmp_path, "qwen3-4b.long-decode")
    conf = json.loads((b / "configs" / "qwen3-4b.json").read_text())
    mix = json.loads((b / "traffic" / "long-decode.json").read_text())
    mix["clients"] = 2
    cfg, scfg = cell.build(conf, mix)
    assert (scfg.prefill_chunk, scfg.max_batch) == (16, 2)
    weights = model.make_weights(conf["config"], torch.bfloat16, 5,
                                 torch.device("cpu"))
    from repro_torch.serve.engine import Engine
    yield Engine(cfg, model.port_params(weights), scfg,
                 device=torch.device("cpu"))
    torch.set_num_threads(old)


def test_a_known_request_records_its_steps(engine):
    from repro_torch.serve.api import StreamingServer
    rec = driver.Recorder()
    driver.instrument(engine, rec)
    rec.recording = True
    server = StreamingServer(engine)
    server.submit(np.arange(20) % 256, max_new=11)
    server.drain(max_steps=1000)
    got = [(kind, width, [int(x) for x in start], [int(x) for x in n])
           for kind, width, start, n, _ in rec.steps]
    # 20 prompt tokens in chunks of 16 on a batch of 2 (the second row
    # idle), the last chunk's step samples the first token; then the 10
    # more decode in bursts of at most K = 8, one token an iteration
    assert got == [("step", 16, [0, 0], [16, 0]),
                   ("step", 16, [16, 0], [4, 0]),
                   ("burst", 8, [20, 0], [8, 0]),
                   ("burst", 2, [28, 0], [2, 0])]
    assert rec.tick_n == {"eager width 16": 2, "burst": 2}


def test_a_renamed_argument_stops_the_run(engine):
    burst = engine.runner.decode_burst

    def renamed(sampled, k_max, tables, tok0, lens, alive0, budget, stops,
                stop_len, hist0, keys, temp, top_k, top_p, k_burst):
        return burst(sampled, k_max, tables, tok0, lens, alive0, budget,
                     stops, stop_len, hist0, keys, temp, top_k, top_p,
                     k_burst)
    engine.runner.decode_burst = renamed
    with pytest.raises(TypeError, match="lens0"):
        driver.instrument(engine, driver.Recorder())


def test_the_check_judges_an_admitted_request_prefilled_whole():
    from bench.harness import oracle, traffic

    def client(rid, prompt, served, done_t, resumed=False, cached=0):
        c = driver.Client(rid, traffic.Req(np.zeros(prompt, np.int32), 99,
                                           resumed), 0.0)
        c.tokens, c.done_t, c.cached = [1] * served, done_t, cached
        return c
    clients = [client(0, 40, 30, 5.0, resumed=True),    # under way at t0
               client(1, 10, 5, 6.0, resumed=True),
               client(2, 30, 9, None),                  # admitted, running
               client(3, 30, 20, None, cached=16),      # partly cached
               client(4, 30, 0, None)]                  # nothing served yet
    picked = oracle.sample(clients, 10.0, 3, 2)
    assert [c.rid for c in picked] == [0, 1, 2]
    # with none the prefix cache held nothing of, one it held part of
    clients[2].tokens = []
    picked = oracle.sample(clients, 10.0, 3, 1)
    assert [c.rid for c in picked] == [0, 3]
