"""The readers of the program's own request records
(``harness/records.py``): ``queue_wait_ms``, ``host_policy_pct`` and
``eager_dispatch_pct`` on a synthetic window, None for a program without
the record and off the card, and through a whole smoke cell on the CPU
(the card's peaks put in for the CPU's, so the readers read)."""

import types

import pytest
import torch

from bench.harness import cell, counting, driver, records, smoke
from bench.harness.traffic import Req
from repro_torch.serve.metrics import RequestMetrics

H100 = "NVIDIA H100 80GB HBM3"
T1 = 100.0


def _client(rid, submit, admit, finish, resumed=False, phase_s=None,
            record=True):
    """A client whose request was submitted, admitted and finished at
    those times (``finish`` None: still running)."""
    r = RequestMetrics(rid=rid, arrival=submit, submitted_at=submit,
                       admitted_at=admit, finished_at=finish,
                       phase_s=phase_s)
    request = types.SimpleNamespace(metrics=r) if record \
        else types.SimpleNamespace()
    c = driver.Client(rid=rid, req=Req(prompt=None, max_new=1,
                                       resumed=resumed),
                      submit_t=submit, done_t=finish)
    c.request = request if finish is not None else None
    return c


def _run(clients, peaks=None):
    window = driver.Window(t0=0.0, t1=T1, clients=clients, steps=[],
                           prof_steps=[], trace=None, async_delta={})
    return cell.Run(cell="x", hf={}, max_batch=4, seconds=T1, setup_s=1.0,
                    window=window,
                    peaks=counting.PEAKS[H100] if peaks is None else peaks,
                    n_layers=1, pool_bytes=4)


def test_queue_wait_is_the_median_of_the_new_finished_requests():
    clients = [
        _client(0, 10.0, 10.010, 20.0),
        _client(1, 11.0, 11.030, 21.0),
        _client(2, 12.0, 12.020, 22.0),
        _client(3, 0.0, 5.0, 23.0, resumed=True),   # the opening burst
        _client(4, 13.0, 13.500, T1 + 1.0),         # finished after t1
        _client(5, 14.0, 14.700, None),             # still running
    ]
    got = cell.reader("queue_wait_ms").read(_run(clients))
    assert got == pytest.approx(20.0)


def test_phase_shares_over_the_requests_lives():
    a = {"schedule": 1.0, "admit": 0.5, "draft": 0.0, "batch_assemble": 0.25,
         "postprocess": 0.25, "front_end": 1.0, "device_dispatch": 3.0,
         "graph_dispatch": 2.0, "tick": 0.5, "device_wait": 1.0}
    b = dict(a, schedule=0.0, device_dispatch=1.0)
    clients = [_client(0, 0.0, 1.0, 11.0, resumed=True, phase_s=a),
               _client(1, 5.0, 6.0, 16.0, phase_s=b),
               _client(2, 5.0, 6.0, T1 + 5.0, phase_s=a)]
    run = _run(clients)
    # host policy: 3.0 and 2.0 over 10 s lives each
    assert cell.reader("host_policy_pct.decode").read(run) \
        == pytest.approx(100.0 * 5.0 / 20.0)
    assert cell.reader("eager_dispatch_pct.prompt").read(run) \
        == pytest.approx(100.0 * 4.0 / 20.0)
    assert set(records.HOST_POLICY) | set(records.EAGER_DISPATCH) \
        <= set(a) | {"admit"}


@pytest.mark.parametrize("name", ["queue_wait_ms", "host_policy_pct.decode",
                                  "eager_dispatch_pct.prompt"])
def test_none_without_the_record_or_off_the_card(name):
    read = cell.reader(name).read
    phase_s = {"schedule": 1.0, "device_dispatch": 1.0}
    full = [_client(0, 1.0, 2.0, 12.0, phase_s=phase_s)]
    assert read(_run(full)) is not None
    # a program that keeps no record on its requests
    assert read(_run([_client(0, 1.0, 2.0, 12.0, record=False)])) is None
    # never admitted (a shed request), or no request finished
    assert read(_run([_client(0, 1.0, None, 12.0, phase_s=phase_s)])) \
        is None
    assert read(_run([])) is None
    # off the card: the CPU's own runs
    assert read(_run(full, peaks={})) is None


@pytest.mark.parametrize("cell_name", ["qwen2.5-3b.doc-repeat",
                                       "qwen3-4b.long-decode"])
def test_a_smoke_cell_reports_the_record_metrics(tmp_path, monkeypatch,
                                                 cell_name):
    """The whole harness on a SMOKE cell on the CPU, with the card's peaks
    put in for the CPU's: the traced run's line carries every new metric
    that lists the cell, the shares between 0 and 100."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setitem(counting.PEAKS, "cpu", counting.PEAKS[H100])
    try:
        b, spec = smoke.smoke_bench(tmp_path, cell_name)
        out = cell.run(cell_name, 7, 1.5, True, device="cpu", spec=spec,
                       bench=b)
    finally:
        torch.set_num_threads(old)
    assert out["correct"], out["checks"]
    m = {k: v["value"] for k, v in out["metrics"].items()}
    kind = "prompt" if cell_name.endswith(("repeat", "unique")) else "decode"
    host, eager = m[f"host_policy_pct.{kind}"], m[f"eager_dispatch_pct.{kind}"]
    assert 0 < host < 100 and 0 < eager < 100 and host + eager <= 100
    if kind == "prompt":
        assert m["queue_wait_ms"] >= 0
    else:
        assert "queue_wait_ms" not in m
