"""The card-vs-CPU flip probe (repro_torch.tools.flip_probe), on the CPU:
two CPU serves of one prompt set agree everywhere, a top-k boundary swap
is found and measured, and the replayed prompt set keeps its draw order."""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ServeConfig
from repro_torch.models import Model
from repro_torch.tools import flip_probe


@pytest.mark.parametrize("paged", [True, False])
def test_probe_of_two_cpu_serves_finds_nothing(paged):
    cfg = get_config("nectar-relu-llama-1.7m")
    params = Model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    prompts = [p[:24] for p in flip_probe.seeded_prompts(cfg.vocab, 3)[:4]]
    scfg = ServeConfig(paged=paged, attn_backend="flash", max_batch=3,
                       max_seq=96)
    r = flip_probe.probe(cfg, params, prompts, scfg, devices=("cpu", "cpu"),
                         max_new=5)
    assert r["flips"] == [] and r["set_diffs"] == []
    # every token after the first of every request, at every layer
    assert r["checked"] == len(prompts) * 4 * cfg.n_layers


def test_boundary_measures_a_swap_at_the_kth_place():
    k = 4
    hb = torch.tensor([9.0, 8.0, 7.0, 5.0, 4.999, 1.0, 0.0])
    ha = hb.clone()
    ha[3], ha[4] = 4.9995, 5.0005          # the k-th and (k+1)-th trade
    sa, sb = {0, 1, 2, 4}, {0, 1, 2, 3}
    d = flip_probe.boundary(ha, hb, sa, sb, k)
    assert d["swapped"] == 1
    assert d["gap_b"] == pytest.approx(0.001, abs=1e-6)
    assert d["gap_a"] == pytest.approx(0.001, abs=1e-6)
    assert d["kth_b"] == 5.0
    assert d["max_h_diff"] == pytest.approx(0.0015, abs=1e-6)
    assert [j for j, _, _ in d["h_at_swapped"]] == [4, 3]
    assert flip_probe.boundary(hb, hb, sb, set(sb), k) is None


def test_recorder_keeps_the_units_the_gather_reads():
    """The recorded selection is the device's own top-k, without the
    units whose |h| is 0 (the gather skips them)."""
    rec = flip_probe.Recorder.__new__(flip_probe.Recorder)
    rec.h = [[]]
    hook = rec.topk_hook(flip_probe.sparsity.topk_indices)
    h = torch.tensor([[[3.0, 0.0, 2.0, 0.0]], [[0.0, 1.0, 0.0, 4.0]]])
    idx, valid = hook(h, 3)
    assert idx.shape == (2, 1, 3) and valid.shape == (2, 1, 3)
    (h0, sel), = rec.h[0]
    assert torch.equal(h0, h[:, 0]) and sel == [{0, 2}, {1, 3}]


def test_shared_stream_prompts_keep_their_draw_order():
    prompts = flip_probe.shared_stream_prompts(2048)
    assert [len(p) for p in prompts] == [103, 31, 92, 99, 31, 35, 25, 172,
                                         29, 46, 98, 112, 20, 179, 149, 141]
    np.testing.assert_array_equal(prompts[6][:4], [1133, 137, 202, 531])
