"""The paper's C4 dispatch and its best-offset prefetcher in the port
(``repro_torch.core.heterogeneous``, ``repro_torch.core.prefetch``), on
the CPU, against the reference's modules.

Both are plain Python, so the port must take the reference's decisions
and give its numbers exactly (floats compared with ``==``): the regime of
every matmul site on a hypothesis-drawn grid at the TPU v5e's ridge (the
default chip of both), the decision tables of the registry's widths, the
offsets the scheduler learns, and the lookahead, time and efficiency of
the pipeline model. The reference's own cases of
``tests/test_substrate.py`` (prefetch) and ``tests/test_system.py``
(dispatch) are restated against the port. On the H100 SXM the ridge is
higher (bf16 989.4 TFLOP/s over 3.35 TB/s against 197 over 0.819), and
the port keeps the reference's rule there too.
"""

import dataclasses

import numpy as np
import pytest

from repro.configs import get_config
from repro.core import heterogeneous as jax_het
from repro.core import prefetch as jax_prefetch
from repro.roofline import hw as jax_hw
from repro_torch.configs import registry
from repro_torch.core import heterogeneous, prefetch
from repro_torch.roofline import hw

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:  # property tests are skipped on clean environments
    from conftest import given, settings, st  # no-op stand-ins


def _sites(rows, k, n, wbits, abits, sparsity):
    return (heterogeneous.MatmulSite(rows, k, n, wbits, abits, sparsity),
            jax_het.MatmulSite(rows, k, n, wbits, abits, sparsity))


@settings(max_examples=200, deadline=None)
@given(rows=st.integers(1, 1 << 18), k=st.integers(1, 1 << 15),
       n=st.integers(1, 1 << 18), wbits=st.sampled_from([4, 8, 16, 32]),
       abits=st.sampled_from([8, 16, 32]),
       sparsity=st.sampled_from([0.0, 0.25, 0.49, 0.5, 0.9, 1.0]))
def test_classify_and_intensity_equal_the_reference(rows, k, n, wbits,
                                                    abits, sparsity):
    mine, theirs = _sites(rows, k, n, wbits, abits, sparsity)
    assert heterogeneous.arithmetic_intensity(mine) \
        == jax_het.arithmetic_intensity(theirs)
    assert heterogeneous.classify(mine) == jax_het.classify(theirs)
    assert heterogeneous.classify(mine, hw.V5E) \
        == jax_het.classify(theirs, jax_hw.V5E)


def test_v5e_entry_equals_the_reference():
    assert (hw.V5E.peak_flops, hw.V5E.hbm_bw) \
        == (jax_hw.V5E.peak_flops, jax_hw.V5E.hbm_bw)


@pytest.mark.parametrize("batch", [1, 8, 64, 512])
def test_decode_regime_report_equals_the_reference(batch):
    """Every config of the port's registry, at the v5e's ridge, gives the
    reference's table; at the H100 SXM's the rule is the same one."""
    for name, cfg in sorted(registry.REGISTRY.items()):
        args = (cfg.d_model, cfg.d_ff, cfg.vocab, batch)
        assert heterogeneous.decode_regime_report(*args) \
            == jax_het.decode_regime_report(*args), name
        ridge = hw.H100_SXM.peak_flops / hw.H100_SXM.hbm_bw
        sites = heterogeneous.decode_sites(*args)
        for site_name, regime in heterogeneous.decode_regime_report(
                *args, chip=hw.H100_SXM).items():
            site = sites[site_name]
            want = ("sparse_gather" if site.sparsity >= 0.5
                    and site.rows <= 256 else "gemv_stream"
                    if heterogeneous.arithmetic_intensity(site) < ridge
                    else "gemm_mxu")
            assert regime == want, (name, site_name)


def test_h100_ridge_moves_a_site_between_regimes():
    """A site between the two ridges (240.5 and 295.3 FLOP/byte) streams
    on the H100 and goes to the dense product on the v5e."""
    site = heterogeneous.MatmulSite(rows=300, k=4096, n=4096)
    ai = heterogeneous.arithmetic_intensity(site)
    assert hw.V5E.peak_flops / hw.V5E.hbm_bw < ai \
        < hw.H100_SXM.peak_flops / hw.H100_SXM.hbm_bw
    assert heterogeneous.classify(site) == "gemm_mxu"
    assert heterogeneous.classify(site, hw.H100_SXM) == "gemv_stream"


def test_dispatcher_routes_by_regime_and_override():
    calls = []

    def impl(regime):
        def f(*args, **kwargs):
            calls.append((regime, args, kwargs))
            return regime.upper()
        return f
    impls = {r: impl(r) for r in ("gemv_stream", "gemm_mxu",
                                  "sparse_gather")}
    disp = heterogeneous.Dispatcher(impls)
    decode = heterogeneous.MatmulSite(rows=8, k=2048, n=8192)
    prefill = heterogeneous.MatmulSite(rows=32 * 4096, k=2048, n=8192)
    sparse = heterogeneous.MatmulSite(rows=8, k=8192, n=2048, sparsity=0.9)
    assert disp(decode, 1, x=2) == ("GEMV_STREAM", "gemv_stream")
    assert disp(prefill) == ("GEMM_MXU", "gemm_mxu")
    assert disp(sparse, 3) == ("SPARSE_GATHER", "sparse_gather")
    assert calls == [("gemv_stream", (1,), {"x": 2}),
                     ("gemm_mxu", (), {}), ("sparse_gather", (3,), {})]
    forced = heterogeneous.Dispatcher(impls, override="gemm_mxu")
    assert forced(decode) == ("GEMM_MXU", "gemm_mxu")
    h100 = heterogeneous.Dispatcher(impls, chip=hw.H100_SXM)
    site = heterogeneous.MatmulSite(rows=300, k=4096, n=4096)
    assert h100(site)[1] == "gemv_stream"
    assert heterogeneous.Dispatcher(impls)(site)[1] == "gemm_mxu"
    # the same decisions as the reference's Dispatcher on the same sites
    theirs = jax_het.Dispatcher({r: (lambda r=r: r) for r in impls})
    for s in (decode, prefill, sparse, site):
        assert theirs(jax_het.MatmulSite(**dataclasses.asdict(s)))[1] \
            == disp(s)[1]


def test_heterogeneous_dispatch_routes_decode_to_nmce():
    """tests/test_system.py's case, against the port."""
    cfg = get_config("llama3.2-1b")
    rep = heterogeneous.decode_regime_report(cfg.d_model, cfg.d_ff,
                                             cfg.vocab, batch=8)
    assert rep["ffn_up"] == "gemv_stream"          # memory-bound -> NMCE
    assert rep["ffn_down_sparse"] == "sparse_gather"
    # a prefill-sized matmul goes to the dense product
    site = heterogeneous.MatmulSite(rows=32 * 4096, k=2048, n=8192)
    assert heterogeneous.classify(site) == "gemm_mxu"


# ---------------------------------------------------------------------------
# the best-offset prefetcher


@pytest.mark.parametrize("stride", [1, 2, 3, 7])
def test_best_offset_learns_stride(stride):
    """tests/test_substrate.py's case, against the port."""
    s = prefetch.BestOffsetScheduler(offsets=range(1, 9))
    off = s.train_on_stream(prefetch.strided_stream(600, stride))
    assert off == stride, (off, stride)


def test_best_offset_disables_on_random_stream():
    rng = np.random.default_rng(0)
    s = prefetch.BestOffsetScheduler(offsets=range(1, 9), bad_score=4)
    off = s.train_on_stream(list(rng.integers(0, 10 ** 6, size=600)))
    assert off == 0  # no stream -> prefetching gated off (paper stride-0)


def test_pipeline_lookahead_improves_throughput():
    eff1 = prefetch.pipeline_efficiency(2.0, 1.0, lookahead=0)
    eff2 = prefetch.pipeline_efficiency(2.0, 1.0,
                                        lookahead=prefetch.choose_lookahead(
                                            2.0, 1.0, vmem_blocks=8))
    assert eff2 > eff1 * 1.2


def _streams():
    rng = np.random.default_rng(7)
    out = [prefetch.strided_stream(n, s) for n, s in
           ((900, 1), (900, 5), (1700, 12), (900, 64), (3000, 3))]
    out.append([int(x) for x in rng.integers(0, 10 ** 6, 900)])
    # two interleaved strided streams, and one whose stride changes
    out.append([a for i in range(600) for a in (4 * i, 10 ** 5 + 9 * i)])
    out.append(prefetch.strided_stream(900, 2)
               + [10 ** 4 + 6 * i for i in range(900)])
    return out


@pytest.mark.parametrize("kw", [{}, dict(offsets=range(1, 9)),
                                dict(offsets=range(1, 9), bad_score=4),
                                dict(rounds=2, history=16)])
def test_train_on_stream_equals_the_reference(kw):
    for addrs in _streams():
        mine = prefetch.BestOffsetScheduler(**kw)
        theirs = jax_prefetch.BestOffsetScheduler(**kw)
        assert mine.train_on_stream(addrs) == theirs.train_on_stream(addrs)
        assert (mine.scores, mine.best_offset, mine.enabled,
                mine._recent, mine._round) \
            == (theirs.scores, theirs.best_offset, theirs.enabled,
                theirs._recent, theirs._round)


@settings(max_examples=150, deadline=None)
@given(t_fetch=st.floats(0.01, 10.0), t_compute=st.floats(0.01, 10.0),
       lookahead=st.integers(0, 12), vmem=st.integers(0, 16),
       n_blocks=st.integers(1, 96))
def test_pipeline_model_equals_the_reference(t_fetch, t_compute, lookahead,
                                             vmem, n_blocks):
    assert prefetch.simulate_pipeline(n_blocks, t_fetch, t_compute,
                                      lookahead) \
        == jax_prefetch.simulate_pipeline(n_blocks, t_fetch, t_compute,
                                          lookahead)
    assert prefetch.choose_lookahead(t_fetch, t_compute, vmem, n_blocks) \
        == jax_prefetch.choose_lookahead(t_fetch, t_compute, vmem, n_blocks)
    assert prefetch.pipeline_efficiency(t_fetch, t_compute, lookahead,
                                        n_blocks) \
        == jax_prefetch.pipeline_efficiency(t_fetch, t_compute, lookahead,
                                            n_blocks)
