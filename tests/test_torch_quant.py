"""The port's int8 quantization and NMCE model (``repro_torch.core.quant``,
``repro_torch.core.nmce``) and the W8A8 matmul's plain version against the
JAX reference, on the CPU.

Inputs come from seeded numpy and feed both sides. Everything here is held
bit for bit (``assert_array_equal``): quantization divides in f32 and
rounds half to even on both sides, and the integer sums are exact. The one
exception is the reference's jitted ``quant_dequant`` (see its test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import nmce as jnmce
from repro.core import quant as jquant
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.nmce_matvec import nmce_matmul as jax_nmce_matmul
from repro_torch.core import nmce as tnmce
from repro_torch.core import quant as tquant
from repro_torch.kernels import ops, ref


def _both(a):
    return jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a))


def _quantize_both(a, axis):
    ja, ta = _both(a)
    return jquant.quantize_int8(ja, axis=axis), tquant.quantize_int8(ta,
                                                                     axis=axis)


def _assert_same_qt(jq, tq):
    np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))
    assert tq.q.dtype == torch.int8 and tq.scale.dtype == torch.float32
    assert tq.axis == jq.axis


@pytest.mark.parametrize("shape,axis", [
    ((6, 96), 0),          # activations: a scale per row
    ((96, 40), 1),         # weights: a scale per output column
    ((33, 17), None),      # per tensor
    ((128,), None),
    ((2, 5, 64), 2),
])
def test_quantize_int8_is_bit_equal(shape, axis):
    rng = np.random.default_rng(len(shape) * 7 + (axis or 0))
    a = (rng.standard_normal(shape) * 3).astype(np.float32)
    a.reshape(-1)[::11] = 0.0
    jq, tq = _quantize_both(a, axis)
    _assert_same_qt(jq, tq)
    np.testing.assert_array_equal(
        tq.dequantize().numpy(), np.asarray(jq.dequantize()))
    # the reference jits quant_dequant, and XLA's fused form of
    # round(x / s) * s may round the last product 1 ulp apart (q and s
    # themselves are equal, checked above)
    np.testing.assert_allclose(
        tquant.quant_dequant(torch.from_numpy(a), axis=axis).numpy(),
        np.asarray(jquant.quant_dequant(jnp.asarray(a), axis=axis)),
        rtol=2.5e-7, atol=0)


def test_quantize_int8_of_zeros_and_ties():
    """An all-zero slice keeps scale 1; values on a .5 boundary round half
    to even, as jnp.round does."""
    a = np.zeros((3, 8), np.float32)
    a[1] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 63.5]
    jq, tq = _quantize_both(a, 0)
    _assert_same_qt(jq, tq)
    assert tq.scale[0, 0].item() == 1.0


# the shapes and both modes of tests/test_kernels.py::test_nmce_matmul_shapes
NMCE_SHAPES = [(1, 256, 128, 128, 128), (4, 1024, 512, 256, 512),
               (8, 512, 384, 128, 256), (3, 640, 256, 256, 128)]


@pytest.mark.parametrize("M,K,N,bn,bk", NMCE_SHAPES)
@pytest.mark.parametrize("sat", [False, True])
def test_nmce_matmul_plain_equals_pallas(M, K, N, bn, bk, sat):
    rng = np.random.default_rng(M * K + N)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = rng.standard_normal((K, N)).astype(np.float32)
    jxq, txq = _quantize_both(x, 0)
    jwq, twq = _quantize_both(w, 1)
    want = jax_nmce_matmul(jxq.q, jwq.q, jxq.scale, jwq.scale, block_n=bn,
                           block_k=bk, saturate_int16=sat, interpret=True)
    got = ref.nmce_matmul_plain(txq.q, twq.q, txq.scale, twq.scale,
                                saturate_int16=sat)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("K", [512, 200])
@pytest.mark.parametrize("sat", [False, True])
def test_nmce_matmul_plain_saturates_like_the_oracle(K, sat):
    """Large magnitudes force int16 saturation; K = 200 is zero-padded to
    256 in the saturating mode on both sides."""
    rng = np.random.default_rng(K)
    x = (rng.standard_normal((5, K)) * 10).astype(np.float32)
    w = (rng.standard_normal((K, 48)) * 10).astype(np.float32)
    jxq, txq = _quantize_both(x, 0)
    jwq, twq = _quantize_both(w, 1)
    want = jref.nmce_matmul_ref(jxq.q, jwq.q, jxq.scale, jwq.scale,
                                saturate_int16=sat)
    got = ref.nmce_matmul_plain(txq.q, twq.q, txq.scale, twq.scale,
                                saturate_int16=sat)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        tquant.w8a8_matmul(txq, twq, saturate_int16=sat).numpy(),
        np.asarray(jquant.w8a8_matmul(jxq, jwq, saturate_int16=sat)))


@pytest.mark.parametrize("saturating", [True, False])
@pytest.mark.parametrize("K", [512, 100])
def test_nmce_matvec_equals_reference(saturating, K):
    """The bank-level NMCE emulation (mirrors test_kernels.py's
    test_nmce_saturation_is_bit_exact_vs_hw_model inputs)."""
    rng = np.random.default_rng(K + saturating)
    x = (rng.standard_normal((K,)) * 10).astype(np.float32)
    w = (rng.standard_normal((256, K)) * 10).astype(np.float32)
    jxq, txq = _quantize_both(x, None)
    jwq, twq = _quantize_both(w, 0)
    jcfg = jnmce.NMCEConfig(saturating=saturating)
    tcfg = tnmce.NMCEConfig(saturating=saturating)
    want = jnmce.nmce_matvec(jxq, jwq, jcfg)
    got = tnmce.nmce_matvec(txq, twq, tcfg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("sat", [False, True])
def test_ops_nmce_matmul_equals_reference_ops(sat):
    """``ops.nmce_matmul`` quantizes x per row on the fly, as the
    reference's ``ops.nmce_matmul`` does; on the CPU it is bit-equal to the
    reference's oracle path."""
    rng = np.random.default_rng(11 + sat)
    x = rng.standard_normal((8, 640)).astype(np.float32)
    w = (rng.standard_normal((640, 128)) * 0.2).astype(np.float32)
    jwq, twq = _quantize_both(w, 1)
    want = jops.nmce_matmul(jnp.asarray(x), jwq, saturate_int16=sat,
                            use_pallas=False)
    before = dict(ops.LAUNCHES)
    got = ops.nmce_matmul(torch.from_numpy(x), twq, saturate_int16=sat)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert ops.LAUNCHES == before


def test_saturating_mac_and_dot_stream_equal_reference():
    rng = np.random.default_rng(5)
    v1 = rng.integers(-128, 128, (64,), dtype=np.int8)
    rows = rng.integers(-128, 128, (32, 64), dtype=np.int8)
    rows[0] = 127
    j1, t1 = _both(v1)
    jr, tr = _both(rows)
    want = np.asarray(jquant.nmce_dot_stream(j1, jr))
    got = tquant.nmce_dot_stream(t1, tr)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tquant.saturating_mac(tr, tr).numpy(),
        np.asarray(jquant.saturating_mac(jr, jr)))
    with pytest.raises(ValueError):
        tquant.nmce_dot_stream(t1[:32], tr)


def test_quantized_linear_equals_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 96)).astype(np.float32)
    w = rng.standard_normal((96, 24)).astype(np.float32)
    b = rng.standard_normal((24,)).astype(np.float32)
    jwq, twq = _quantize_both(w, 1)
    for sat in (False, True):
        want = jquant.quantized_linear(jnp.asarray(x), jwq, jnp.asarray(b),
                                       saturate_int16=sat)
        got = tquant.quantized_linear(torch.from_numpy(x), twq,
                                      torch.from_numpy(b),
                                      saturate_int16=sat)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_quantize_tree_and_tree_bytes_equal_reference():
    rng = np.random.default_rng(4)
    tree = {"w": rng.standard_normal((64, 32)).astype(np.float32),
            "norm": np.ones((64,), np.float32),
            "inner": {"small": rng.standard_normal((4, 4)).astype(np.float32),
                      "big": rng.standard_normal((40, 48)).astype(np.float32)}}
    jt = jquant.quantize_tree(jax.tree.map(jnp.asarray, tree))
    tt = tquant.quantize_tree({"w": torch.from_numpy(tree["w"]),
                               "norm": torch.from_numpy(tree["norm"]),
                               "inner": {k: torch.from_numpy(v) for k, v in
                                         tree["inner"].items()}})
    _assert_same_qt(jt["w"], tt["w"])
    _assert_same_qt(jt["inner"]["big"], tt["inner"]["big"])
    assert isinstance(tt["inner"]["small"], torch.Tensor)
    assert tquant.tree_bytes(tt) == jquant.tree_bytes(jt)


@pytest.mark.parametrize("n_rows", [1024, 640, 130, 3])
def test_bank_plan_and_traffic_model_equal_reference(n_rows):
    for cfg_kw in ({}, {"n_banks": 3, "max_count": 16}):
        assert tnmce.plan_matvec(n_rows, tnmce.NMCEConfig(**cfg_kw)) == [
            tnmce.BankPlan(p.row_start, p.row_count, p.commands)
            for p in jnmce.plan_matvec(n_rows, jnmce.NMCEConfig(**cfg_kw))]
    assert tnmce.nmce_traffic_bytes(n_rows, 512) \
        == jnmce.nmce_traffic_bytes(n_rows, 512)
    assert tnmce.speedup_model(n_rows, 512) \
        == jnmce.speedup_model(n_rows, 512)
