"""The port's kernel layer on the CPU: each kernel's plain PyTorch version
against the JAX Pallas kernel (interpret mode) and its jnp oracle, and the
CPU dispatch of ``repro_torch.kernels.ops``.

Inputs come from seeded numpy and feed both sides in float32. Tolerances:
atol=rtol=1e-5 — both sides compute the same f32 sums in another order
(the Pallas kernel's online softmax against one softmax over the gathered
sequence), which moves results by a few ulps of values of order 1.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sparsity as jsparsity
from repro.kernels import ref as jref
from repro.kernels.decode_attn import paged_attention as jax_paged_attention
from repro.kernels.sparse_ffn import sparse_gather_matvec as jax_sparse
from repro_torch.core import sparsity as tsparsity
from repro_torch.kernels import ops, ref

TOL = dict(rtol=1e-5, atol=1e-5)


def _paged_case(seed, B, S, Hq, Kv, Dh, nb, bs, MB, lens):
    """Pools, queries and scattered tables whose blocks cover every query
    position lens[b]+S-1; the rest of each row is sentinel (``nb``)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, Hq, Dh)).astype(np.float32)
    k_pool = rng.standard_normal((nb, bs, Kv, Dh)).astype(np.float32)
    v_pool = rng.standard_normal((nb, bs, Kv, Dh)).astype(np.float32)
    tables = np.full((B, MB), nb, np.int32)
    free = list(rng.permutation(nb))
    for b in range(B):
        n = -(-(lens[b] + S) // bs)
        tables[b, :n] = [free.pop() for _ in range(n)]
    return q, k_pool, v_pool, tables, np.asarray(lens, np.int32)


@pytest.mark.parametrize("S,Hq,Kv", [
    (1, 4, 2),     # decode row, GQA (G=2)
    (3, 4, 2),     # verify-shaped row, GQA
    (16, 4, 4),    # prefill chunk, MHA (G=1)
    (1, 4, 4),     # decode row, MHA
])
def test_paged_attention_plain_matches_pallas(S, Hq, Kv):
    """Mirrors test_kernels.py's paged cases: scattered physical blocks,
    sentinel entries past each row's context, per-query causal limits."""
    nb, bs, MB, Dh = 24, 8, 6, 16
    q, kp, vp, tables, lens = _paged_case(S + Hq, 3, S, Hq, Kv, Dh, nb,
                                          bs, MB, lens=[17, 2, 30])
    want = np.asarray(jax_paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(lens), block_size=bs,
        interpret=True))
    got = ref.paged_attention_plain(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(tables), torch.from_numpy(lens)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_paged_attention_plain_s1_matches_decode_oracle():
    """S = 1 against the contiguous decode oracle over the gathered cache
    (kv_len = lens + 1, the in-flight token included)."""
    nb, bs, MB, Dh, Hq, Kv = 12, 16, 4, 16, 4, 2
    q, kp, vp, tables, lens = _paged_case(4, 2, 1, Hq, Kv, Dh, nb, bs, MB,
                                          lens=[22, 6])
    kg = np.zeros((2, MB * bs, Kv, Dh), np.float32)
    vg = np.zeros_like(kg)
    for b in range(2):
        for m in range(MB):
            if tables[b, m] < nb:
                kg[b, m * bs:(m + 1) * bs] = kp[tables[b, m]]
                vg[b, m * bs:(m + 1) * bs] = vp[tables[b, m]]
    want = np.asarray(jref.decode_attention_ref(
        jnp.asarray(q[:, 0]), jnp.asarray(kg), jnp.asarray(vg),
        jnp.asarray(lens + 1)))
    got = ref.paged_attention_plain(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(tables), torch.from_numpy(lens))[:, 0].numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_paged_attention_plain_idle_row_is_finite():
    """An IDLE row (all-sentinel table, what forward_step gives inactive
    rows) reads nothing and returns finite values."""
    nb, bs, MB = 8, 8, 3
    q, kp, vp, _, lens = _paged_case(5, 2, 4, 4, 4, 16, nb, bs, MB,
                                     lens=[0, 9])
    tables = np.full((2, MB), nb, np.int32)
    out = ref.paged_attention_plain(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(tables), torch.from_numpy(lens))
    assert torch.isfinite(out).all()


def _sparse_case(seed, B, k, d_ff, d, n_empty):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((B, k)).astype(np.float32)
    idx = np.stack([rng.permutation(d_ff)[:k] for _ in range(B)])
    idx[:, k - n_empty:] = d_ff                 # empty slots
    w = (rng.standard_normal((d_ff, d)) * d_ff ** -0.5).astype(np.float32)
    return h, idx.astype(np.int32), w


@pytest.mark.parametrize("B,k,d_ff,d,n_empty", [
    (4, 128, 640, 128, 17),    # nectar widths
    (3, 16, 64, 32, 0),
])
def test_sparse_gather_matvec_plain_matches_pallas_and_oracle(
        B, k, d_ff, d, n_empty):
    h, idx, w = _sparse_case(B + k, B, k, d_ff, d, n_empty)
    got = ref.sparse_gather_matvec_plain(
        torch.from_numpy(h), torch.from_numpy(idx),
        torch.from_numpy(w)).numpy()
    pallas = np.asarray(jax_sparse(jnp.asarray(h), jnp.asarray(idx),
                                   jnp.asarray(w), interpret=True))
    oracle = np.asarray(jref.sparse_gather_matvec_ref(
        jnp.asarray(h), jnp.asarray(idx), jnp.asarray(w)))
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, oracle, **TOL)


@pytest.mark.parametrize("active", [400, 90])
def test_down_sparse_matches_reference(active):
    """The port's down_sparse (top-k on |h|, sentinel d_ff for zero
    slots, gathered contraction) against the reference's. ``active`` < k
    leaves invalid top-k slots, which must contribute nothing."""
    rng = np.random.default_rng(active)
    d_ff, d, k = 640, 128, 128
    h = np.abs(rng.standard_normal((2, 3, d_ff))).astype(np.float32)
    for row in h.reshape(-1, d_ff):
        row[rng.permutation(d_ff)[active:]] = 0.0
    w = (rng.standard_normal((d_ff, d)) * d_ff ** -0.5).astype(np.float32)
    want = np.asarray(jsparsity.down_sparse(jnp.asarray(h), jnp.asarray(w),
                                            k))
    got = tsparsity.down_sparse(torch.from_numpy(h), torch.from_numpy(w),
                                k).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_ops_send_cpu_tensors_to_plain_versions():
    """On CPU tensors the dispatch computes the plain versions and launches
    no kernel."""
    before = dict(ops.LAUNCHES)
    q, kp, vp, tables, lens = _paged_case(6, 2, 3, 4, 2, 16, 12, 8, 4,
                                          lens=[5, 11])
    args = [torch.from_numpy(a) for a in (q, kp, vp, tables, lens)]
    assert torch.equal(ops.paged_attention(*args),
                       ref.paged_attention_plain(*args))
    h, idx, w = _sparse_case(7, 2, 16, 64, 32, 3)
    sargs = [torch.from_numpy(a) for a in (h, idx, w)]
    assert torch.equal(ops.sparse_gather_matvec(*sargs),
                       ref.sparse_gather_matvec_plain(*sargs))
    assert ops.LAUNCHES == before
