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
from repro.kernels.decode_attn import decode_attention as jax_decode_attention
from repro.kernels.decode_attn import paged_attention as jax_paged_attention
from repro.kernels.relu_ffn import relu_ffn as jax_relu_ffn
from repro.kernels.sparse_ffn import sparse_gather_matvec as jax_sparse
from repro_torch.core import sparsity as tsparsity
from repro_torch.kernels import decode_attn, ops, ref, sparse_ffn

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


@pytest.mark.parametrize("S,Hq,Kv,bs,lens", [
    # contexts over 8+ blocks of 16; rows 1 and 2 end on a block boundary
    # (15 + 1 = 16, 127 + 1 = 128)
    (1, 4, 4, 16, [150, 15, 127]),
    # GQA G = 4 at S = 5 (S*G = 20: the card's tile kernel); 27 + 5 = 32
    # ends on a boundary
    (5, 16, 4, 16, [140, 27, 0]),
    # a verify-shaped row; 62 + 2 = 64 ends on a boundary
    (2, 8, 2, 16, [200, 30, 62]),
])
def test_paged_attention_plain_matches_pallas_at_split_edges(S, Hq, Kv, bs,
                                                             lens):
    """The structure of the card's split cases: long contexts that the
    kernel splits over warps and CTAs, rows ending exactly on a block
    boundary, GQA rows sharing a KV head."""
    nb, MB, Dh = 48, 14, 32
    q, kp, vp, tables, lens = _paged_case(S * Hq, 3, S, Hq, Kv, Dh, nb, bs,
                                          MB, lens=lens)
    want = np.asarray(jax_paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(lens), block_size=bs,
        interpret=True))
    got = ref.paged_attention_plain(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(tables), torch.from_numpy(lens)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


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


@pytest.mark.parametrize("B,k,d_ff,d,n_empty", [
    (3, 13, 64, 32, 2),       # k not a multiple of 8 (the kernel's warps)
    (2, 130, 640, 128, 5),    # k = 130: the card splits it unevenly
])
def test_sparse_gather_matvec_plain_matches_pallas_at_split_edges(
        B, k, d_ff, d, n_empty):
    """k that no split divides, and an all-sentinel last row, whose output
    is exact zeros on both sides."""
    h, idx, w = _sparse_case(B * k, B, k, d_ff, d, n_empty)
    idx[B - 1] = d_ff
    got = ref.sparse_gather_matvec_plain(
        torch.from_numpy(h), torch.from_numpy(idx),
        torch.from_numpy(w)).numpy()
    pallas = np.asarray(jax_sparse(jnp.asarray(h), jnp.asarray(idx),
                                   jnp.asarray(w), interpret=True))
    np.testing.assert_allclose(got, pallas, **TOL)
    assert not got[B - 1].any() and not pallas[B - 1].any()


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


def _relu_ffn_case(seed, M, d, f, dead_blocks=()):
    """x, W_up, W_down; the W_up columns of each dead block of 128 are
    zero, so relu(x @ W_up) is 0 there and the kernels skip the block."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, d)).astype(np.float32)
    w_up = (rng.standard_normal((d, f)) * 0.1).astype(np.float32)
    for blk in dead_blocks:
        w_up[:, blk * 128:(blk + 1) * 128] = 0.0
    w_dn = (rng.standard_normal((f, d)) * 0.1).astype(np.float32)
    return x, w_up, w_dn


@pytest.mark.parametrize("M,d,f,bf,dead", [
    (2, 64, 512, 128, (1, 3)),   # test_relu_ffn_skips_dead_blocks_exactly
    (8, 128, 640, 128, (2,)),    # nectar prefill widths (the reference's
    (37, 128, 640, 128, ()),     # default block_f=512 does not divide 640)
    (4, 128, 1024, 128, ()),     # test_relu_ffn_fused_shapes
    (8, 64, 512, 256, ()),
])
def test_relu_ffn_plain_matches_pallas(M, d, f, bf, dead):
    x, w_up, w_dn = _relu_ffn_case(M + f, M, d, f, dead)
    want = np.asarray(jax_relu_ffn(jnp.asarray(x), jnp.asarray(w_up),
                                   jnp.asarray(w_dn), block_f=bf,
                                   interpret=True))
    got = ref.relu_ffn_plain(torch.from_numpy(x), torch.from_numpy(w_up),
                             torch.from_numpy(w_dn)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    oracle = np.asarray(jref.relu_ffn_ref(jnp.asarray(x), jnp.asarray(w_up),
                                          jnp.asarray(w_dn)))
    np.testing.assert_allclose(got, oracle, **TOL)


def _decode_case(seed, B, Hq, Kv, Dh, S):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, Dh)).astype(np.float32)
    k = rng.standard_normal((B, S, Kv, Dh)).astype(np.float32)
    v = rng.standard_normal((B, S, Kv, Dh)).astype(np.float32)
    kv_len = rng.integers(1, S + 1, B).astype(np.int32)
    kv_len[0] = S                       # the whole cache visible
    return q, k, v, kv_len


@pytest.mark.parametrize("B,Hq,Kv,Dh,S,bs", [
    (1, 4, 4, 16, 32, 16),    # the shapes of test_decode_attention_shapes
    (2, 8, 2, 32, 128, 32),
    (3, 8, 1, 16, 64, 16),
    (4, 4, 4, 32, 96, 32),    # nectar slot decode (Hq = Kv = 4, Dh 32)
])
def test_decode_attention_plain_matches_pallas(B, Hq, Kv, Dh, S, bs):
    q, k, v, kv_len = _decode_case(B * S, B, Hq, Kv, Dh, S)
    want = np.asarray(jax_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kv_len),
        block_s=bs, interpret=True))
    got = ref.decode_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(kv_len)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_decode_attention_plain_bf16_kv_matches_pallas():
    """bf16 q/K/V (rounded the same way on both sides), f32 softmax; the
    reference's own bf16 tolerance, 2e-2."""
    q, k, v, _ = _decode_case(7, 2, 4, 2, 32, 64)
    kv_len = np.array([17, 64], np.int32)
    jb = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)]
    tb = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    want = np.asarray(jax_decode_attention(*jb, jnp.asarray(kv_len),
                                           block_s=16, interpret=True))
    got = ref.decode_attention_plain(*tb, torch.from_numpy(kv_len))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=2e-2)


def test_decode_attention_plain_masks_past_the_cache_like_the_oracle():
    """kv_len > S (an idle slot of the slot engine, whose lens ran past
    max_seq) shows all S positions; kv_len = 0 masks every position, which
    leaves a uniform softmax over all S. Both as the jnp oracle does."""
    q, k, v, _ = _decode_case(9, 3, 4, 2, 16, 48)
    kv_len = np.array([48 + 7, 0, 1], np.int32)
    want = np.asarray(jref.decode_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kv_len)))
    got = ref.decode_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(kv_len)).numpy()
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
    fargs = [torch.from_numpy(a) for a in _relu_ffn_case(8, 5, 32, 200)]
    assert torch.equal(ops.relu_ffn_fused(*fargs), ref.relu_ffn_plain(*fargs))
    dargs = [torch.from_numpy(a) for a in _decode_case(9, 2, 4, 2, 16, 40)]
    assert torch.equal(ops.decode_attention(*dargs),
                       ref.decode_attention_plain(*dargs))
    assert ops.LAUNCHES == before


H100_SMS = 132


@pytest.mark.parametrize("S,Hq,Kv,Dh,kind,rows,n_split", [
    (1, 4, 4, 32, "rows", 1, 9),      # nectar decode
    (32, 4, 4, 32, "tile", 32, 9),    # nectar prefill chunk
    (1, 32, 8, 64, "rows", 4, 5),     # llama3.2-1b decode
    (5, 32, 8, 64, "tile", 32, 5),    # S*G = 20
    (32, 32, 8, 64, "tile", 64, 3),   # S*G = 128
    (3, 8, 2, 128, "rows", 16, 17),   # S*G = 12
])
def test_paged_plan_picks_kernel_and_split(S, Hq, Kv, Dh, kind, rows,
                                           n_split):
    """The wrapper's launch plan: the rows kernel below 16 query rows per
    KV head, the tile kernel from there; the split from the table width
    (MB 128, block 16) and the SM count, within the shared-memory limit."""
    plan = decode_attn.paged_plan(8, S, Hq, Kv, Dh, 16, 128, H100_SMS)
    assert (plan["kind"], plan["rows"], plan["n_split"]) == \
        (kind, rows, n_split)
    grid = plan["grid"]
    assert grid[0] == n_split and grid[2] == 8
    assert grid[1] * plan["rows"] >= Kv * S * (Hq // Kv) or kind == "rows"
    assert plan["smem"] <= decode_attn._SMEM_LIMIT


def test_paged_plan_takes_long_prefill_chunks_of_gqa_models():
    """The old kernel kept every query row of a KV head in one block's
    shared memory and refused S*G past ~200 at d_head 128; the tile kernel
    splits the rows over CTAs, so its shared memory does not grow with S."""
    small = decode_attn.paged_plan(2, 64, 32, 8, 128, 16, 256, H100_SMS)
    big = decode_attn.paged_plan(2, 2048, 32, 8, 128, 16, 256, H100_SMS)
    assert big["smem"] == small["smem"] <= decode_attn._SMEM_LIMIT
    assert big["grid"][1] == 8 * (2048 * 4 // 64)


@pytest.mark.parametrize("MB,bs", [(1, 8), (4, 8), (128, 16), (4096, 16)])
def test_paged_plan_never_splits_past_the_table(MB, bs):
    """Each split of the rows kernel gets at least one chunk per warp and
    each split of the tile kernel two chunks, counted on the table width;
    lens never enters the plan."""
    for S, Hq, Kv, chunk, least in ((1, 4, 4, 32, 4), (32, 8, 2, 32, 2)):
        plan = decode_attn.paged_plan(1, S, Hq, Kv, 32, bs, MB, H100_SMS)
        n_chunks = -(-MB * bs // chunk)
        assert 1 <= plan["n_split"] <= max(1, -(-n_chunks // least))


@pytest.mark.parametrize("B,k,d,n_split", [
    (8, 128, 128, 1),       # nectar decode: one CTA per row, 8 warps
    (256, 128, 128, 1),     # nectar mixed tick
    (8, 1024, 2048, 5),     # llama3.2-1b: 16 column tiles x 5 splits
    (3, 1001, 2048, 8),     # 7 splits of 126 slots and one of 119
    (1, 7, 96, 1),
])
def test_gather_plan_splits_k_without_empty_splits(B, k, d, n_split):
    """The kernel cuts k into n_split splits of ceil(k / n_split) slots:
    none may be empty, and each split's h and idx fit shared memory."""
    plan = sparse_ffn.gather_plan(B, k, d, H100_SMS)
    assert plan["n_split"] == n_split
    per = -(-k // plan["n_split"])
    assert per == plan["per"] and (plan["n_split"] - 1) * per < k
    assert plan["grid"] == (B, -(-(d // 4) // 32), n_split)
    assert plan["smem"] <= sparse_ffn._SMEM_LIMIT


def test_gather_plan_splits_a_huge_k_to_fit_shared_memory():
    plan = sparse_ffn.gather_plan(64, 100_000, 128, H100_SMS)
    assert plan["smem"] <= sparse_ffn._SMEM_LIMIT
    assert (plan["n_split"] - 1) * plan["per"] < 100_000 \
        <= plan["n_split"] * plan["per"]


@pytest.mark.parametrize("B,S,Hq,Kv,Dh,nbytes,rows,n_split", [
    (8, 2048, 4, 4, 32, 4, 1, 9),       # nectar slot decode, f32
    (8, 2048, 32, 8, 64, 4, 4, 5),      # llama3.2-1b widths, f32
    (8, 2048, 32, 8, 64, 2, 4, 5),      # the same, bf16 K/V
    (12, 333, 16, 2, 128, 4, 8, 11),    # G = 8: 42 chunks of 8 keys
    (1, 333, 40, 2, 128, 2, 16, 11),    # G = 20: two CTAs per KV head
    (4, 40, 4, 4, 32, 4, 1, 1),         # 2 chunks: no split
])
def test_decode_plan_picks_rows_and_split(B, S, Hq, Kv, Dh, nbytes, rows,
                                          n_split):
    """The wrapper's launch plan for kernel 5: query heads per CTA padded
    to 1, 4, 8 or 16; the split from S, B*Kv and the SM count, never from
    kv_len (the host cannot read it without a device->host sync); grid
    (n_split, Kv * ceil(G / rows), B)."""
    plan = decode_attn.decode_plan(B, S, Hq, Kv, Dh, nbytes, H100_SMS)
    G = Hq // Kv
    assert (plan["rows"], plan["n_split"]) == (rows, n_split)
    assert plan["grid"] == (n_split, Kv * -(-G // rows), B)
    assert plan["chunk"] == 32 // (Dh // 32)
    assert plan["smem"] <= decode_attn._SMEM_LIMIT


@pytest.mark.parametrize("S", [1, 7, 31, 32, 33, 333, 2048, 32768])
@pytest.mark.parametrize("B,Kv", [(1, 1), (8, 4), (64, 8)])
def test_decode_plan_leaves_no_split_empty(S, B, Kv):
    """Chunk c goes to split c % n_split: on the longest context (kv_len >=
    S) every split gets a chunk, and each split's first round gives every
    warp but those of the last split a chunk."""
    for Dh in (32, 64, 128):
        for G in (1, 4, 8):
            plan = decode_attn.decode_plan(B, S, Kv * G, Kv, Dh, 4,
                                           H100_SMS)
            n_chunks = -(-S // plan["chunk"])
            assert 1 <= plan["n_split"] <= n_chunks
            assert (plan["n_split"] - 1) * decode_attn._DECODE_WARPS \
                < n_chunks or plan["n_split"] == 1


@pytest.mark.parametrize("Dh", [32, 64, 128])
@pytest.mark.parametrize("nbytes", [4, 2])
def test_decode_plan_stays_within_shared_memory(Dh, nbytes):
    """Any G: past 16 query heads per KV head the heads take more CTAs,
    so shared memory stops growing."""
    smem = [decode_attn.decode_plan(2, 4096, Kv * G, Kv, Dh, nbytes,
                                    H100_SMS)["smem"]
            for Kv in (1, 8) for G in (1, 2, 4, 5, 8, 9, 16, 17, 64)]
    assert max(smem) <= decode_attn._SMEM_LIMIT
    assert max(smem) == decode_attn.decode_plan(2, 4096, 64, 1, Dh, nbytes,
                                                H100_SMS)["smem"]


@pytest.mark.parametrize("M,d,f,bm,grid", [
    (200, 128, 640, 16, (10, 13)),      # nectar slot prefill
    (8, 128, 640, 16, (10, 1)),
    (32, 2048, 8192, 32, (128, 1)),     # llama3.2-1b widths
    (1, 2048, 8192, 16, (128, 1)),
    (64, 96, 200, 64, (4, 1)),          # a tail block
    (65, 2048, 8192, 64, (64, 2)),
    (4096, 2048, 8192, 64, (3, 64)),    # a long prefill: the card is full
])
def test_ffn_plan_picks_row_tile_and_split(M, d, f, bm, grid):
    """One row tile for M <= 64 (every weight byte read once); above, the
    largest tile that still gives every SM a CTA; d_ff split over enough
    CTAs to fill the card; within the shared-memory limit."""
    from repro_torch.kernels import relu_ffn
    plan = relu_ffn.ffn_plan(M, d, f, H100_SMS)
    assert (plan["bm"], plan["grid"]) == (bm, grid)
    assert plan["smem"] <= relu_ffn._SMEM_LIMIT
    assert 1 <= plan["hb"] <= plan["bps"] and plan["hb"] * bm <= 256


@pytest.mark.parametrize("M", [1, 8, 32, 64, 65, 200, 4096])
@pytest.mark.parametrize("f", [1, 64, 200, 640, 642, 8192, 28672])
def test_ffn_plan_covers_every_block_once(M, f):
    """Split s owns d_ff blocks [s*bps, min(n_fb, (s+1)*bps)): together
    they cover every block of 64 exactly once and none is empty."""
    from repro_torch.kernels import relu_ffn
    plan = relu_ffn.ffn_plan(M, 128, f, H100_SMS)
    n_fb, bps = -(-f // 64), plan["bps"]
    owned = [b for s in range(plan["n_split"])
             for b in range(s * bps, min(n_fb, (s + 1) * bps))]
    assert owned == list(range(n_fb))
    assert all(s * bps < n_fb for s in range(plan["n_split"]))


@pytest.mark.parametrize("M,d", [(8, 128), (32, 2048), (200, 128),
                                 (4096, 2048)])
def test_ffn_plan_scratch_does_not_grow_with_d_ff(M, d):
    """The partials are [n_split, M, d] with n_split bounded by the SM
    count over the row tiles, not [ceil(f / 128), M, d]."""
    from repro_torch.kernels import relu_ffn
    scratch = [relu_ffn.ffn_plan(M, d, f, H100_SMS)["scratch"]
               for f in (640, 8192, 28672, 1 << 17)]
    n_mt = relu_ffn.ffn_plan(M, d, 1 << 17, H100_SMS)["grid"][1]
    assert max(scratch) <= -(-H100_SMS // n_mt) * M * d
    assert scratch[-1] < -(-(1 << 17) // 128) * M * d


@pytest.mark.parametrize("M", [1, 8, 17, 64, 65, 200])
@pytest.mark.parametrize("K", [4, 60, 68, 640, 2052, 14336, 1 << 17])
@pytest.mark.parametrize("N", [4, 132, 8192, 14336])
def test_nmce_plan_covers_every_chunk_once(M, K, N):
    """Split s owns K chunks [s*cps, min(n_ch, (s+1)*cps)) of 64 (the
    NMCE's vector register, so the int16 clip stays per chunk): together
    they cover every chunk exactly once and none is empty; the grid covers
    every column and row."""
    from repro_torch.kernels import nmce_matvec
    plan = nmce_matvec.nmce_plan(M, K, N, H100_SMS)
    n_ch, cps = -(-K // 64), plan["cps"]
    owned = [c for s in range(plan["n_split"])
             for c in range(s * cps, min(n_ch, (s + 1) * cps))]
    assert owned == list(range(n_ch))
    assert all(s * cps < n_ch for s in range(plan["n_split"]))
    n_nt, n_split, n_mt = plan["grid"]
    assert n_split == plan["n_split"] and n_nt * 128 >= N
    assert n_mt * 16 * plan["mt"] >= M and 1 <= plan["mt"] <= 4
    assert plan["scratch"] == (n_split * M * N if n_split > 1 else 0)


@pytest.mark.parametrize("N", [4, 128, 8192, 14336, 1 << 16])
def test_nmce_plan_stays_within_shared_memory(N):
    """The CTA keeps its x rows over its K range in shared memory beside the
    weight ring: the plan splits K further where a long K would not fit,
    for any M (up to 64 rows a CTA) and K."""
    from repro_torch.kernels import nmce_matvec
    for M in (1, 8, 16, 17, 32, 33, 48, 64, 65, 4096):
        for K in (4, 2048, 14336, 28672, 1 << 17):
            plan = nmce_matvec.nmce_plan(M, K, N, H100_SMS)
            rows = min(M, 64)
            assert plan["smem"] == 1024 + 8 * (64 * 128 + 16) \
                + rows * (plan["cps"] * 64 + 16)
            assert plan["smem"] <= nmce_matvec._SMEM_LIMIT


@pytest.mark.parametrize("M,K,N,n_split", [
    (8, 128, 640, 1),       # nectar up: small weights, one launch
    (8, 640, 128, 1),       # nectar down: one CTA walks K
    (8, 128, 2048, 1),      # nectar logits
    (8, 2048, 8192, 2),     # llama3.2-1b up: 64 column tiles, two waves
    (32, 2048, 8192, 2),    # of K fill the 132 SMs once
    (8, 4096, 14336, 1),    # Llama-3-8B up: 112 column tiles, no split
    (8, 14336, 4096, 4),    # Llama-3-8B down: 32 column tiles
    (4096, 2048, 8192, 1),  # a long prefill: the card is full
])
def test_nmce_plan_splits_only_to_fill_the_card(M, K, N, n_split):
    """No split for small weights (the combine launch costs more than one
    CTA's walk) nor where the column and row tiles fill the card; else as
    many splits as one wave of one CTA per SM holds."""
    from repro_torch.kernels import nmce_matvec
    plan = nmce_matvec.nmce_plan(M, K, N, H100_SMS)
    assert plan["n_split"] == n_split
    n_nt, _, n_mt = plan["grid"]
    assert n_nt * n_mt * n_split <= max(H100_SMS, n_nt * n_mt)


def test_nmce_plan_takes_tma_where_rows_are_16_byte_multiples():
    from repro_torch.kernels import nmce_matvec
    assert nmce_matvec.nmce_plan(8, 64, 8192, H100_SMS)["tma"]
    assert nmce_matvec.nmce_plan(8, 64, 48, H100_SMS)["tma"]
    assert not nmce_matvec.nmce_plan(8, 64, 132, H100_SMS)["tma"]
    assert not nmce_matvec.nmce_plan(8, 64, 4, H100_SMS)["tma"]


@pytest.mark.parametrize("G,Dh,S", [(1, 32, 333), (4, 64, 96), (8, 16, 48)])
def test_decode_attention_plain_matches_pallas_at_split_edges(G, Dh, S):
    """The kv_len edges the card's split design is held to: 1, 31-33,
    S-1, S (kv_len 0 and > S against the oracle above), GQA up to G = 8."""
    Kv = 2
    q, k, v, _ = _decode_case(G + Dh + S, 6, Kv * G, Kv, Dh, S)
    kv_len = np.array([1, 31, 32, 33, S - 1, S], np.int32)
    bs = 16 if S % 16 == 0 else S
    want = np.asarray(jax_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kv_len),
        block_s=bs, interpret=True))
    got = ref.decode_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(kv_len)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("M,d,f,dead", [
    (1, 128, 640, ()), (65, 96, 200, (1,)), (16, 30, 70, ()),
    (5, 64, 256, (0, 1)),     # every block dead: exact zeros
])
def test_relu_ffn_plain_matches_oracle_at_edges(M, d, f, dead):
    """The card's edge shapes against the jnp oracle: one row, a row tile
    past 64, d_ff tails, unaligned rows, every block dead."""
    x, w_up, w_dn = _relu_ffn_case(M * f + d, M, d, f, dead)
    want = np.asarray(jref.relu_ffn_ref(jnp.asarray(x), jnp.asarray(w_up),
                                        jnp.asarray(w_dn)))
    got = ref.relu_ffn_plain(torch.from_numpy(x), torch.from_numpy(w_up),
                             torch.from_numpy(w_dn)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    if len(dead) * 128 >= f:
        assert not got.any()
