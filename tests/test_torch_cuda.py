"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; without a CUDA device every test skips. On a machine with
the card and without JAX, run them with
``PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py``.
Tolerance atol=rtol=1e-5: kernel and plain version sum the same f32
terms in another order (bf16 K/V too: both widen the same bf16 values
exactly to f32; 1e-4 for the fused FFN's two chained products, which its
kernel runs as 3xTF32 on the tensor cores: ~2e-5 at d 2048). The W8A8
matmul is exact: its kernel must equal its plain version bit for bit.
Training: kernel 3's autograd rule at nectar's training shape, and three
nectar train steps on the card against the CPU. Multi-device: kernel 2
on a shard's column block of W_down, and a model-2 mesh of shards on the
card serving nectar's tokens.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import quant
from repro_torch.kernels import (decode_attn, nmce_matvec, ops, ref,
                                 relu_ffn, sparse_ffn)

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("S,Hq,Kv,Dh,bs", [(1, 4, 4, 32, 16),
                                           (5, 32, 8, 64, 16),
                                           (32, 8, 2, 128, 8),
                                           (1, 4, 2, 16, 16),
                                           (5, 4, 2, 16, 8),
                                           (16, 4, 2, 16, 16),
                                           (1, 8, 1, 16, 16),
                                           # musicgen-medium, G 1
                                           (1, 24, 24, 64, 16),
                                           (16, 24, 24, 64, 16),
                                           # qwen2-vl-72b, G 8
                                           (1, 64, 8, 128, 16),
                                           (16, 64, 8, 128, 16)])
def test_paged_attention_kernel_matches_plain(cuda, S, Hq, Kv, Dh, bs):
    rng = np.random.default_rng(S)
    B, nb, MB = 3, 40, 12
    lens = np.array([0, 37, 70], np.int32)
    tables = np.full((B, MB), nb, np.int32)
    free = list(rng.permutation(nb))
    for b in range(B - 1):                 # the last row stays IDLE
        n = -(-(int(lens[b]) + S) // bs)
        tables[b, :n] = [free.pop() for _ in range(n)]
    q = torch.tensor(rng.standard_normal((B, S, Hq, Dh)), dtype=torch.float32,
                     device=cuda)
    kp, vp = (torch.tensor(rng.standard_normal((nb, bs, Kv, Dh)),
                           dtype=torch.float32, device=cuda) for _ in range(2))
    t, ln = (torch.tensor(a, device=cuda) for a in (tables, lens))
    got = decode_attn.paged_attention(q, kp, vp, t, ln)
    want = ref.paged_attention_plain(q, kp, vp, t, ln)
    torch.cuda.synchronize()
    # the IDLE row reads block 0 through its sentinels, as the plain
    # version (and the reference's kernel) does
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("Hq,Kv,Dh,bs", [(4, 4, 32, 16), (32, 8, 64, 16)])
def test_paged_decode_attention_matches_plain(cuda, Hq, Kv, Dh, bs):
    """The S=1 wrapper over kernel 1 (kv_len counts the in-flight token)
    against the plain version through ``ops`` on the CPU; kv_len 1, a
    context ending on a block boundary and an IDLE row (all sentinel)."""
    rng = np.random.default_rng(Dh)
    nb, MB = 40, 12
    kv_len = np.array([1, 2 * bs, 71, 1], np.int32)
    B = len(kv_len)
    tables = np.full((B, MB), nb, np.int32)
    free = list(rng.permutation(nb))
    for b in range(B - 1):                 # the last row stays IDLE
        n = -(-int(kv_len[b]) // bs)
        tables[b, :n] = [free.pop() for _ in range(n)]
    arrays = (rng.standard_normal((B, Hq, Dh)),
              rng.standard_normal((nb, bs, Kv, Dh)),
              rng.standard_normal((nb, bs, Kv, Dh)))
    q, kp, vp = (torch.tensor(a, dtype=torch.float32) for a in arrays)
    t, kl = torch.tensor(tables), torch.tensor(kv_len)
    before = ops.LAUNCHES["paged_attention"]
    got = ops.paged_decode_attention(*(x.to(cuda) for x in (q, kp, vp, t,
                                                            kl)))
    torch.cuda.synchronize()
    assert ops.LAUNCHES["paged_attention"] == before + 1
    want = ops.paged_decode_attention(q, kp, vp, t, kl)
    assert got.shape == (B, Hq, Dh)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("B,k,d_ff,d", [(8, 128, 640, 128),
                                        (5, 1024, 8192, 2048)])
def test_sparse_gather_kernel_matches_plain(cuda, B, k, d_ff, d):
    rng = np.random.default_rng(k)
    idx = np.stack([rng.permutation(d_ff)[:k] for _ in range(B)])
    idx[:, k // 2:] = np.where(rng.random((B, k - k // 2)) < 0.3, d_ff,
                               idx[:, k // 2:])
    h = torch.tensor(rng.standard_normal((B, k)), dtype=torch.float32,
                     device=cuda)
    w = torch.tensor(rng.standard_normal((d_ff, d)) * d_ff ** -0.5,
                     dtype=torch.float32, device=cuda)
    i = torch.tensor(idx, dtype=torch.int32, device=cuda)
    got = sparse_ffn.sparse_gather_matvec(h, i, w)
    want = ref.sparse_gather_matvec_plain(h, i, w)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)


def _paged_edge_inputs(rng, cuda, S, Hq, Kv, Dh, bs, MB, lens,
                       pool_dtype=torch.float32):
    """Pools and scattered tables covering each row's causal limit; the
    last row is IDLE (all sentinel)."""
    B = len(lens)
    nb = B * MB
    tables = np.full((B, MB), nb, np.int32)
    free = list(rng.permutation(nb))
    for b in range(B - 1):
        n = -(-(lens[b] + S) // bs)
        tables[b, :n] = [free.pop() for _ in range(n)]
    q = torch.tensor(rng.standard_normal((B, S, Hq, Dh)), dtype=torch.float32,
                     device=cuda)
    kp, vp = (torch.tensor(rng.standard_normal((nb, bs, Kv, Dh)),
                           dtype=pool_dtype, device=cuda) for _ in range(2))
    return (q, kp, vp, torch.tensor(tables, device=cuda),
            torch.tensor(np.asarray(lens, np.int32), device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("bs", [8, 16, 32])
@pytest.mark.parametrize("S,G,MB", [(1, 1, 64), (1, 4, 64), (3, 4, 64),
                                    (4, 4, 64), (5, 4, 64), (32, 1, 64),
                                    (32, 4, 64), (1, 1, 4), (4, 4, 4)])
def test_paged_attention_kernel_split_edges(cuda, bs, S, G, MB):
    """The edges of the split design: a row of one block (where S <= bs),
    rows ending exactly on a block boundary, a long context split unevenly
    over warps and CTAs, an IDLE row (block 0 through its sentinels, as
    the plain version reads it); S*G from 1 to 128
    (rows kernel below 16, tile kernel from 16), a narrow table (MB 4: no
    split). Launched twice: the same bits."""
    rng = np.random.default_rng(bs * 100 + S * 10 + G)
    Dh, Kv = (32, 64, 128)[(S + G + bs) % 3], 2
    cap = MB * bs - S
    lens = [max(0, min(cap, x))
            for x in (bs - S, 3 * bs - S, cap - 11, 37 * bs + 5, 0)]
    args = _paged_edge_inputs(rng, cuda, S, Kv * G, Kv, Dh, bs, MB, lens)
    got = decode_attn.paged_attention(*args)
    again = decode_attn.paged_attention(*args)
    want = ref.paged_attention_plain(*args)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,Dh", [(torch.float32, 16),
                                      (torch.bfloat16, 16),
                                      (torch.bfloat16, 32),
                                      (torch.bfloat16, 64),
                                      (torch.bfloat16, 128)])
@pytest.mark.parametrize("bs", [8, 16])
@pytest.mark.parametrize("S,G,MB", [(1, 1, 64), (1, 2, 64), (3, 4, 64),
                                    (5, 4, 64), (16, 2, 64), (32, 4, 64),
                                    (1, 1, 4), (4, 4, 4)])
def test_paged_attention_kernel_dh16_and_bf16_pools(cuda, dtype, Dh, bs, S,
                                                    G, MB):
    """Head dim 16 (the SMOKE configs' and the reference's own kernel
    sweeps, tests/test_kernels.py) with f32 and bf16 pools, and bf16 pools
    at every other head dim, over the same edges as the f32 sweep: rows
    and tile kernels, split and unsplit, an IDLE row (block 0 through its
    sentinels).
    Launched twice: the same bits."""
    rng = np.random.default_rng(bs * 100 + S * 10 + G + Dh)
    Kv = 2
    cap = MB * bs - S
    lens = [max(0, min(cap, x))
            for x in (bs - S, 3 * bs - S, cap - 11, 37 * bs + 5, 0)]
    args = _paged_edge_inputs(rng, cuda, S, Kv * G, Kv, Dh, bs, MB, lens,
                              pool_dtype=dtype)
    got = decode_attn.paged_attention(*args)
    again = decode_attn.paged_attention(*args)
    want = ref.paged_attention_plain(*args)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_paged_attention_refuses_other_head_dims(cuda):
    """A head dim outside {16, 32, 64, 128} raises before any launch;
    mixed pool types raise too. No fallback to the plain version."""
    rng = np.random.default_rng(0)
    args = _paged_edge_inputs(rng, cuda, 1, 4, 2, 48, 16, 4, [3, 0])
    with pytest.raises(ValueError, match="d_head"):
        decode_attn.paged_attention(*args)
    q, kp, vp, t, ln = _paged_edge_inputs(rng, cuda, 1, 4, 2, 16, 16, 4,
                                          [3, 0])
    with pytest.raises(TypeError, match="v_pool"):
        decode_attn.paged_attention(q, kp, vp.bfloat16(), t, ln)


@pytest.mark.cuda
@pytest.mark.parametrize("B,k,d_ff,d", [
    (3, 1001, 8192, 2048),    # k not a multiple of the split
    (4, 130, 640, 128),       # k not a multiple of the 8 warps
    (2, 7, 50, 96),           # k below one slot per warp, a ragged tile
    (300, 128, 640, 128),     # many rows
    (1, 4097, 9000, 68),      # the last row is also the only row
])
def test_sparse_gather_kernel_split_edges(cuda, B, k, d_ff, d):
    """k that no split divides, ragged column tiles, and an all-empty last
    row (exact zeros). Launched twice: the same bits."""
    rng = np.random.default_rng(k + d)
    idx = np.stack([rng.permutation(d_ff)[:k] for _ in range(B)])
    idx = np.where(rng.random((B, k)) < 0.2, d_ff, idx)
    idx[B - 1] = d_ff
    h = torch.tensor(rng.standard_normal((B, k)), dtype=torch.float32,
                     device=cuda)
    w = torch.tensor(rng.standard_normal((d_ff, d)) * d_ff ** -0.5,
                     dtype=torch.float32, device=cuda)
    i = torch.tensor(idx, dtype=torch.int32, device=cuda)
    got = sparse_ffn.sparse_gather_matvec(h, i, w)
    again = sparse_ffn.sparse_gather_matvec(h, i, w)
    want = ref.sparse_gather_matvec_plain(h, i, w)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)
    assert torch.equal(got[-1], torch.zeros_like(got[-1]))
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("Hq,Kv,Dh,S,dtype", [
    (4, 4, 32, 2048, torch.float32),      # nectar slot decode
    (32, 8, 64, 2048, torch.float32),     # llama3.2-1b widths
    (32, 8, 64, 300, torch.bfloat16),
    (8, 2, 128, 77, torch.float32),
    (4, 4, 16, 96, torch.float32),        # the reference's Dh-16 sweeps
    (8, 1, 16, 64, torch.float32),
    (4, 2, 16, 2048, torch.bfloat16),
    (32, 32, 80, 512, torch.float32),     # zamba2-2.7b's shared attention
    (32, 32, 80, 300, torch.bfloat16),
    (4, 4, 80, 96, torch.float32),
    (24, 24, 64, 512, torch.float32),     # musicgen-medium's slot decode
    (24, 24, 64, 300, torch.bfloat16)])
def test_decode_attention_kernel_matches_plain(cuda, Hq, Kv, Dh, S, dtype):
    """kv_len 1..S, past S (an idle slot: all S visible) and 0 (every
    position masked: a mean over all S)."""
    rng = np.random.default_rng(Dh + S)
    B = 6
    kv_len = np.array([1, S // 3, S, S + 5, 0, 33], np.int32)
    q = torch.tensor(rng.standard_normal((B, Hq, Dh)), dtype=torch.float32,
                     device=cuda)
    k, v = (torch.tensor(rng.standard_normal((B, S, Kv, Dh)), dtype=dtype,
                         device=cuda) for _ in range(2))
    ln = torch.tensor(kv_len, device=cuda)
    got = decode_attn.decode_attention(q, k, v, ln)
    again = decode_attn.decode_attention(q, k, v, ln)
    want = ref.decode_attention_plain(q, k, v, ln)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G", [1, 4, 8, 20])
@pytest.mark.parametrize("Dh", [16, 32, 64, 80, 128])
def test_decode_attention_kernel_split_edges(cuda, dtype, G, Dh):
    """The edges of the split design (``decode_plan``): kv_len 0, 1,
    31-33, S-1, S, S+5, and one key either side of the last chunk of a
    round over the splits and over the warps; S = 333 is no multiple of a
    chunk; G = 20 takes two CTAs per KV head. Launched twice: the same
    bits."""
    from repro_torch.kernels import build
    rng = np.random.default_rng(G * 1000 + Dh)
    S, Kv = 333, 2
    plan = decode_attn.decode_plan(12, S, Kv * G, Kv, Dh, dtype.itemsize,
                                   build.sm_count(cuda.index or 0))
    kc, ns = plan["chunk"], plan["n_split"]
    kv_len = np.array([0, 1, 31, 32, 33, S - 1, S, S + 5, kc * ns - 1,
                       kc * ns + 1, kc * ns * 4 + 1,
                       min(S, kc * ns * 4) - 1], np.int32)
    B = len(kv_len)
    q = torch.tensor(rng.standard_normal((B, Kv * G, Dh)),
                     dtype=torch.float32, device=cuda)
    k, v = (torch.tensor(rng.standard_normal((B, S, Kv, Dh)), dtype=dtype,
                         device=cuda) for _ in range(2))
    ln = torch.tensor(kv_len, device=cuda)
    got = decode_attn.decode_attention(q, k, v, ln)
    again = decode_attn.decode_attention(q, k, v, ln)
    want = ref.decode_attention_plain(q, k, v, ln)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("M,d,f", [(8, 128, 640), (200, 128, 640),
                                   (32, 2048, 8192), (5, 96, 200)])
def test_relu_ffn_kernel_matches_plain(cuda, M, d, f):
    """Dead d_ff blocks forced by zero W_up columns, and a tail block when
    f is not a multiple of 128."""
    rng = np.random.default_rng(M + f)
    w_up = rng.standard_normal((d, f)) * d ** -0.5
    w_up[:, 128:256] = 0.0
    x, wu, wd = (torch.tensor(a, dtype=torch.float32, device=cuda) for a in (
        rng.standard_normal((M, d)), w_up,
        rng.standard_normal((f, d)) * f ** -0.5))
    got = relu_ffn.relu_ffn(x, wu, wd)
    want = ref.relu_ffn_plain(x, wu, wd)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)
    assert torch.equal(got, relu_ffn.relu_ffn(x, wu, wd))   # deterministic


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 16, 64, 65, 200])
@pytest.mark.parametrize("d,f", [(128, 640), (96, 200), (30, 70),
                                 (128, 642)])
@pytest.mark.parametrize("live", ["none", "some", "all"])
def test_relu_ffn_kernel_split_edges(cuda, M, d, f, live):
    """The edges of the design (``ffn_plan``): one row tile up to M = 64,
    several above; a d_ff tail; rows that are not 16-byte aligned (d 30,
    f 70 and 642); every d_ff block dead (exact zeros), some, none.
    Launched twice: the same bits."""
    rng = np.random.default_rng(M * 7 + d + f)
    w_up = rng.standard_normal((d, f)) * d ** -0.5
    if live == "none":
        w_up[:] = 0.0
    elif live == "some":
        w_up[:, 64:192] = 0.0
    x, wu, wd = (torch.tensor(a, dtype=torch.float32, device=cuda) for a in (
        rng.standard_normal((M, d)), w_up,
        rng.standard_normal((f, d)) * f ** -0.5))
    got = relu_ffn.relu_ffn(x, wu, wd)
    again = relu_ffn.relu_ffn(x, wu, wd)
    want = ref.relu_ffn_plain(x, wu, wd)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)
    assert torch.equal(got, again)
    if live == "none":
        assert not got.any()


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [
    (8, 128, 640), (8, 640, 128), (8, 2048, 8192), (3, 100, 36),
    (32, 2048, 8192),                       # llama3.2-1b up at M = 32
    # M across the mma row tiles and past one CTA's 64 rows; K off the
    # 64-wide chunk; N % 16 != 0 (the cp.async path)
    (1, 2052, 132), (15, 2052, 132), (16, 2052, 132), (17, 2052, 132),
    (64, 2052, 132), (65, 2052, 132),
    (8, 4, 4), (8, 60, 132), (8, 68, 4), (8, 2052, 48),
    # K on the split's chunk boundaries (nmce_plan: two splits of 11 or
    # 12 chunks at N 8192, four at N 4096)
    (8, 1408, 8192), (8, 1404, 8192), (8, 1412, 8192), (8, 132, 8192),
    (8, 14336, 4096),
])
@pytest.mark.parametrize("sat", [False, True])
def test_nmce_matmul_kernel_equals_plain(cuda, M, K, N, sat):
    """Bit for bit, and the same bits on a relaunch."""
    rng = np.random.default_rng(K + N)
    x = torch.tensor(rng.standard_normal((M, K)) * 10, device=cuda)
    w = torch.tensor(rng.standard_normal((K, N)) * 10, device=cuda)
    xq, wq = quant.quantize_int8(x, axis=0), quant.quantize_int8(w, axis=1)
    xs, ws = xq.scale.reshape(-1, 1), wq.scale.reshape(1, -1)
    got = nmce_matvec.nmce_matmul(xq.q, wq.q, xs, ws, saturate_int16=sat)
    again = nmce_matvec.nmce_matmul(xq.q, wq.q, xs, ws, saturate_int16=sat)
    want = ref.nmce_matmul_plain(xq.q, wq.q, xs, ws, saturate_int16=sat)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("axis", [0, 1, None])
def test_quantize_int8_on_the_card_equals_the_cpu(cuda, axis):
    """q and scale bit-equal across devices, so ops.nmce_matmul on the card
    equals the CPU result (the scale divides by a tensor: a division by
    the number 127 runs as a reciprocal product in PyTorch's CUDA
    kernels)."""
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.standard_normal((64, 300)) * 7, dtype=torch.float32)
    got = quant.quantize_int8(x.to(cuda), axis=axis)
    want = quant.quantize_int8(x, axis=axis)
    assert torch.equal(got.q.cpu(), want.q)
    assert torch.equal(got.scale.cpu(), want.scale)


# ---------------------------------------------------------------------------
# the shapes speculative decoding gives the kernels


@pytest.mark.cuda
@pytest.mark.parametrize("S", [5, 9])
def test_paged_attention_at_the_verify_shape(cuda, S):
    """Verify rows of nectar (Hq = Kv = 4, Dh 32, bs 16, 128 blocks a
    row): S = K+1 query rows a slot at k_max 4 and 8, the last slot IDLE.
    Launched twice: the same bits."""
    rng = np.random.default_rng(100 + S)
    B, bs, MB, nb = 8, 16, 128, 8 * 128
    lens = rng.integers(1, 232 - S, B).astype(np.int32)
    tables = np.full((B, MB), nb, np.int32)
    free = list(rng.permutation(nb))
    for b in range(B - 1):
        n = -(-(int(lens[b]) + S) // bs)
        tables[b, :n] = [free.pop() for _ in range(n)]
    q = torch.tensor(rng.standard_normal((B, S, 4, 32)), dtype=torch.float32,
                     device=cuda)
    kp, vp = (torch.tensor(rng.standard_normal((nb, bs, 4, 32)),
                           dtype=torch.float32, device=cuda) for _ in range(2))
    t, ln = (torch.tensor(a, device=cuda) for a in (tables, lens))
    got = decode_attn.paged_attention(q, kp, vp, t, ln)
    again = decode_attn.paged_attention(q, kp, vp, t, ln)
    want = ref.paged_attention_plain(q, kp, vp, t, ln)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_decode_attention_at_the_draft_shape_with_parked_rows(cuda):
    """The draft model's step (Hq = Kv = 2, Dh 32, a [8, 2048] cache):
    rows parked at lens = max_seq read kv_len max_seq + 1, clamped to the
    cache. Launched twice: the same bits."""
    rng = np.random.default_rng(7)
    B, S = 8, 2048
    kv_len = np.array([1, 17, 230, S + 1, 64, S + 1, 9, S + 1], np.int32)
    q = torch.tensor(rng.standard_normal((B, 2, 32)), dtype=torch.float32,
                     device=cuda)
    k, v = (torch.tensor(rng.standard_normal((B, S, 2, 32)),
                         dtype=torch.float32, device=cuda) for _ in range(2))
    ln = torch.tensor(kv_len, device=cuda)
    got = decode_attn.decode_attention(q, k, v, ln)
    again = decode_attn.decode_attention(q, k, v, ln)
    want = ref.decode_attention_plain(q, k, v, ln)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("B,k,d_ff,d", [
    (72, 128, 640, 128),      # verify rows: 8 slots x 9 positions
    (8, 128, 256, 64),        # the draft model's sparse FFN
    (8, 32, 640, 128),        # self-spec's predicted down rows
])
def test_sparse_gather_at_the_spec_shapes(cuda, B, k, d_ff, d):
    rng = np.random.default_rng(B + k + d)
    idx = np.stack([rng.permutation(d_ff)[:k] for _ in range(B)])
    idx = np.where(rng.random((B, k)) < 0.1, d_ff, idx)
    h = torch.tensor(np.abs(rng.standard_normal((B, k))),
                     dtype=torch.float32, device=cuda)
    w = torch.tensor(rng.standard_normal((d_ff, d)) * d_ff ** -0.5,
                     dtype=torch.float32, device=cuda)
    i = torch.tensor(idx, dtype=torch.int32, device=cuda)
    got = sparse_ffn.sparse_gather_matvec(h, i, w)
    again = sparse_ffn.sparse_gather_matvec(h, i, w)
    want = ref.sparse_gather_matvec_plain(h, i, w)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_verify_row_matches_sequential_decode_on_the_card(cuda):
    """One K+1-position VERIFY row through kernels 1 and 2 gives, within
    1e-4, the logits of feeding the same tokens one DECODE row at a
    time."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    cfg = get_config("nectar-relu-llama-1.7m")
    model = Model(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0),
                        device=cuda)
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, cfg.vocab, 13, dtype=np.int32)
    toks = rng.integers(0, cfg.vocab, 9, dtype=np.int32)
    bs, MB, nb = 16, 8, 16
    P = len(prompt)

    def fresh():
        c = model.init_paged_cache(1, nb, bs, MB, device=cuda)
        c["block_tables"] = torch.arange(MB, dtype=torch.int32,
                                         device=cuda)[None]
        c["lens"] = torch.zeros(1, dtype=torch.int32, device=cuda)
        with torch.no_grad():
            model.forward_step(
                params, torch.tensor(np.pad(prompt, (0, 32 - P))[None],
                                     device=cuda), c,
                torch.tensor([P], dtype=torch.int32, device=cuda),
                torch.ones(1, dtype=torch.bool, device=cuda), bs,
                backend="flash")
        return c

    def step(c, t, lens):
        c["lens"] = torch.tensor([lens], dtype=torch.int32, device=cuda)
        with torch.no_grad():
            return model.forward_step(
                params, torch.tensor(np.asarray(t, np.int32)[None],
                                     device=cuda), c,
                torch.tensor([len(t)], dtype=torch.int32, device=cuda),
                torch.zeros(1, dtype=torch.bool, device=cuda), bs,
                backend="flash", has_prefill=False)[0].cpu().numpy()

    verify = step(fresh(), toks, P)
    c = fresh()
    seq = np.stack([step(c, [t], P + i)[0] for i, t in enumerate(toks)])
    np.testing.assert_allclose(verify, seq, atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_decode_attention_refuses_other_head_dims(cuda):
    """A head dim outside {16, 32, 64, 80, 128} raises before any launch
    (80 is kernel 5's alone: kernel 1 keeps its list)."""
    q = torch.zeros((2, 4, 48), device=cuda)
    k = torch.zeros((2, 8, 4, 48), device=cuda)
    with pytest.raises(ValueError, match="d_head"):
        decode_attn.decode_attention(q, k, k, torch.ones(2, dtype=torch.int32,
                                                         device=cuda))
    rng = np.random.default_rng(0)
    args = _paged_edge_inputs(rng, cuda, 1, 4, 2, 80, 16, 4, [3, 0])
    with pytest.raises(ValueError, match="d_head"):
        decode_attn.paged_attention(*args)


@pytest.mark.cuda
def test_paged_flash_step_with_a_bf16_model(cuda, monkeypatch):
    """A bf16 model's paged step through kernel 1: its bf16 q is widened
    to f32 at the call (the pools are f32 for every model), the kernel
    launches once per layer, and every launch's output equals the plain
    version's on the same inputs (TOL)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import Model
    cfg = dataclasses.replace(get_config("llama3.2-1b-smoke"),
                              dtype="bfloat16")
    model = Model(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0),
                        device=cuda)
    assert params["embed"].dtype == torch.bfloat16
    calls = []
    launch = ops.paged_attention

    def recording(q, k_pool, v_pool, tables, lens):
        out = launch(q, k_pool, v_pool, tables, lens)
        calls.append((q.dtype, out, ref.paged_attention_plain(
            q, k_pool, v_pool, tables, lens)))
        return out
    monkeypatch.setattr(ops, "paged_attention", recording)
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, cfg.vocab, 13, dtype=np.int32)
    bs, MB, nb = 16, 4, 8
    c = model.init_paged_cache(1, nb, bs, MB, device=cuda)
    c["block_tables"] = torch.arange(MB, dtype=torch.int32,
                                     device=cuda)[None]
    before = ops.LAUNCHES["paged_attention"]
    with torch.no_grad():
        logits = model.forward_step(
            params, torch.tensor(prompt[None], device=cuda), c,
            torch.tensor([len(prompt)], dtype=torch.int32, device=cuda),
            torch.ones(1, dtype=torch.bool, device=cuda), bs,
            backend="flash")
    torch.cuda.synchronize()
    assert ops.LAUNCHES["paged_attention"] - before == cfg.n_layers
    assert len(calls) == cfg.n_layers
    for q_dtype, got, want in calls:
        assert q_dtype == torch.float32
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   **TOL)
    assert logits.dtype == torch.float32
    assert torch.isfinite(logits).all()


# ---------------------------------------------------------------------------
# the async engine's decode iteration on the card: a captured graph

KERNEL_ATOL = 1e-4     # chip_smoke.py's: the same terms in another order


def _async_engine(cuda, K, **kw):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import AsyncConfig, ServeConfig
    from repro_torch.models import Model
    from repro_torch.serve.engine import Engine
    cfg = get_config("nectar-relu-llama-1.7m")
    params = Model(cfg).init(torch.Generator(device=cuda).manual_seed(0),
                             device=cuda)
    sc = ServeConfig(paged=True, attn_backend="flash", max_batch=8,
                     async_cfg=AsyncConfig(enabled=True, max_device_ticks=K),
                     **kw)
    return cfg, Engine(cfg, params, sc, device=cuda)


def _prefilled(cuda, K, n=5):
    """An async engine with ``n`` nectar prompts prefilled (one sync
    tick), and those requests."""
    from repro_torch.serve.scheduler import Request
    cfg, eng = _async_engine(cuda, K)
    rng = np.random.default_rng(9)
    reqs = [Request(rid=eng.new_rid(),
                    prompt=rng.integers(0, cfg.vocab, int(m), dtype=np.int32),
                    max_new=12) for m in rng.integers(5, 30, n)]
    for r in reqs:
        assert eng.add_request(r)
    eng.step()
    assert all(r.tokens_out for r in reqs)
    return cfg, eng, reqs


@pytest.mark.cuda
@pytest.mark.parametrize("sampled", [False, True])
def test_captured_iteration_matches_the_eager_iteration(cuda, sampled):
    """One replay of the captured decode iteration against the same
    iteration run eagerly on the same inputs: logits within KERNEL_ATOL
    (cuBLAS may pick another algorithm under capture); two replays give
    the same bits."""
    from repro_torch.serve.runner import STOP_L, STOP_NS
    cfg, eng, reqs = _prefilled(cuda, 4)
    runner = eng.runner
    st = runner._burst(sampled, 4)
    assert st.graph is not None
    B = eng.scfg.max_batch
    # a served burst keeps no logits: this one captures again with them
    # (from a zeroed state, so the warm-up writes only the trash blocks)
    st.buf.zero_()
    st.state["logits"] = torch.zeros((B, cfg.vocab), device=cuda)
    runner._capture(st)
    tok0 = np.zeros(B, np.int32)
    lens0 = np.zeros(B, np.int32)
    alive0 = np.zeros(B, np.int32)
    for r in reqs:
        e = eng.sched.active[r.rid]
        tok0[e.slot], lens0[e.slot], alive0[e.slot] = (
            r.tokens_out[-1], e.ctx_len, 1)
    keys = np.random.default_rng(2).integers(0, 2 ** 32, (4, B, 2))
    args = (eng.pool.tables(), tok0, lens0, alive0, alive0 * 4,
            np.full((B, STOP_NS, STOP_L), -1, np.int32),
            np.zeros((B, STOP_NS), np.int32),
            np.full((B, STOP_L), -1, np.int32), keys,
            np.full(B, 0.8, np.float32), np.zeros(B, np.int32),
            np.ones(B, np.float32))
    out = []
    for replay in (True, True, False):
        runner._stage_burst(st, *args)
        if replay:
            runner._iterate(st, 1)
        else:
            runner._iteration(st)
        torch.cuda.synchronize()
        out.append({k: st.state[k].clone()
                    for k in ("logits", "emitted", "lp", "n_emit")})
    rows = torch.tensor(alive0 > 0, device=cuda)
    for k in out[0]:
        assert torch.equal(out[0][k], out[1][k]), k
    np.testing.assert_allclose(out[0]["logits"][rows].cpu().numpy(),
                               out[2]["logits"][rows].cpu().numpy(),
                               atol=KERNEL_ATOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 8])
def test_async_ticks_make_no_host_sync(cuda, K):
    """Every async tick after the prefills (overlap ticks for K = 1,
    bursts for K = 8) runs under set_sync_debug_mode("error"): nothing in
    them synchronizes the stream, apart from the one CUDA event a tick
    waits on."""
    cfg, eng, reqs = _prefilled(cuda, K)
    torch.cuda.set_sync_debug_mode("error")
    try:
        while eng._busy():
            eng.step()
        eng.step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(len(r.tokens_out) == 12 for r in reqs)
    st = eng.async_stats()
    assert st["overlap_ticks" if K == 1 else "loop_bursts"] > 0
    assert eng.runner.graph_replays > 0


@pytest.mark.cuda
def test_sync_step_makes_no_host_sync(cuda):
    """The synchronous step (staged inputs, the sync-free paged KV write,
    a prefill and a decode row) dispatches without a sync as well."""
    from repro_torch.serve.runner import DECODE, PREFILL
    cfg, eng = _async_engine(cuda, 1)
    runner = eng.runner
    MB = eng.scfg.blocks_per_seq
    tables = np.full((8, MB), eng.pool.n_blocks, np.int32)
    tables[0, :2], tables[3, :1] = [4, 9], [2]
    batch = runner.new_batch(20, tables)
    batch.add_row(0, PREFILL, np.arange(20) % cfg.vocab, 0)
    batch.add_row(3, DECODE, [7], 5)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = runner.step(batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(out.last_logits[[0, 3]]).all()


# ---------------------------------------------------------------------------
# tracing on the card: each step's device time from CUDA timing events


def _traced_serve(cuda, obs, K=None, n=5, max_new=12):
    """Serve ``n`` nectar prompts through the paged engine (async with
    ``K`` device ticks where given) with ObsConfig ``obs``; returns the
    engine and the tokens."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import AsyncConfig, ObsConfig, ServeConfig
    from repro_torch.models import Model
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.scheduler import Request
    cfg = get_config("nectar-relu-llama-1.7m")
    params = Model(cfg).init(torch.Generator(device=cuda).manual_seed(0),
                             device=cuda)
    sc = ServeConfig(paged=True, attn_backend="flash", max_batch=8,
                     obs=ObsConfig(**obs),
                     async_cfg=None if K is None else AsyncConfig(
                         enabled=True, max_device_ticks=K))
    eng = Engine(cfg, params, sc, device=cuda)
    rng = np.random.default_rng(9)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, int(m),
                                               dtype=np.int32),
                    max_new=max_new) for i, m in
            enumerate(rng.integers(5, 30, n))]
    done = eng.run(reqs, max_steps=1000)
    return eng, {i: list(r.tokens_out) for i, r in done.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("K", [None, 1, 8])
def test_traced_ticks_read_device_time_from_events(cuda, K):
    """Sync steps, overlap ticks and bursts (graph replays, the events
    around them, never inside the capture) all report device time; tokens
    equal the untraced serve's."""
    eng, toks = _traced_serve(cuda, dict(enabled=True), K)
    _, plain = _traced_serve(cuda, {}, K)
    assert toks == plain
    stats = eng.tracer.tick_stats
    timed = [t for t in stats if t["device_ms"] > 0]
    assert timed and all(t["device_ms"] < 1e4 for t in stats)
    waits = [s for s in eng.tracer.spans if s.name == "device_wait"]
    assert waits
    if K == 8:
        bursts = [t for t in stats if t.get("async_mode") == "loop"]
        assert bursts and all(t["device_ms"] > 0 for t in bursts)
        assert any(t["device_ticks"] > 1 for t in bursts)
        assert eng.runner.graph_replays > 0
    if K != 1:
        # a tick that waits (samples, or a burst's copy) waits past its
        # own steps: their device span lies within the tick. A tick that
        # samples nothing (a prefill chunk mid-prompt) returns before its
        # step ends, and an overlap tick's step runs on into the next
        waited = {s.tick for s in eng.tracer.spans
                  if s.name == "device_wait"}
        for t in stats:
            if t["tick"] in waited:
                assert t["device_ms"] <= t["dur_ms"] * 1.01 + 0.05


@pytest.mark.cuda
@pytest.mark.parametrize("K", [None, 8])
def test_untraced_serve_makes_no_timing_event(cuda, K, monkeypatch):
    """With tracing off no timing event is made (the async path's one
    copy-done event per tick is not a timing event); with tracing on,
    each step makes its pair, and none of them is waited for: the tracer
    reads them once the engine's own waits have passed them."""
    made, waits = [], []
    event = torch.cuda.Event

    class Counting(event):
        def __new__(cls, *args, **kwargs):
            if kwargs.get("enable_timing"):
                made.append(1)
            return super().__new__(cls, *args, **kwargs)

        def synchronize(self):
            waits.append(1)
            return super().synchronize()

        def wait(self, stream=None):
            waits.append(1)
            return super().wait(stream)
    monkeypatch.setattr(torch.cuda, "Event", Counting)
    _traced_serve(cuda, {}, K, n=3, max_new=6)
    assert not made
    untraced_waits = len(waits)
    eng, _ = _traced_serve(cuda, dict(enabled=True), K, n=3, max_new=6)
    assert made and len(made) % 2 == 0
    assert len(waits) == 2 * untraced_waits
    assert not eng.tracer._clocks


@pytest.mark.cuda
def test_profiled_serve_judged_against_the_h100_entry(cuda):
    from repro_torch.roofline import hw
    if torch.cuda.get_device_name(cuda) not in hw.H100_SXM_NAMES:
        pytest.skip("not an H100 SXM card")
    eng, _ = _traced_serve(cuda, dict(enabled=True, profile=True))
    rows = eng.profiler.report(eng.tracer.tick_stats)
    assert {r["bucket"] for r in rows} >= {"decode"}
    for r in rows:
        assert r["chip"] == "h100-sxm" and 0 < r["attain"] <= 1
        assert r["n_keys"] < 8 * eng.scfg.blocks_per_seq * 16


# ---------------------------------------------------------------------------
# the disagg handoff and the fleet's parallel polling on the card


def _nectar_params(cuda):
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    cfg = get_config("nectar-relu-llama-1.7m")
    return cfg, Model(cfg).init(torch.Generator(device=cuda).manual_seed(0),
                                device=cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_quant", [False, True], ids=["f32", "int8"])
def test_import_blocks_from_in_place_and_bit_equal(cuda, kv_quant):
    """A handoff between two engines on the card copies every leaf (int8
    payloads and scales included) bit for bit into the decode pool's
    existing storage (the same data_ptr before and after), leaves every
    other block of the pool untouched, and the adopted row decodes."""
    from repro_torch.configs.base import ServeConfig
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.scheduler import Request
    cfg, params = _nectar_params(cuda)
    sc = ServeConfig(paged=True, max_batch=2, max_seq=256, block_size=16,
                     kv_quant=kv_quant,
                     attn_backend="naive" if kv_quant else "flash")
    pre, dec = (Engine(cfg, params, sc, device=cuda) for _ in range(2))
    rng = np.random.default_rng(3)
    req = Request(rid=0, prompt=rng.integers(0, cfg.vocab, 200,
                                             dtype=np.int32), max_new=4)
    assert pre.submit_prefill(req)
    for _ in range(20):
        if pre.handoff_ready():
            break
        pre.step()
    packet = pre.export_handoff(0)
    assert packet is not None and len(packet.blocks) == 13
    leaves = dec.runner.cache["units"]["b0"]
    ptrs = {k: v.data_ptr() for k, v in leaves.items()}
    before = {k: v.clone() for k, v in leaves.items()}
    assert dec.adopt_handoff(packet, pre.runner)
    dst = dec.pool.export_blocks(dec.sched.active[0].slot)
    torch.cuda.synchronize()
    assert {k: v.data_ptr() for k, v in leaves.items()} == ptrs
    src = pre.runner.cache["units"]["b0"]
    others = [b for b in range(dec.pool.n_blocks) if b not in dst]
    for name, leaf in leaves.items():
        assert torch.equal(leaf[:, dst], src[name][:, packet.blocks])
        assert torch.equal(leaf[:, others], before[name][:, others])
    pre.release_handoff(0)
    for _ in range(20):
        if req.done:
            break
        dec.step()
    assert len(req.tokens_out) == 4


@pytest.mark.cuda
def test_import_blocks_from_refuses_a_cross_device_pair(cuda):
    from repro_torch.configs.base import ServeConfig
    from repro_torch.serve.engine import Engine
    cfg, params = _nectar_params(cuda)
    sc = ServeConfig(paged=True, max_batch=2, max_seq=64, block_size=16)
    on_card = Engine(cfg, params, sc, device=cuda)
    on_cpu = Engine(cfg, params, sc, device="cpu")
    with pytest.raises(ValueError, match="one device"):
        on_card.runner.import_blocks_from(on_cpu.runner, [0], [0])


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 8])
def test_parallel_polling_of_async_replicas(cuda, K):
    """Two async replicas (graphs captured at build) polled from a thread
    pool: no capture error, and the tokens, decisions and graph-aware
    launch counts of serial polling; an engine built (its graphs
    captured) while another thread serves captures without raising."""
    import threading
    from repro_torch.configs.base import AsyncConfig, ServeConfig
    from repro_torch.kernels import ops
    from repro_torch.serve.router import build_fleet
    cfg, params = _nectar_params(cuda)
    sc = ServeConfig(paged=True, attn_backend="flash", max_batch=4,
                     max_seq=256, prefix_cache=True,
                     async_cfg=AsyncConfig(enabled=True, max_device_ticks=K))
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, int(n), dtype=np.int32)
               for n in rng.integers(8, 60, 8)]
    out = []
    for parallel in (False, True):
        router = build_fleet(cfg, params, sc, n_replicas=2,
                             policy="round_robin", parallel=parallel,
                             device=cuda)
        for key in ops.LAUNCHES:
            ops.LAUNCHES[key] = 0
        rids = [router.submit(p, max_new=24) for p in prompts]
        router.drain_all()
        torch.cuda.synchronize()
        out.append(([list(router.result(r).tokens_out) for r in rids],
                    [(d.rid, d.replica, d.reason) for d in router.decisions],
                    dict(ops.LAUNCHES)))
    assert out[1] == out[0]
    # a capture on the main thread while a worker thread serves
    from repro_torch.serve.engine import Engine
    errors = []

    def serve():
        try:
            for p in prompts[:4]:
                router.submit(p, max_new=16)
            router.drain_all()
        except Exception as exc:          # reported below
            errors.append(exc)
    worker = threading.Thread(target=serve)
    worker.start()
    spare = Engine(cfg, params, sc, device=cuda)
    worker.join(timeout=300)
    assert not worker.is_alive() and not errors
    assert spare.runner.graph_captures == 2


# ---------------------------------------------------------------------------
# the model families' slice: kernel 1 at the new head groupings, the C4
# dispatcher on the card, an MoE stack's async ticks

FAMILY_TOL = dict(atol=1e-6, rtol=1e-5)   # chip_smoke.py phase 19 (b):
#                        against the plain version evaluated in f64 (both
#                        f32 versions round by ~1e-6 at Dh 128)


def _paged_attention_f64(q, k_pool, v_pool, tables, lens):
    """``ref.paged_attention_plain``'s function in float64."""
    kg = ref._gather_clamped(k_pool.double(), tables)
    vg = ref._gather_clamped(v_pool.double(), tables)
    B, S, Hq, Dh = q.shape
    Kv, Skv = kg.shape[2], kg.shape[1]
    qg = q.double().reshape(B, S, Kv, Hq // Kv, Dh) * Dh ** -0.5
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, kg)
    gpos = lens[:, None].long() + torch.arange(S, device=q.device)[None, :]
    vis = torch.arange(Skv, device=q.device)[None, None, :] \
        <= gpos[:, :, None]
    s = s.masked_fill(~vis[:, None, None], ref.NEG_INF)
    o = torch.einsum("bkgqs,bskd->bqkgd", torch.softmax(s, dim=-1), vg)
    return o.reshape(B, S, Hq, Dh).float()


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 4])
@pytest.mark.parametrize("Hq,Kv", [(32, 8), (16, 2), (40, 8), (16, 16)],
                         ids=["qwen3-G4", "qwen2.5-G8", "maverick-G5",
                              "moonshot-G1"])
def test_paged_attention_at_the_new_head_groupings(cuda, Hq, Kv, S):
    """Kernel 1 at Dh 128 with f32 pools at the head groupings of
    qwen3-4b, qwen2.5-3b, llama4-maverick and moonshot, decode (S = 1)
    and verify (S = 4) rows: within FAMILY_TOL of its plain version
    evaluated in f64 and within TOL of the f32 plain version (the two f32
    versions part by up to 1.5e-6 at G 5), the same bits when launched
    again."""
    rng = np.random.default_rng(Hq * 10 + Kv + S)
    B, bs, MB, Dh = 4, 16, 32, 128
    nb = B * MB
    lens = rng.integers(1, 145, B).astype(np.int32)
    tables = np.full((B, MB), nb, np.int32)
    free = list(rng.permutation(nb))
    for b in range(B - 1):                 # the last row stays IDLE
        n = -(-(int(lens[b]) + S) // bs)
        tables[b, :n] = [free.pop() for _ in range(n)]
    q = torch.tensor(rng.standard_normal((B, S, Hq, Dh)), dtype=torch.float32,
                     device=cuda)
    kp, vp = (torch.tensor(rng.standard_normal((nb, bs, Kv, Dh)),
                           dtype=torch.float32, device=cuda) for _ in range(2))
    t, ln = (torch.tensor(a, device=cuda) for a in (tables, lens))
    got = decode_attn.paged_attention(q, kp, vp, t, ln)
    again = decode_attn.paged_attention(q, kp, vp, t, ln)
    want = ref.paged_attention_plain(q, kp, vp, t, ln)
    exact = _paged_attention_f64(q, kp, vp, t, ln)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    np.testing.assert_allclose(got.cpu().numpy(), exact.cpu().numpy(),
                               **FAMILY_TOL)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)


@pytest.mark.cuda
def test_dispatcher_binds_the_regimes_to_the_kernels(cuda):
    """A Dispatcher judged at the H100 SXM sends nectar's decode sites to
    kernel 4 (int8 weights from core.quant; exact against its plain
    version) and kernel 2 (TOL), and a prefill-sized site to
    torch.matmul (TOL against the f64 product); each regime's kernel
    launches once a dispatched call."""
    from repro_torch.configs import get_config
    from repro_torch.core import heterogeneous, quant, sparsity
    from repro_torch.kernels import ops
    from repro_torch.roofline import hw
    cfg = get_config("nectar-relu-llama-1.7m")
    disp = heterogeneous.Dispatcher(
        {"gemv_stream": lambda x, w: ops.nmce_matmul(
            x, quant.quantize_int8(w, axis=1)),
         "sparse_gather": ops.sparse_gather_matvec,
         "gemm_mxu": torch.matmul}, chip=hw.H100_SXM)
    rng = np.random.default_rng(19)
    sites = dict(heterogeneous.decode_sites(cfg.d_model, cfg.d_ff,
                                            cfg.vocab, 8))
    sites["prefill"] = heterogeneous.MatmulSite(rows=2048, k=512, n=8192)
    seen = set()
    for name, site in sites.items():
        w = torch.tensor(rng.standard_normal((site.k, site.n))
                         * site.k ** -0.5, dtype=torch.float32, device=cuda)
        x = torch.tensor(rng.standard_normal((site.rows, site.k)),
                         dtype=torch.float32, device=cuda)
        before = dict(ops.LAUNCHES)
        if site.sparsity:
            h = torch.relu(x)
            idx, valid = sparsity.topk_indices(h, site.k // 10)
            hk = torch.where(valid, torch.gather(h, -1, idx.long()), 0.0)
            idx = torch.where(valid, idx, site.k)
            got, regime = disp(site, hk, idx, w)
            want = ref.sparse_gather_matvec_plain(hk, idx, w)
            kernel = "sparse_gather_matvec"
        else:
            got, regime = disp(site, x, w)
            if regime == "gemv_stream":
                w_q, x_q = (quant.quantize_int8(w, axis=1),
                            quant.quantize_int8(x, axis=0))
                want = ref.nmce_matmul_plain(
                    x_q.q, w_q.q, x_q.scale.reshape(-1, 1),
                    w_q.scale.reshape(1, -1))
                kernel = "nmce_matmul"
            else:
                want = (x.double() @ w.double()).float()
                kernel = None
        torch.cuda.synchronize()
        seen.add(regime)
        if kernel == "nmce_matmul":
            assert torch.equal(got, want), name
        else:
            np.testing.assert_allclose(got.cpu().numpy(),
                                       want.cpu().numpy(), **TOL)
        for key in ops.LAUNCHES:
            assert ops.LAUNCHES[key] - before[key] == (key == kernel), \
                (name, key)
    assert seen == {"gemv_stream", "sparse_gather", "gemm_mxu"}


@pytest.mark.cuda
def test_moe_async_ticks_make_no_host_sync(cuda):
    """moonshot-v1-smoke through the async engine at K = 8 on the card:
    its decode bursts (an MoE stack's iteration captured as a graph) run
    under set_sync_debug_mode("error") and give the synchronous engine's
    tokens."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import AsyncConfig, ServeConfig
    from repro_torch.models import Model
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.scheduler import Request
    cfg = get_config("moonshot-v1-smoke")
    params = Model(cfg).init(torch.Generator(device=cuda).manual_seed(0),
                             device=cuda)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab, int(m), dtype=np.int32)
               for m in rng.integers(5, 30, 5)]
    out = {}
    for K in (None, 8):
        sc = ServeConfig(paged=True, attn_backend="flash", max_batch=8,
                         async_cfg=None if K is None else AsyncConfig(
                             enabled=True, max_device_ticks=K))
        eng = Engine(cfg, params, sc, device=cuda)
        reqs = [Request(rid=eng.new_rid(), prompt=p, max_new=12)
                for p in prompts]
        for r in reqs:
            assert eng.add_request(r)
        eng.step()
        if K:
            torch.cuda.set_sync_debug_mode("error")
        try:
            while eng._busy():
                eng.step()
            eng.step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        out[K] = [list(r.tokens_out) for r in reqs]
        if K:
            assert eng.async_stats()["loop_bursts"] > 0
            assert eng.runner.graph_replays > 0
    assert out[None] == out[8]


@pytest.mark.cuda
def test_mrope_model_decode_iteration_captures(cuda):
    """An M-RoPE model (qwen2-vl-smoke) passes the async gate: its decode
    iteration, M-RoPE tables included, is captured as a CUDA graph when
    the engine is built (no host copy inside), and the async K = 4 serve
    gives the sync serve's tokens."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import AsyncConfig, ServeConfig
    from repro_torch.models import Model
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.scheduler import Request
    cfg = get_config("qwen2-vl-smoke")
    params = Model(cfg).init(torch.Generator(device=cuda).manual_seed(0),
                             device=cuda)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab, int(m), dtype=np.int32)
               for m in rng.integers(5, 30, 4)]
    out = []
    for acfg in (None, AsyncConfig(enabled=True, max_device_ticks=4)):
        eng = Engine(cfg, params, ServeConfig(
            paged=True, attn_backend="flash", max_batch=4, async_cfg=acfg),
            device=cuda)
        done = eng.run([Request(rid=i, prompt=p, max_new=12)
                        for i, p in enumerate(prompts)])
        out.append({i: list(r.tokens_out) for i, r in done.items()})
    assert eng.runner.graph_captures == 2
    assert eng.async_stats()["loop_bursts"] > 0
    assert out[0] == out[1]


def _rel(want, got):
    return float(torch.linalg.norm((got - want).double())
                 / torch.linalg.norm(want.double()))


@pytest.mark.cuda
def test_relu_ffn_function_at_the_training_shape(cuda):
    """Kernel 3 with a gradient at nectar's training rows (B 8 x S 64):
    one launch a forward and none in the backward; the output within
    1.5e-5 of the plain version, dx, dW_up and dW_down within 1e-4
    relative of autograd through the plain version."""
    rng = np.random.default_rng(21)
    M, d, f = 512, 128, 640
    arrays = [rng.standard_normal((M, d)), rng.standard_normal((d, f))
              * d ** -0.5, rng.standard_normal((f, d)) * f ** -0.5]
    mine = [torch.tensor(a, dtype=torch.float32, device=cuda,
                         requires_grad=True) for a in arrays]
    plain = [torch.tensor(a, dtype=torch.float32, device=cuda,
                          requires_grad=True) for a in arrays]
    dy = torch.tensor(rng.standard_normal((M, d)), dtype=torch.float32,
                      device=cuda)
    n0 = ops.LAUNCHES["relu_ffn"]
    out = ops.relu_ffn_fused(*mine)
    assert ops.LAUNCHES["relu_ffn"] == n0 + 1
    assert type(out.grad_fn).__name__ == "ReluFFNBackward"
    got = torch.autograd.grad(out, mine, dy)
    assert ops.LAUNCHES["relu_ffn"] == n0 + 1
    want_out = ref.relu_ffn_plain(*plain)
    want = torch.autograd.grad(want_out, plain, dy)
    torch.cuda.synchronize()
    assert float((out - want_out).detach().abs().max()) <= 1.5e-5
    for w, g in zip(want, got):
        assert _rel(w, g) <= 1e-4


@pytest.mark.cuda
def test_nectar_trains_on_the_card_as_on_the_cpu(cuda):
    """3 steps of nectar-relu-llama-1.7m (B 8, S 64, lr 3e-3, warm-up 5)
    from the same params on the card and on the CPU: kernel 3 launches 6
    times a step, and ``ce`` agrees within 1e-3 at every step."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.models import Model
    from repro_torch.train import data
    from repro_torch.train.loop import run_training
    cfg = get_config("nectar-relu-llama-1.7m")
    params = Model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    tcfg = TrainConfig(lr=3e-3, warmup_steps=5, total_steps=60, seed=0)
    src = data.TinyStoriesSynth(data.DataConfig(seq_len=64, batch_size=8,
                                                vocab_size=cfg.vocab))
    n0 = ops.LAUNCHES["relu_ffn"]
    _, _, card = run_training(Model(cfg), cfg, tcfg, src, steps=3,
                              params=params, log_every=1, device=cuda)
    assert ops.LAUNCHES["relu_ffn"] - n0 == 3 * cfg.n_layers
    _, _, cpu = run_training(Model(cfg), cfg, tcfg, src, steps=3,
                             params=params, log_every=1, device="cpu")
    for (s, a), (t, b) in zip(card["history"], cpu["history"]):
        assert s == t and abs(a["ce"] - b["ce"]) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
def test_sparse_gather_kernel_at_a_shards_block(cuda, n):
    """Kernel 2 on a model-n shard's contiguous [640, 128 / n] column
    block of nectar's W_down (the sharded serve's call) against its plain
    version, and the blocks' outputs concatenated equal to the whole
    W_down's call."""
    rng = np.random.default_rng(n)
    B, k, d_ff, d = 8, 128, 640, 128
    idx = np.stack([rng.permutation(d_ff)[:k] for _ in range(B)])
    idx = np.where(rng.random((B, k)) < 0.1, d_ff, idx)
    h = torch.tensor(rng.standard_normal((B, k)), dtype=torch.float32,
                     device=cuda)
    w = torch.tensor(rng.standard_normal((d_ff, d)) * d_ff ** -0.5,
                     dtype=torch.float32, device=cuda)
    i = torch.tensor(idx, dtype=torch.int32, device=cuda)
    c = d // n
    parts = [w[:, j * c:(j + 1) * c].contiguous() for j in range(n)]
    got = [sparse_ffn.sparse_gather_matvec(h, i, p) for p in parts]
    want = [ref.sparse_gather_matvec_plain(h, i, p) for p in parts]
    whole = sparse_ffn.sparse_gather_matvec(h, i, w)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), **TOL)
    np.testing.assert_allclose(torch.cat(got, dim=1).cpu().numpy(),
                               whole.cpu().numpy(), **TOL)


@pytest.mark.cuda
def test_model_2_mesh_serves_the_unsharded_tokens(cuda):
    """nectar (seeded weights) through the paged engine's naive read,
    unsharded and on a mesh of two shards on the card: the same greedy
    tokens, and kernel 2 twice as many launches."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import MeshConfig, ServeConfig
    from repro_torch.models import Model
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.scheduler import Request
    cfg = get_config("nectar-relu-llama-1.7m")
    params = Model(cfg).init(torch.Generator(device=cuda).manual_seed(0),
                             device=cuda)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, int(n), dtype=np.int32)
               for n in (5, 23, 9, 14)]
    out, launches = [], []
    for mesh, device in ((None, cuda), (MeshConfig(model=2), [cuda] * 2)):
        eng = Engine(cfg, params, ServeConfig(
            paged=True, attn_backend="naive", max_batch=3, max_seq=64,
            block_size=8, prefill_chunk=16, mesh=mesh), device=device)
        n0 = ops.LAUNCHES["sparse_gather_matvec"]
        done = eng.run([Request(rid=i, prompt=p, max_new=8)
                        for i, p in enumerate(prompts)], max_steps=500)
        torch.cuda.synchronize()
        launches.append(ops.LAUNCHES["sparse_gather_matvec"] - n0)
        out.append({i: [int(t) for t in r.tokens_out]
                    for i, r in done.items()})
    assert out[0] == out[1]
    assert launches[1] == 2 * launches[0] > 0
