"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; without a CUDA device every test skips. On a machine with
the card and without JAX, run them with
``PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py``.
Tolerance atol=rtol=1e-5: kernel and plain version sum the same f32
terms in another order (bf16 K/V too: both widen the same bf16 values
exactly to f32; 1e-4 for the fused FFN's two chained products, which its
kernel runs as 3xTF32 on the tensor cores: ~2e-5 at d 2048). The W8A8
matmul is exact: its kernel must equal its plain version bit for bit.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import quant
from repro_torch.kernels import (decode_attn, nmce_matvec, ref, relu_ffn,
                                 sparse_ffn)

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("S,Hq,Kv,Dh,bs", [(1, 4, 4, 32, 16),
                                           (5, 32, 8, 64, 16),
                                           (32, 8, 2, 128, 8)])
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
    np.testing.assert_allclose(got[:B - 1].cpu().numpy(),
                               want[:B - 1].cpu().numpy(), **TOL)
    assert torch.equal(got[B - 1], torch.zeros_like(got[B - 1]))


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


def _paged_edge_inputs(rng, cuda, S, Hq, Kv, Dh, bs, MB, lens):
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
                           dtype=torch.float32, device=cuda) for _ in range(2))
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
    over warps and CTAs, an IDLE row (exact zeros); S*G from 1 to 128
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
    np.testing.assert_allclose(got[:-1].cpu().numpy(),
                               want[:-1].cpu().numpy(), **TOL)
    assert torch.equal(got[-1], torch.zeros_like(got[-1]))
    assert torch.equal(got, again)


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
    (8, 2, 128, 77, torch.float32)])
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
@pytest.mark.parametrize("Dh", [32, 64, 128])
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
