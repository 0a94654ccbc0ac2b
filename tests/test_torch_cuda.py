"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; without a CUDA device every test skips. On a machine with
the card and without JAX, run them with
``PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py``.
Tolerance atol=rtol=1e-5: kernel and plain version sum the same f32
terms in another order.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attn, ref, sparse_ffn

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
