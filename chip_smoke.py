#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU and
check it end to end. Run from the repository root:

    python3 chip_smoke.py

Phases, each reporting on lines of its own:
  1. device  — a CUDA device must be present; prints the card's name and
               power limit as nvidia-smi gives them; TF32 stays off.
  2. build   — nvcc builds all five CUDA kernels from src/repro_torch/csrc.
  3. kernels — each kernel against its plain PyTorch version on the card,
               at nectar-relu-llama-1.7m's shapes and at llama3.2-1b's
               widths (W8A8 also at Llama-3-8B's up projection; sentinel
               table entries and indices, an idle slot past the cache,
               dead d_ff blocks, int16 saturation); times
               of kernel, plain version and a library yardstick, the
               kernel's and the yardstick's device time per call from
               torch.profiler; then every kernel at the edges of its split
               design (one-block rows, rows ending on a block boundary,
               uneven splits, IDLE and all-empty rows, block sizes
               8/16/32, S*G 1-128, k not a multiple of the split; kv_len
               0/1/31-33/S-1/S/S+5 and contexts either side of a split
               round, G 1/4/8, Dh 32/64/128, f32 and bf16; M 1-200, d_ff
               tails, unaligned rows, all-dead and all-live blocks; W8A8
               M 1-65, K off the 64-wide chunk and on the split's chunk
               boundaries, N on the TMA and the cp.async paths, both
               modes). Every edge case is launched twice on the same
               inputs and must give the same bits.
  4. ops     — the public W8A8 entry point ``ops.nmce_matmul`` on card
               tensors launches its kernel and equals its CPU result bit
               for bit.
  5. serve   — the paged engine serves 16 requests of nectar-relu-llama-
               1.7m (random weights from a seeded generator) through
               StreamingServer; paged attention and the sparse gather
               launch once per layer per step.
  6. cpu     — the same prompts and weights through Engine(device="cpu")
               (plain versions); greedy tokens must agree, except at a
               near-tie whose CPU top-2 logit margin is <= NEAR_TIE.
  7. slot    — the slot engine (ServeConfig(paged=False), the default)
               serves the same 16 prompts on the card: decode attention and
               the sparse gather launch once per layer per decode step, the
               fused ReLU-FFN once per layer per prefill, paged attention
               never.
  8. slot-cpu — the slot engine on the CPU; the same near-tie rule.
  9. profile — both engines serve the same prompts again under
               torch.profiler: each kernel's device time per launch at the
               shapes the serve gives it, the profiler's launch counts
               against the counters, the serve's device time over the
               unprofiled serve's wall, and the same tokens as before.
It exits non-zero, printing no result, when there is no CUDA device or a
check fails. Its last line is the result JSON; the line before it holds
the per-kernel JSON. Details go to build/chip_smoke.json.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 0
KERNEL_ATOL = 1e-4   # kernel vs plain version: the same f32 terms (bf16
#                      K/V widened exactly) summed in another order;
#                      errors seen are ~1e-6, and up to ~2e-5 for the
#                      fused FFN's 3xTF32 products at d 2048
LOGIT_ATOL = 1e-3    # card vs CPU logits of one whole forward step
NEAR_TIE = 1e-3      # a token flip with a CPU top-2 margin at most this
#                      is a summation-order near-tie, not a fault
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
F32_FLOPS_PER_S = 67e12       # H100 SXM f32 rate outside the tensor cores
TF32_FLOPS_PER_S = 495e12     # H100 SXM dense TF32 tensor-core rate
INT8_OPS_PER_S = 1979e12      # H100 SXM dense int8 tensor-core rate
PROFILE_ITERS = 20
PROFILE_TRIES = 3             # runs of a profiled window that saw no device
#                               activity at all (see ``profiled``)
TOP_DEVICE = 6                # device-time leaders listed per profiled serve

# kernel -> the names of its CUDA kernels (as the profiler reports them;
# the first names the one launched once per wrapper call, a substring of
# each of its variants), its source and the TPU kernel it replaces
KERNELS = {
    "paged_attention": (("paged_attention_kernel",
                         "paged_attention_combine"),
                        "src/repro_torch/csrc/paged_attention.cu",
                        "src/repro/kernels/decode_attn.py:75"),
    "sparse_gather_matvec": (("sparse_gather_kernel",
                              "sparse_gather_combine"),
                             "src/repro_torch/csrc/sparse_gather.cu",
                             "src/repro/kernels/sparse_ffn.py:31"),
    "relu_ffn": (("relu_ffn_kernel", "relu_ffn_combine"),
                 "src/repro_torch/csrc/relu_ffn.cu",
                 "src/repro/kernels/relu_ffn.py:31"),
    "nmce_matmul": (("nmce_matmul_kernel", "nmce_matmul_combine"),
                    "src/repro_torch/csrc/nmce_matmul.cu",
                    "src/repro/kernels/nmce_matvec.py:40"),
    "decode_attention": (("decode_attention_kernel",
                          "decode_attention_combine"),
                         "src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attn.py:28"),
}


class Failure(Exception):
    pass


def check(ok, msg):
    if not ok:
        raise Failure(msg)


def time_ms(fn, iters=100, warmup=5):
    """Mean time of one call, from CUDA events around ``iters``
    back-to-back calls after a warm-up. At small widths this is how fast
    the host issues the calls, not the device time."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def profiled(fn):
    """Run ``fn`` under torch.profiler (CPU and CUDA activity); returns
    (its result, the profiler's per-name averages). On some machines the
    profiler now and then returns a window with no device activity at all
    although kernels ran in it: such a window runs again, up to
    PROFILE_TRIES times in all. A window that shows device activity but
    none for a given kernel still fails the run (``kernel_device``)."""
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(PROFILE_TRIES):
        if attempt:
            print("profiler: a window showed no device activity; running "
                  "it again")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        averages = prof.key_averages()
        if any(e.self_device_time_total > 0
               for e in device_events(averages)):
            break
    return out, averages


def kernel_device(averages, kernel):
    """(device µs, launches) the profiler attributes to ``kernel``: the
    CUDA time of all its CUDA kernels, and how often the first of them ran
    (one per wrapper launch). A kernel the profiler does not see fails the
    run: no other clock stands in for the device time."""
    names = KERNELS[kernel][0]
    us = sum(e.device_time_total for e in averages
             if any(n in e.key for n in names))
    count = sum(e.count for e in averages if names[0] in e.key)
    check(us > 0 and count > 0,
          f"{kernel}: torch.profiler attributes no device time to {names} "
          f"({len(device_events(averages))} device events in the window)")
    return us, count


def device_events(averages):
    """The profiler's CUDA events (kernels and copies), most device time
    first."""
    from torch.autograd import DeviceType
    return sorted((e for e in averages if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)),
                  key=lambda e: -e.self_device_time_total)


def window_averages(fn):
    """torch.profiler's per-name averages over PROFILE_ITERS calls of
    ``fn``, after one call outside the window."""
    fn()
    torch.cuda.synchronize()
    return profiled(lambda: [fn() for _ in range(PROFILE_ITERS)])[1]


def device_ms(fn, kernel):
    """The kernel's own device time per call, and the part of it its
    combine pass takes (0 where it has none or did not split): the CUDA
    time torch.profiler attributes to its kernels over PROFILE_ITERS
    calls, averaged."""
    averages = window_averages(fn)
    combine = sum(e.device_time_total for e in averages
                  if any(n in e.key for n in KERNELS[kernel][0][1:]))
    return (kernel_device(averages, kernel)[0] / PROFILE_ITERS / 1e3,
            combine / PROFILE_ITERS / 1e3)


def library_device_ms(fn):
    """A library call's device time per call: all the CUDA time
    torch.profiler sees in the window of PROFILE_ITERS calls, averaged."""
    total = sum(e.self_device_time_total
                for e in device_events(window_averages(fn)))
    check(total > 0, "torch.profiler saw no device time in a library call")
    return total / PROFILE_ITERS / 1e3


def bound(n_bytes, ops, ops_per_s=F32_FLOPS_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def measure(kernel, label, err, kernel_fn, plain_fn, library_fn, n_bytes,
            ops, ops_per_s=F32_FLOPS_PER_S):
    """One phase-3 row: the times of kernel, plain version and library
    yardstick (None where there is none), the device times of kernel and
    yardstick, and the bound."""
    bound_ms, bound_by = bound(n_bytes, ops, ops_per_s)
    dev_ms, combine_ms = device_ms(kernel_fn, kernel)
    return {"case": label, "max_abs_err": err, "ms": time_ms(kernel_fn),
            "device_ms": dev_ms, "combine_device_ms": combine_ms,
            "plain_ms": time_ms(plain_fn),
            "library_ms": None if library_fn is None else time_ms(library_fn),
            "library_device_ms": None if library_fn is None
            else library_device_ms(library_fn),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": n_bytes, "ops": ops}


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions


def held(label, kernel_fn, plain_fn, zero_rows=()):
    """Launch ``kernel_fn`` twice and hold it against ``plain_fn``: within
    KERNEL_ATOL, the same bits both times, exact zeros in ``zero_rows``.
    Returns the max abs error."""
    got, again, want = kernel_fn(), kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    check(torch.isfinite(got).all().item(), f"{label}: non-finite output")
    err = (got - want).abs().max().item()
    check(err <= KERNEL_ATOL, f"{label}: max_abs_err {err}")
    check(torch.equal(got, again), f"{label}: not deterministic")
    for r in zero_rows:
        check(torch.equal(got[r], torch.zeros_like(got[r])),
              f"{label}: row {r} must be exact zeros")
    return err


def attention_case(dev, rng, B, S, Hq, Kv, Dh, bs, MB, max_ctx):
    """Inputs for kernel 1: every row's blocks cover its causal limit,
    the rest of the table is sentinel; the last row is IDLE (all
    sentinel)."""
    n_blocks = B * MB
    lens = rng.integers(1, max_ctx - S + 1, B).astype(np.int32)
    tables = np.full((B, MB), n_blocks, np.int32)
    free = list(rng.permutation(n_blocks))
    for b in range(B - 1):
        n = -(-(int(lens[b]) + S) // bs)
        tables[b, :n] = [free.pop() for _ in range(n)]
    t = lambda a: torch.tensor(a, device=dev)  # noqa: E731
    f32 = lambda shape: torch.tensor(  # noqa: E731
        rng.standard_normal(shape), dtype=torch.float32, device=dev)
    return (f32((B, S, Hq, Dh)), f32((n_blocks, bs, Kv, Dh)),
            f32((n_blocks, bs, Kv, Dh)), t(tables), t(lens))


def attention_work(q, k_pool, tables, lens):
    """(bytes, flops) this input needs: q and the output once, the
    tables and lens, the K and V blocks each row's queries can see."""
    B, S, Hq, Dh = q.shape
    n_blocks, bs, Kv, _ = k_pool.shape
    tb, ln = tables.cpu().numpy(), lens.cpu().numpy()
    blocks = set()
    flops = 0
    for b in range(B):
        n = min(tb.shape[1], (int(ln[b]) + S - 1) // bs + 1)
        live = [int(x) for x in tb[b, :n] if 0 <= x < n_blocks]
        blocks.update(live)
        if live:
            vis = sum(int(ln[b]) + j + 1 for j in range(S))
            flops += 4 * Dh * Hq * vis
    n_bytes = (2 * q.numel() + tables.numel() + lens.numel()) * 4 \
        + len(blocks) * bs * Kv * Dh * 4 * 2
    return n_bytes, flops


def run_attention(dev, rng, label, **shape):
    from repro_torch.kernels import decode_attn, ref
    import torch.nn.functional as F
    q, kp, vp, tables, lens = attention_case(dev, rng, **shape)
    err = held(f"{label}: paged_attention",
               lambda: decode_attn.paged_attention(q, kp, vp, tables, lens),
               lambda: ref.paged_attention_plain(q, kp, vp, tables, lens),
               zero_rows=(q.shape[0] - 1,))
    # the library yardstick: SDPA over the gathered, masked sequence
    kg = ref._gather_paged(kp, tables).transpose(1, 2)
    vg = ref._gather_paged(vp, tables).transpose(1, 2)
    S, Skv = q.shape[1], kg.shape[2]
    vis = (torch.arange(Skv, device=dev)[None, None, :]
           <= (lens[:, None].long()
               + torch.arange(S, device=dev)[None, :])[:, :, None])
    qt, mask = q.transpose(1, 2), vis[:, None]
    return measure(
        "paged_attention", label, err,
        lambda: decode_attn.paged_attention(q, kp, vp, tables, lens),
        lambda: ref.paged_attention_plain(q, kp, vp, tables, lens),
        lambda: F.scaled_dot_product_attention(qt, kg, vg, attn_mask=mask,
                                               enable_gqa=True),
        *attention_work(q, kp, tables, lens))


def run_sparse(dev, rng, label, B, k, d_ff, d, empty_frac):
    from repro_torch.kernels import ref, sparse_ffn
    import torch.nn.functional as F
    idx = np.stack([rng.permutation(d_ff)[:k] for _ in range(B)])
    idx = np.where(rng.random((B, k)) < empty_frac, d_ff, idx)
    h = torch.tensor(np.abs(rng.standard_normal((B, k))),
                     dtype=torch.float32, device=dev)
    w = torch.tensor(rng.standard_normal((d_ff, d)) * d_ff ** -0.5,
                     dtype=torch.float32, device=dev)
    i = torch.tensor(idx, dtype=torch.int32, device=dev)
    err = held(f"{label}: sparse_gather_matvec",
               lambda: sparse_ffn.sparse_gather_matvec(h, i, w),
               lambda: ref.sparse_gather_matvec_plain(h, i, w))
    wpad = torch.cat([w, w.new_zeros(1, d)])
    il = i.long()
    valid = idx < d_ff
    n_bytes = (h.numel() + i.numel() + B * d) * 4 \
        + len(np.unique(idx[valid])) * d * 4
    return measure(
        "sparse_gather_matvec", label, err,
        lambda: sparse_ffn.sparse_gather_matvec(h, i, w),
        lambda: ref.sparse_gather_matvec_plain(h, i, w),
        lambda: F.embedding_bag(il, wpad, per_sample_weights=h, mode="sum",
                                padding_idx=d_ff),
        n_bytes, 2 * d * int(valid.sum()))


def run_decode(dev, rng, label, B, S, Hq, Kv, Dh, kv_len, dtype):
    """Kernel 5 on a contiguous [B, S, Kv, Dh] cache; ``kv_len`` may pass
    S (an idle slot of the slot engine), which shows all S positions."""
    from repro_torch.kernels import decode_attn, ref
    import torch.nn.functional as F
    q = torch.tensor(rng.standard_normal((B, Hq, Dh)), dtype=torch.float32,
                     device=dev)
    k, v = (torch.tensor(rng.standard_normal((B, S, Kv, Dh)), dtype=dtype,
                         device=dev) for _ in range(2))
    ln = torch.tensor(np.asarray(kv_len, np.int32), device=dev)
    err = held(f"{label}: decode_attention",
               lambda: decode_attn.decode_attention(q, k, v, ln),
               lambda: ref.decode_attention_plain(q, k, v, ln))
    # the library yardstick: SDPA with a key mask, in the cache's dtype
    vis = torch.arange(S, device=dev)[None, :] < ln[:, None].long()
    qt = q.to(dtype)[:, :, None]
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    mask = vis[:, None, None]
    n = np.minimum(np.asarray(kv_len), S)
    n = np.where(np.asarray(kv_len) <= 0, S, n)
    n_bytes = 2 * q.numel() * 4 + ln.numel() * 4 \
        + int(n.sum()) * Kv * Dh * 2 * k.element_size()
    return measure(
        "decode_attention", label, err,
        lambda: decode_attn.decode_attention(q, k, v, ln),
        lambda: ref.decode_attention_plain(q, k, v, ln),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                               enable_gqa=True),
        n_bytes, 4 * Dh * Hq * int(n.sum()))


def ffn_case(dev, rng, M, d, f, dead_blocks):
    """Inputs for kernel 3; the W_up columns of ``dead_blocks`` (blocks of
    128) are zero, so their hidden values are 0 and their down MAC is
    skipped."""
    w_up = rng.standard_normal((d, f)) * d ** -0.5
    for blk in dead_blocks:
        w_up[:, blk * 128:(blk + 1) * 128] = 0.0
    return (torch.tensor(a, dtype=torch.float32, device=dev) for a in (
        rng.standard_normal((M, d)), w_up,
        rng.standard_normal((f, d)) * f ** -0.5))


def run_relu_ffn(dev, rng, label, M, d, f, dead_blocks):
    """Kernel 3 at one shape (see ``ffn_case``)."""
    from repro_torch.kernels import ref, relu_ffn
    x, wu, wd = ffn_case(dev, rng, M, d, f, dead_blocks)
    err = held(f"{label}: relu_ffn", lambda: relu_ffn.relu_ffn(x, wu, wd),
               lambda: ref.relu_ffn_plain(x, wu, wd))
    # what these inputs need: x, W_up and the output once, and the W_down
    # rows of the hidden units a live block holds (a d_ff block of the
    # kernel's 64 with every hidden value <= 0 needs no down MAC)
    live = (torch.relu(x @ wu) > 0).any(dim=0).cpu().numpy()
    n_live = sum(min(64, f - j) for j in range(0, f, 64)
                 if live[j:j + 64].any())
    n_bytes = (x.numel() + wu.numel() + n_live * d + M * d) * 4
    return measure(
        "relu_ffn", label, err,
        lambda: relu_ffn.relu_ffn(x, wu, wd),
        lambda: ref.relu_ffn_plain(x, wu, wd),
        lambda: torch.matmul(torch.relu(torch.matmul(x, wu)), wd),
        n_bytes, 2 * M * d * f + 2 * M * d * n_live,
        # 3xTF32: three tensor-core products for each f32-accurate one
        ops_per_s=TF32_FLOPS_PER_S / 3)


def run_nmce(dev, rng, label, M, K, N, sat):
    """Kernel 4: must equal its plain version bit for bit."""
    from repro_torch.core import quant
    from repro_torch.kernels import nmce_matvec, ref
    x = torch.tensor(rng.standard_normal((M, K)) * 4, device=dev)
    w = torch.tensor(rng.standard_normal((K, N)) * 4, device=dev)
    xq, wq = quant.quantize_int8(x, axis=0), quant.quantize_int8(w, axis=1)
    xs, ws = xq.scale.reshape(-1, 1), wq.scale.reshape(1, -1)
    got = nmce_matvec.nmce_matmul(xq.q, wq.q, xs, ws, saturate_int16=sat)
    want = ref.nmce_matmul_plain(xq.q, wq.q, xs, ws, saturate_int16=sat)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    check(err == 0 and torch.equal(got, want),
          f"{label}: nmce_matmul differs from its plain version "
          f"(max_abs_err {err})")
    library = None
    if M > 16 and K % 8 == 0 and N % 8 == 0:     # torch._int_mm's limits
        def library():
            return torch._int_mm(xq.q, wq.q)
        try:                        # a yardstick only: its absence is
            library()               # recorded, not a failure of the port
        except RuntimeError as exc:
            print(f"{label}: torch._int_mm refused these inputs: {exc}")
            library = None
    return measure(
        "nmce_matmul", label, err,
        lambda: nmce_matvec.nmce_matmul(xq.q, wq.q, xs, ws,
                                        saturate_int16=sat),
        lambda: ref.nmce_matmul_plain(xq.q, wq.q, xs, ws,
                                      saturate_int16=sat),
        library, M * K + K * N + 4 * (M + N) + 4 * M * N, 2 * M * K * N,
        INT8_OPS_PER_S)


def attention_edges(dev, rng):
    """Kernel 1 at the edges of its split design. Rows: one block (where
    S <= bs), ending exactly on a block boundary, a long context that
    splits unevenly over warps and CTAs, a short one, an IDLE row (all
    sentinel: exact zeros); block sizes 8/16/32, S*G from 1 to 128, every
    head dim, a narrow table (MB 4: no split). Returns the cases' count
    and their largest error."""
    from repro_torch.kernels import decode_attn, ref
    n, worst = 0, 0.0
    shapes = [(S, G, MB) for S, G in ((1, 1), (1, 4), (3, 4), (4, 4),
                                      (5, 4), (9, 4), (32, 1), (32, 4))
              for MB in (96,)] + [(1, 1, 4), (4, 4, 4)]
    for bs in (8, 16, 32):
        for i, (S, G, MB) in enumerate(shapes):
            Dh, Kv = (32, 64, 128)[(i + bs) % 3], 2
            cap = MB * bs - S
            lens = [max(0, min(cap, x)) for x in (
                bs - S, 3 * bs - S, cap - 11, 37 * bs + 5, 0)]
            B = len(lens)
            n_blocks = B * MB
            tables = np.full((B, MB), n_blocks, np.int32)
            free = list(rng.permutation(n_blocks))
            for b in range(B - 1):                 # the last row is IDLE
                m = -(-(lens[b] + S) // bs)
                tables[b, :m] = [free.pop() for _ in range(m)]
            q = torch.tensor(rng.standard_normal((B, S, Kv * G, Dh)),
                             dtype=torch.float32, device=dev)
            kp, vp = (torch.tensor(rng.standard_normal((n_blocks, bs, Kv,
                                                        Dh)),
                                   dtype=torch.float32, device=dev)
                      for _ in range(2))
            t = torch.tensor(tables, device=dev)
            ln = torch.tensor(np.asarray(lens, np.int32), device=dev)
            worst = max(worst, held(
                f"edges paged_attention bs={bs} S={S} G={G} Dh={Dh} "
                f"MB={MB}",
                lambda: decode_attn.paged_attention(q, kp, vp, t, ln),
                lambda: ref.paged_attention_plain(q, kp, vp, t, ln),
                zero_rows=(B - 1,)))
            n += 1
    return n, worst


def gather_edges(dev, rng):
    """Kernel 2 at the edges of its split design: k not a multiple of the
    split (or of the 8 warps), a ragged column tile, tiny and wide k, many
    rows; the last row of each case is all empty (exact zeros). Returns
    the cases' count and their largest error."""
    from repro_torch.kernels import ref, sparse_ffn
    worst = 0.0
    cases = ((3, 1001, 8192, 2048), (4, 130, 640, 128), (2, 7, 50, 96),
             (300, 128, 640, 128), (1, 4097, 9000, 68), (5, 129, 700, 36))
    for B, k, d_ff, d in cases:
        idx = np.stack([rng.permutation(d_ff)[:k] for _ in range(B)])
        idx = np.where(rng.random((B, k)) < 0.2, d_ff, idx)
        idx[B - 1] = d_ff
        h = torch.tensor(rng.standard_normal((B, k)), dtype=torch.float32,
                         device=dev)
        w = torch.tensor(rng.standard_normal((d_ff, d)) * d_ff ** -0.5,
                         dtype=torch.float32, device=dev)
        i = torch.tensor(idx, dtype=torch.int32, device=dev)
        worst = max(worst, held(
            f"edges sparse_gather_matvec B={B} k={k} d={d}",
            lambda: sparse_ffn.sparse_gather_matvec(h, i, w),
            lambda: ref.sparse_gather_matvec_plain(h, i, w),
            zero_rows=(B - 1,)))
    return len(cases), worst


def decode_edges(dev, rng):
    """Kernel 5 at the edges of its split design, for G in {1, 4, 8}, Dh
    in {32, 64, 128}, f32 and bf16 K/V, S = 333 (no multiple of a chunk):
    kv_len 0 (a mean over all S), 1, 31/32/33, S-1, S, S+5 (an idle slot)
    and contexts one key either side of the last chunk of a round over the
    splits and over the warps of ``decode_plan``. Returns the cases' count
    and their largest error."""
    from repro_torch.kernels import build, decode_attn, ref
    n, worst, S, Kv = 0, 0.0, 333, 2
    n_sm = build.sm_count(dev.index)
    for dtype in (torch.float32, torch.bfloat16):
        for G in (1, 4, 8):
            for Dh in (32, 64, 128):
                plan = decode_attn.decode_plan(12, S, Kv * G, Kv, Dh,
                                               dtype.itemsize, n_sm)
                kc, ns = plan["chunk"], plan["n_split"]
                lens = [0, 1, 31, 32, 33, S - 1, S, S + 5,
                        kc * ns - 1, kc * ns + 1, kc * ns * 4 + 1,
                        min(S, kc * ns * 4) - 1]
                B = len(lens)
                q = torch.tensor(rng.standard_normal((B, Kv * G, Dh)),
                                 dtype=torch.float32, device=dev)
                k, v = (torch.tensor(rng.standard_normal((B, S, Kv, Dh)),
                                     dtype=dtype, device=dev)
                        for _ in range(2))
                ln = torch.tensor(np.asarray(lens, np.int32), device=dev)
                worst = max(worst, held(
                    f"edges decode_attention {dtype} G={G} Dh={Dh} "
                    f"n_split={ns}",
                    lambda: decode_attn.decode_attention(q, k, v, ln),
                    lambda: ref.decode_attention_plain(q, k, v, ln)))
                n += 1
    return n, worst


def ffn_edges(dev, rng):
    """Kernel 3 at the edges of its design: M 1/16/64/65/200 (one row tile
    up to 64, then several), d_ff with a tail (200, 642), d = 96, rows that
    are not 16-byte aligned (d 30, 126), every block dead, every block
    live, llama3.2-1b widths at M 1 and 65. Returns the cases' count and
    their largest error."""
    from repro_torch.kernels import ref, relu_ffn
    everything = tuple(range(64))
    cases = ((1, 128, 640, ()), (16, 128, 200, (1,)), (64, 96, 640, (0, 3)),
             (65, 128, 640, everything), (200, 96, 200, ()),
             (200, 128, 640, everything), (16, 96, 640, ()),
             (65, 96, 200, (1,)), (5, 30, 70, ()), (16, 126, 200, (0,)),
             (8, 128, 642, ()), (1, 2048, 8192, ()),
             (65, 2048, 8192, (5,)))
    worst = 0.0
    for M, d, f, dead in cases:
        x, wu, wd = ffn_case(dev, rng, M, d, f, dead)
        worst = max(worst, held(
            f"edges relu_ffn M={M} d={d} f={f} dead={len(dead)}",
            lambda: relu_ffn.relu_ffn(x, wu, wd),
            lambda: ref.relu_ffn_plain(x, wu, wd)))
    return len(cases), worst


def nmce_edges(dev, rng):
    """Kernel 4 at the edges of its design, in both modes: M 1, 15, 16,
    17, 64, 65 (one to four mma row tiles, then two row tiles), K 4, 60,
    68, 2052 (not a multiple of the 64-wide chunk), N 4, 132 (N % 16 != 0:
    the cp.async path) and 48, 256 (TMA, a narrow and a full column tile),
    K at the chunk boundaries of ``nmce_plan``'s split (a split ending on
    a partial chunk, one chunk past a split, exact splits), and bases off
    a 16-byte boundary. Each case is launched twice and must equal its
    plain version bit for bit. Returns the cases' count and their largest
    error (0)."""
    from repro_torch.core import quant
    from repro_torch.kernels import build, nmce_matvec, ref
    cases = [(M, 2052, 132) for M in (1, 15, 16, 17, 64, 65)]
    cases += [(M, 2052, 256) for M in (1, 17, 65)]
    cases += [(8, K, N) for K in (4, 60, 68, 2052) for N in (4, 48, 132)]
    n_sm = build.sm_count(dev.index)
    for M, N in ((8, 8192), (32, 8192), (8, 4096)):
        for n_ch in (4, 22, 23, 64):
            cps = nmce_matvec.nmce_plan(M, 64 * n_ch, N, n_sm)["cps"]
            cases += [(M, K, N) for K in {64 * n_ch, 64 * n_ch - 4,
                                          64 * cps + 4}]
    # last: x and w_q at bases 4 bytes past a 16-byte boundary (4-byte
    # copies of x; w_q by cp.async although N % 16 == 0)
    cases += [(8, 2048, 256, "offset")]
    for M, K, N, *offset in cases:
        x = torch.tensor(rng.standard_normal((M, K)) * 4, device=dev)
        w = torch.tensor(rng.standard_normal((K, N)) * 4, device=dev)
        xq, wq = quant.quantize_int8(x, axis=0), quant.quantize_int8(w, axis=1)
        xs, ws = xq.scale.reshape(-1, 1), wq.scale.reshape(1, -1)
        xi, wi = xq.q, wq.q
        if offset:
            xi, wi = (torch.cat([a.new_zeros(4), a.reshape(-1)])[4:]
                      .view(a.shape) for a in (xi, wi))
            check(xi.data_ptr() % 16 == 4 and wi.data_ptr() % 16 == 4,
                  "edges nmce_matmul: the offset views are not offset")
        plan = nmce_matvec.nmce_plan(M, K, N, n_sm)
        for sat in (False, True):
            got, again = (nmce_matvec.nmce_matmul(xi, wi, xs, ws,
                                                  saturate_int16=sat)
                          for _ in range(2))
            want = ref.nmce_matmul_plain(xi, wi, xs, ws,
                                         saturate_int16=sat)
            torch.cuda.synchronize()
            check(torch.equal(got, want) and torch.equal(got, again),
                  f"edges nmce_matmul {M}x{K}x{N} sat={sat} (n_split "
                  f"{plan['n_split']}, tma {plan['tma']}): max_abs_err "
                  f"{(got - want).abs().max().item()}, relaunch equal "
                  f"{torch.equal(got, again)}")
    return 2 * len(cases), 0.0


def print_rows(kernel, rows):
    for r in rows:
        lib, lib_dev = ("none" if r[key] is None else f"{r[key]:.5f}"
                        for key in ("library_ms", "library_device_ms"))
        print(f"kernel {kernel} [{r['case']}]: max_abs_err="
              f"{r['max_abs_err']:.3g} ms={r['ms']:.5f} device_ms="
              f"{r['device_ms']:.5f} (combine {r['combine_device_ms']:.5f})"
              f" plain_ms="
              f"{r['plain_ms']:.5f} library_ms={lib} library_device_ms="
              f"{lib_dev} bound_ms="
              f"{r['bound_ms']:.6f} ({r['bound_by']})")


# ---------------------------------------------------------------------------
# phases 5-8: serving


def recording_engine(engine):
    """Record the logits behind every committed token and the top-2 logit
    margin there, {(rid, index): margin}. Paged mode samples every token
    from a batched step; slot mode samples a request's first token from its
    prefill logits and later ones from the decode step's."""
    ticks, prefills, margins = [], [], {}
    sample, append = engine._sample_rows, engine._append_token
    paged = engine.scfg.paged

    def recording_sample(last_logits):
        ticks.append(last_logits.float().cpu().numpy())
        return sample(last_logits)

    def recording_append(req, tok, lp):
        if paged:
            z = ticks[-1][engine.sched.active[req.rid].slot]
        elif not req.tokens_out:
            z = prefills[-1]
        else:
            z = ticks[-1][engine.alloc.active[req.rid]]
        z = np.sort(z)
        margins[(req.rid, len(req.tokens_out))] = float(z[-1] - z[-2])
        return append(req, tok, lp)

    if not paged:
        prefill = engine.model.prefill

        def recording_prefill(*args):
            logits, cache = prefill(*args)
            prefills.append(logits[0, 0].float().cpu().numpy())
            return logits, cache
        engine.model.prefill = recording_prefill
    engine._sample_rows = recording_sample
    engine._append_token = recording_append
    return ticks, prefills, margins


def serve(engine, prompts, max_new):
    """Submit every prompt through StreamingServer and drain it, with the
    launch counts set to 0 just before and read just after."""
    from repro_torch.kernels import ops
    from repro_torch.serve import api
    server = api.StreamingServer(engine)
    for key in ops.LAUNCHES:
        ops.LAUNCHES[key] = 0
    t0 = time.perf_counter()
    rids = [server.submit(p, max_new=max_new) for p in prompts]
    finished = server.drain()
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    tokens = [list(finished[rid].tokens_out) for rid in rids]
    return tokens, rids, wall, engine.metrics.summary(), launches


def profile_serve(label, engine, prompts, max_new, tokens, launches, wall):
    """Serve ``prompts`` once more, on a fresh ``engine``, under
    torch.profiler. It must give the first serve's tokens and launch
    counts, and the profiler must count the launches the counters do.
    Returns each launched kernel's device time per launch at the shapes
    the serve gives it, the serve's device time (every CUDA kernel and
    copy), its share of the first, unprofiled serve's ``wall`` and the
    TOP_DEVICE names that took most of it; for the slot engine also the
    range of kv_len its decode attention saw."""
    kv_lens = []
    if not engine.scfg.paged:
        decode_step = engine.model.decode_step

        def recording_step(params, tok, cache):
            kv_lens.append(cache["lens"].cpu().numpy() + 1)
            return decode_step(params, tok, cache)
        engine.model.decode_step = recording_step
    (again, _, pwall, _, plaunches), averages = profiled(
        lambda: serve(engine, prompts, max_new))
    check(again == tokens,
          f"{label}: the profiled serve's tokens differ from the first's")
    check(plaunches == launches, f"{label}: the profiled serve launched "
          f"{plaunches}, the first {launches}")
    per_launch = {}
    for key, n in launches.items():
        if n:
            us, count = kernel_device(averages, key)
            check(count == n, f"{label}: the profiler saw {key} run {count} "
                  f"times, its counter {n}")
            per_launch[key] = us / n / 1e3
    on_device = device_events(averages)
    device_total = sum(e.self_device_time_total for e in on_device) / 1e3
    check(device_total > 0, f"{label}: the profiler saw no device time")
    out = {"kernel_device_ms": per_launch, "device_ms": device_total,
           "busy_share": device_total / (wall * 1e3),
           "profiled_wall_s": pwall,
           "top_device": [[e.key[:60], e.count,
                           e.self_device_time_total / 1e3]
                          for e in on_device[:TOP_DEVICE]]}
    if kv_lens:
        out["kv_len_range"] = [int(min(x.min() for x in kv_lens)),
                               int(max(x.max() for x in kv_lens))]
    return out


def print_serve(label, n, summary, wall, steps, launches):
    print(f"{label}: {n} requests, {summary['generated_tokens']} tokens in "
          f"{wall:.3f} s ({summary['tokens_per_s']:.1f} tok/s), TTFT p50 "
          f"{summary['ttft_p50_ms']:.2f} ms p99 {summary['ttft_p99_ms']:.2f}"
          f" ms, TPOT p50 {summary['tpot_p50_ms']:.3f} ms p99 "
          f"{summary['tpot_p99_ms']:.3f} ms, {steps} steps, launches "
          f"{launches}")


def check_tokens(label, tokens, cfg, max_new, logits):
    check(all(len(t) == max_new and all(0 <= x < cfg.vocab for x in t)
              for t in tokens),
          f"{label}: every request must return max_new valid token ids")
    check(all(np.isfinite(z).all() for z in logits),
          f"{label}: non-finite logits")


def compare_cpu(label, gpu_tokens, cpu_tokens, margins, rids):
    """Card tokens vs CPU tokens per request; a difference is allowed only
    at a near-tie of the CPU run. Returns the flips."""
    flips = []
    for i, (a, b) in enumerate(zip(gpu_tokens, cpu_tokens)):
        if a == b:
            continue
        step = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
        margin = margins[(rids[i], step)]
        check(margin <= NEAR_TIE,
              f"{label}: request {i} diverges at token {step} with a CPU "
              f"top-2 margin {margin} > {NEAR_TIE}")
        flips.append({"request": i, "step": step, "margin": margin})
    return flips


def main():
    details = {}

    # ---- 1) device -------------------------------------------------------
    if not torch.cuda.is_available():
        raise Failure("no CUDA device: this script runs the port on a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "TF32 must stay off on the f32 path")
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    print(f"device: {name} x{torch.cuda.device_count()}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    details["device"] = {"nvidia_smi": smi, "name": name}

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ServeConfig
    from repro_torch.core import quant
    from repro_torch.kernels import build, ops
    from repro_torch.models import Model
    from repro_torch.serve.engine import Engine

    # ---- 2) build ----------------------------------------------------------
    t0 = time.perf_counter()
    log = build.build()
    secs = time.perf_counter() - t0
    print(f"build: {secs:.2f} s for {', '.join(build.SOURCES)}")
    print("\n".join(line for line in log.splitlines()
                    if "registers" in line or "Compiling entry" in line))
    details["build"] = {"seconds": secs, "log": log}

    # ---- 3) kernels vs plain versions --------------------------------------
    cfg = get_config("nectar-relu-llama-1.7m")
    scfg = ServeConfig(paged=True, attn_backend="flash", max_batch=8)
    slot_scfg = ServeConfig(paged=False, max_batch=8)
    rng = np.random.default_rng(SEED)
    # kernels 3-5 draw their cases from a stream of their own, so the
    # serve prompts drawn from ``rng`` do not depend on how many cases
    # phase 3 runs for them
    krng = np.random.default_rng(SEED + 1)
    nectar_attn = dict(B=scfg.max_batch, Hq=cfg.n_heads, Kv=cfg.n_kv_heads,
                       Dh=cfg.d_head, bs=scfg.block_size,
                       MB=scfg.blocks_per_seq, max_ctx=232)
    llama_attn = dict(B=8, Hq=32, Kv=8, Dh=64, bs=16, MB=128, max_ctx=2048)
    rows = {}
    rows["paged_attention"] = [
        run_attention(dev, rng, f"nectar S={S}", S=S, **nectar_attn)
        for S in (1, scfg.prefill_chunk)]
    rows["paged_attention"] += [
        run_attention(dev, rng, f"llama3.2-1b S={S}", S=S, **llama_attn)
        for S in (1, 5, 32)]
    k_nectar = 128          # active_fraction_to_k(640, 0.25)
    rows["sparse_gather_matvec"] = [
        run_sparse(dev, rng, f"nectar rows={B}", B=B, k=k_nectar,
                   d_ff=cfg.d_ff, d=cfg.d_model, empty_frac=0.1)
        for B in (scfg.max_batch, scfg.max_batch * scfg.prefill_chunk)]
    rows["sparse_gather_matvec"] += [
        run_sparse(dev, rng, "llama3.2-1b rows=8", B=8, k=1024, d_ff=8192,
                   d=2048, empty_frac=0.1)]
    S = slot_scfg.max_seq
    nectar_slot = dict(B=slot_scfg.max_batch, S=S, Hq=cfg.n_heads,
                       Kv=cfg.n_kv_heads, Dh=cfg.d_head)
    # the main case: kv_len over the range the slot serve's rows hold
    # (prompts of 8-200 tokens plus the decode steps; phase 9 prints the
    # range it saw); then a stress case whose last slot is idle past S
    serve_len = list(krng.integers(9, 264, slot_scfg.max_batch))
    idle_len = list(krng.integers(1, 233, slot_scfg.max_batch - 1)) \
        + [S + 5]
    llama_len = list(krng.integers(1, S + 1, 8))
    rows["decode_attention"] = [
        run_decode(dev, krng, "nectar slot serve kv_len f32",
                   kv_len=serve_len, dtype=torch.float32, **nectar_slot)]
    rows["decode_attention"] += [
        run_decode(dev, krng, f"nectar slot idle row past S {dt}",
                   kv_len=idle_len, dtype=dtype, **nectar_slot)
        for dt, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16))]
    rows["decode_attention"] += [
        run_decode(dev, krng, f"llama3.2-1b {dt}", B=8, S=S, Hq=32, Kv=8,
                   Dh=64, kv_len=llama_len, dtype=dtype)
        for dt, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16))]
    rows["relu_ffn"] = [
        run_relu_ffn(dev, krng, f"nectar prefill M={M}", M=M, d=cfg.d_model,
                     f=cfg.d_ff, dead_blocks=(1, 3))
        for M in (200, 8)]
    rows["relu_ffn"] += [run_relu_ffn(dev, krng, "llama3.2-1b M=32", M=32,
                                      d=2048, f=8192, dead_blocks=(5,))]
    nmce_sites = [("nectar up", 8, cfg.d_model, cfg.d_ff),
                  ("nectar down", 8, cfg.d_ff, cfg.d_model),
                  ("nectar logits", 8, cfg.d_model, cfg.vocab),
                  ("llama3.2-1b up", 8, 2048, 8192),
                  ("llama3.2-1b up M=32", 32, 2048, 8192),
                  # Meta's Llama-3-8B: hidden 4096, intermediate 14336;
                  # its 58.7 MB weight does not stay in the 50 MB L2
                  ("llama3-8b up", 8, 4096, 14336)]
    rows["nmce_matmul"] = [
        run_nmce(dev, krng, f"{site} {M}x{K}x{N} sat={sat}", M, K, N, sat)
        for site, M, K, N in nmce_sites for sat in (False, True)]
    for key, rs in rows.items():
        print_rows(key, rs)
    details["kernels"] = rows
    # the edges draw from a stream of their own too
    erng = np.random.default_rng(SEED + 2)
    edges = {"paged_attention": attention_edges(dev, erng),
             "sparse_gather_matvec": gather_edges(dev, erng),
             "decode_attention": decode_edges(dev, erng),
             "relu_ffn": ffn_edges(dev, erng),
             "nmce_matmul": nmce_edges(dev, erng)}
    print("edges: " + "; ".join(
        f"{key} {n} cases, max_abs_err {err:.3g}, each launched twice "
        f"with the same bits" for key, (n, err) in edges.items()))
    details["edges"] = edges

    # ---- 4) the public W8A8 entry point --------------------------------------
    w_np = krng.standard_normal((cfg.d_model, cfg.d_ff)).astype(np.float32)
    x_np = krng.standard_normal((8, cfg.d_model)).astype(np.float32)
    w_q = quant.quantize_int8(torch.tensor(w_np, device=dev), axis=1)
    w_q_cpu = quant.quantize_int8(torch.tensor(w_np), axis=1)
    for key in ops.LAUNCHES:
        ops.LAUNCHES[key] = 0
    ops_out = [ops.nmce_matmul(torch.tensor(x_np, device=dev), w_q,
                               saturate_int16=sat) for sat in (False, True)]
    torch.cuda.synchronize()
    ops_launches = dict(ops.LAUNCHES)
    cpu_out = [ops.nmce_matmul(torch.tensor(x_np), w_q_cpu,
                               saturate_int16=sat) for sat in (False, True)]
    check(ops_launches["nmce_matmul"] == 2,
          f"ops: nmce_matmul launched {ops_launches['nmce_matmul']} times "
          f"in 2 calls")
    check(all(torch.equal(a.cpu(), b) for a, b in zip(ops_out, cpu_out)),
          "ops: ops.nmce_matmul on the card differs from the CPU")
    print(f"ops: ops.nmce_matmul on the card equals the CPU bit for bit in "
          f"both modes; launches {ops_launches}")
    details["ops"] = {"launches": ops_launches}

    # ---- 5) serve on the card (paged engine) ----------------------------------
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = Model(cfg).init(gen, device=dev)
    prompts = [rng.integers(0, cfg.vocab, int(n), dtype=np.int32)
               for n in rng.integers(8, 201, 16)]
    max_new = 32
    engine = Engine(cfg, params, scfg, device=dev)
    gpu_ticks, _, _ = recording_engine(engine)
    gpu_tokens, _, wall, summary, launches = serve(engine, prompts, max_new)
    steps = engine.runner.n_steps
    print_serve("serve", len(prompts), summary, wall, steps, launches)
    for key in ("paged_attention", "sparse_gather_matvec"):
        check(launches[key] == cfg.n_layers * steps > 0,
              f"serve: {key} launched {launches[key]} times in {steps} "
              f"steps, expected one per layer per step")
    check_tokens("serve", gpu_tokens, cfg, max_new, gpu_ticks)
    details["serve"] = dict(summary, wall_s=wall, steps=steps,
                            launches=launches)

    # ---- 6) the same on the CPU (plain versions) -----------------------------
    cpu_engine = Engine(cfg, params, scfg, device="cpu")
    cpu_ticks, _, margins = recording_engine(cpu_engine)
    cpu_tokens, cpu_rids, _, _, _ = serve(cpu_engine, prompts, max_new)
    logit_err = float(np.abs(gpu_ticks[0] - cpu_ticks[0]).max())
    check(logit_err <= LOGIT_ATOL,
          f"cpu: first-step logits differ by {logit_err} from the card's")
    flips = compare_cpu("cpu", gpu_tokens, cpu_tokens, margins, cpu_rids)
    print(f"cpu: first-step logits max_abs_err {logit_err:.3g}; "
          f"{len(prompts) - len(flips)}/{len(prompts)} requests "
          f"token-identical; near-tie flips: {flips}")
    details["cpu"] = {"first_step_logit_err": logit_err, "flips": flips}

    # ---- 7) serve on the card (slot engine) -----------------------------------
    slot = Engine(cfg, params, slot_scfg, device=dev)
    slot_ticks, slot_prefills, _ = recording_engine(slot)
    slot_tokens, _, slot_wall, slot_summary, slot_launches = serve(
        slot, prompts, max_new)
    dsteps = slot.metrics.decode_steps
    print_serve("slot", len(prompts), slot_summary, slot_wall, dsteps,
                slot_launches)
    for key, want in (("decode_attention", cfg.n_layers * dsteps),
                      ("sparse_gather_matvec", cfg.n_layers * dsteps),
                      ("relu_ffn", cfg.n_layers * len(prompts)),
                      ("paged_attention", 0)):
        check(slot_launches[key] == want,
              f"slot: {key} launched {slot_launches[key]} times, expected "
              f"{want} ({dsteps} decode steps, {len(prompts)} prefills)")
    check(dsteps > 0, "slot: no decode step ran")
    check_tokens("slot", slot_tokens, cfg, max_new,
                 slot_ticks + slot_prefills)
    details["slot"] = dict(slot_summary, wall_s=slot_wall,
                           decode_steps=dsteps, launches=slot_launches)

    # ---- 8) the slot engine on the CPU ----------------------------------------
    slot_cpu = Engine(cfg, params, slot_scfg, device="cpu")
    _, cpu_prefills, slot_margins = recording_engine(slot_cpu)
    slot_cpu_tokens, slot_cpu_rids, _, _, _ = serve(slot_cpu, prompts,
                                                    max_new)
    slot_err = float(np.abs(slot_prefills[0] - cpu_prefills[0]).max())
    check(slot_err <= LOGIT_ATOL,
          f"slot-cpu: first prefill logits differ by {slot_err} from the "
          f"card's")
    slot_flips = compare_cpu("slot-cpu", slot_tokens, slot_cpu_tokens,
                             slot_margins, slot_cpu_rids)
    print(f"slot-cpu: first prefill logits max_abs_err {slot_err:.3g}; "
          f"{len(prompts) - len(slot_flips)}/{len(prompts)} requests "
          f"token-identical; near-tie flips: {slot_flips}")
    details["slot_cpu"] = {"first_prefill_logit_err": slot_err,
                           "flips": slot_flips}

    # ---- 9) both serves again, under torch.profiler -------------------------
    profiles = {}
    for label, sc, toks, lnch, w in (
            ("paged", scfg, gpu_tokens, launches, wall),
            ("slot", slot_scfg, slot_tokens, slot_launches, slot_wall)):
        pr = profile_serve(f"profile {label}", Engine(cfg, params, sc,
                                                      device=dev),
                           prompts, max_new, toks, lnch, w)
        profiles[label] = pr
        per = ", ".join(f"{k} {v:.5f}"
                        for k, v in pr["kernel_device_ms"].items())
        print(f"profile {label}: same tokens and launches; device ms per "
              f"launch: {per}; serve device time {pr['device_ms']:.3f} ms"
              f" = {100 * pr['busy_share']:.2f}% of the unprofiled wall "
              f"{w:.3f} s (profiled wall {pr['profiled_wall_s']:.3f} s)"
              + (f"; kv_len {pr['kv_len_range'][0]}-"
                 f"{pr['kv_len_range'][1]}" if "kv_len_range" in pr else ""))
        print(f"profile {label}: most device time (name, count, ms): "
              + "; ".join(f"{n} x{c} {t:.3f}" for n, c, t in pr["top_device"]))
    details["profile"] = profiles

    # ---- report --------------------------------------------------------------
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(details, indent=1))
    # each kernel's main-path launches (nmce_matmul: the ops phase), and
    # its row at the shape the main path gives it
    path_launches = {
        "paged_attention": launches["paged_attention"],
        "sparse_gather_matvec": launches["sparse_gather_matvec"]
        + slot_launches["sparse_gather_matvec"],
        "decode_attention": slot_launches["decode_attention"],
        "relu_ffn": slot_launches["relu_ffn"],
        "nmce_matmul": ops_launches["nmce_matmul"]}
    main_case = {"paged_attention": rows["paged_attention"][0],
                 "sparse_gather_matvec": rows["sparse_gather_matvec"][0],
                 "decode_attention": rows["decode_attention"][0],
                 "relu_ffn": rows["relu_ffn"][0],
                 "nmce_matmul": rows["nmce_matmul"][0]}
    kernels = []
    for key, (_, src, replaces) in KERNELS.items():
        r = main_case[key]
        errs = [x["max_abs_err"] for x in rows[key]]
        if key in edges:
            errs.append(edges[key][1])
        kernels.append({
            "name": key, "route": "cuda", "source": src,
            "replaces": replaces, "launches": path_launches[key],
            "max_abs_err": max(errs),
            "ms": r["ms"], "device_ms": r["device_ms"],
            "serve_device_ms": {
                e: pr["kernel_device_ms"][key]
                for e, pr in profiles.items()
                if key in pr["kernel_device_ms"]} or None,
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "library_device_ms": r["library_device_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    except Failure as exc:
        print(f"FAIL: {exc}", file=sys.stderr)
        sys.exit(1)
