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
               widths, kernels 1 and 5 also at llama3.2-1b-smoke's d_head
               16 and kernel 1 with bf16 pools at nectar's shape, and
               at the shapes speculative decoding gives them (kernel 1
               at nectar verify rows of S = 5 and 9; kernel 5 at the
               draft model's step with parked rows; kernel 2 over the
               72 verify rows, the draft model's W_down [256, 64] and
               self-spec's k = 32 of 640)
               (W8A8 also at Llama-3-8B's up projection; sentinel
               table entries and indices, an idle slot past the cache,
               dead d_ff blocks, int16 saturation); times
               of kernel, plain version and a library yardstick, the
               kernel's and the yardstick's device time per call from
               torch.profiler; then every kernel at the edges of its split
               design (one-block rows, rows ending on a block boundary,
               uneven splits, IDLE and all-empty rows, block sizes
               8/16/32, S*G 1-128, k not a multiple of the split; kv_len
               0/1/31-33/S-1/S/S+5 and contexts either side of a split
               round, G 1/4/8 at Dh 32/64/128 and G 1/2/4 at Dh 16, f32
               and bf16, for kernel 5 and for kernel 1's pools; M 1-200,
               d_ff
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
  9. prefix  — 16 requests sharing a 128-token system prompt (suffixes of
               8-64 tokens) through the paged engine with the radix prefix
               cache, then without it: identical tokens, prefix hits,
               fewer prompt tokens through the model, and prefill rows that
               start at the cached length (kernel 1 at S > 1 over cached
               blocks); then the cache-on serve on the CPU, near-tie rule.
 10. sampled — the phase-5 prompts as seeded sampled rows (temperature
               0.7/1.0, top_k 0/40, top_p 1.0/0.9, repetition penalty
               1.0/1.2) on the card and on the CPU: every token agrees, or
               the CPU's top-2 margin of the perturbed score (Gumbel noise
               plus filtered logits) is <= NEAR_TIE.
 11. int8kv  — the paged engine with int8 KV pools and the naive read
               serves the phase-5 prompts, card against CPU, near-tie rule.
 12. smoke   — llama3.2-1b-smoke (d_head 16, GQA 4/2) through the paged
               and the slot engine on the card, against the CPU.
 14. spec    — speculative decoding (runs before phase 13): a verify
               row's logits against the same tokens decoded one row at a
               time (KERNEL_ATOL); then the paged engine serves the
               phase-5 prompts with greedy rows through the ngram, model
               (nectar-relu-llama-draft, seeded weights) and selfspec
               drafters (k 4, k_max 8, adaptive): kernels 1, 2 and 5
               launch as the counters say, tokens agree with the phase-5
               paged serve and with each serve's CPU run (near-tie rule);
               verify steps, acceptance, tokens per verify, draft steps
               and the drafting's share of the wall; then seeded sampled
               rows (ngram, temperature 0.7), card against CPU, where a
               sampled verify token's margin is the distance of a
               uniform from its accept threshold or draw boundary.
 15. async   — the async engine (runs before phase 13): the phase-5
               prompts sync once more (the baseline), then with overlap
               ticks (K = 1) and device-resident bursts (K = 8), each a
               CUDA graph of one decode iteration replayed; tokens agree with the phase-5 paged serve and
               with the serve's CPU run (near-tie rule); then the
               decode-heavy traffic (8 prompts of 16-64 tokens, max_new
               256) sync, K = 1 and K = 8, the async serves against the
               eager one; tokens/s, TTFT and TPOT, wall per device tick,
               async_stats, graph captures and replays, and kernels 1
               and 2 at 6 launches per device tick by the graph-aware
               counters; every tick after the prefills of an async serve
               under torch.cuda.set_sync_debug_mode("error").
 16. obs     — tracing and the roofline profiler (runs before phase 13):
               the phase-5 prompts through the paged engine with
               ObsConfig(enabled=True, profile=True), tokens against the
               phase-15 sync serve (near-tie rule), the attainment table
               against the H100 SXM entry (attain in (0, 1] in every
               bucket, attain_raw printed); the Perfetto and JSONL traces
               checked by tools/check_trace.py; one traced serve under
               torch.profiler, whose summed tick device_ms must be at
               least 0.95 of the profiler's CUDA kernel time; the
               decode-heavy traffic at K = 8 traced (device ms per device
               tick beside phase 15's wall per device tick); the phase-5
               prompts with tracing off and on (the wall of each); one
               scrape of the metrics endpoint on localhost.
 17. disagg  — disaggregated serving and the fleet (runs before phase
               13), nectar at full width: (a) the phase-5 prompts through
               a DisaggCoordinator (a prefill and a decode engine, the KV
               handed over as block copies): tokens against the phase-5
               paged serve and the coordinator's CPU run (near-tie rule);
               each engine launches kernels 1 and 2 once per layer per
               step (the prefill engine's steps compute the sparse branch
               too, for rows that keep the dense one); handoffs, blocks and
               bytes moved, the largest handoff's copy timed by
               torch.profiler, the host's time a handoff; tokens/s
               against the phase-15 sync serve, TTFT, TPOT and the
               interference split; (b) int8 KV pools: every handoff's
               imported rows bit-equal to the exported ones, scales
               included, before the release; (c) an async decode engine
               (K = 8): graph replays over the imported blocks, the pools
               in place, tokens against (a); (d) two replicas serve the
               phase-9 traffic (one arrival a router poll) with the
               affinity and the round_robin policy: tokens against the
               phase-9 single engine, the router's decisions per replica,
               the pooled prefix hit rate, tokens/s and TTFT; then async
               replicas (K = 8) polled serially and from a thread pool:
               the same tokens, launches and decisions; (e) scale_down(1)
               after the last arrival: the drained replica's in-flight
               requests finish with the round-robin fleet's tokens and it
               is reaped once idle.
 18. recurrent — the recurrent families through the slot engine (runs
               after phase 12): (a) kernel 5 at zamba2-2.7b's decode
               shape (B 4, Hq = Kv = 32, Dh 80, S 512, f32, kv_len
               1-192) against its plain version is a phase-3 row, with
               its columns, and Dh 80 joins kernel 5's edge sweep there;
               (b) zamba2-smoke and xlstm-smoke, f32, 16 prompts of
               8-128 tokens on the slot engine, card against CPU (kernel
               5 once per shared-attention invocation a decode step,
               xlstm no kernel); (c) zamba2-2.7b at full width cut to
               18 of 54 layers (3 of its 9 units) in bf16 (seeded
               weights made on the card), 4 prompts of
               32-128 tokens, 16 new tokens each, teacher-forced on the
               CPU through the card's tokens and held to ROADMAP §3's
               bf16 rule at every generated token (logits within the bf16
               error measured on the CPU of the CPU's and of the f32
               forward of the same weights, a token apart from the CPU's
               choice only where the CPU margin is within it), with two
               control faults of the recurrent state (rounded to bf16;
               a lost write, which must fail the bound), kernel 5
               three times a decode step at Dh 80; tokens/s and TPOT from
               a plain serve, which runs again under torch.profiler
               (busy share, kernel 5's device ms a call); (d) xlstm-125m
               in bf16 the same way; (e) llama3.2-1b-smoke in
               bf16 through the paged flash engine (kernel 1 with a bf16
               model's q) on the phase-5 prompts (token ids mod its
               vocab), teacher-forced, bf16 rule; (f) a recurrent draft
               model (zamba2-smoke with nectar's vocab, seeded) drafting one
               request at a time for the paged nectar engine: tokens
               against phase 5's paged serve and the CPU, kernel 5 once a
               draft step.
 19. families — the paper's C4 dispatch, then the attention variants
               and MoE (runs after phase 18): (a) core.heterogeneous's
               decode decision tables at the v5e's and the H100 SXM's
               ridge side by side (nectar, llama3.2-1b, qwen3-4b,
               moonshot widths, batch 8), and a Dispatcher at the H100
               SXM sending nectar's decode sites and a prefill-sized site
               to kernel 4 (exact), kernel 2 and torch.matmul (within
               1e-5 of their plain versions); (b) kernel 1 at Dh 128,
               f32 pools, G 4/8/5/1 (qwen3-4b, qwen2.5-3b, maverick,
               moonshot), S 1 and 4, is a phase-3 row, within 1e-6 +
               1e-5 x |exact| of its plain version evaluated in f64 and
               bit-equal relaunched; (c) the four
               SMOKEs, f32, on the phase-5 prompts through the paged flash
               engine, card against CPU teacher-forced (near-tie rule; an
               MoE request judged before its first routing difference,
               which must be a router near-tie or a capacity drop), and
               moonshot-v1-smoke through the async engine at K = 8 with
               the sync serve's tokens; (d) qwen3-4b at full width, cut
               to 12 of 36 layers, in bf16 (seeded weights made on the
               card), 4 prompts
               of 32-128 tokens, 16 new tokens each, teacher-forced on the
               CPU and held to the bf16 rule, times from a plain serve and
               a profiled one (busy share, kernel 1's device ms a call);
               (e) moonshot-v1-16b-a3b at full width cut to 2 layers, the
               same, with the MoE blocks' share of the device time and
               the capacity drops per step.
 20. frontends — qwen2-vl's M-RoPE and vision stub, musicgen's
               sinusoidal positions and codebook streams (runs after
               phase 19): (a) qwen2-vl-smoke and musicgen-smoke, f32, on
               the phase-5 prompts (musicgen's [L, 2]) through the paged
               flash and slot engines, card against CPU teacher-forced
               (near-tie rule, codebook by codebook), qwen2-vl-smoke also
               through the async engine at K = 8 with the sync serve's
               tokens; (b) musicgen-medium at full width in bf16, cut to
               12 of 48 layers (4 codebooks), 4 prompts of 32-128
               frames, 16 new tokens, paged flash and slot, held to
               phase 18's bf16 rule;
               (c) qwen2-vl-72b at full width cut to 2 layers, bf16, 4
               prompts of 16-64 tokens, paged flash under phase 19's
               judge="f32", and one Model.forward
               with patch embeddings and a t/h/w M-RoPE grid against the
               CPU; (d) kernel 1 at (24, 24, Dh 64) and (64, 8, Dh 128)
               and kernel 5 at (24, 24, Dh 64) are phase-3 rows, each
               within 1.5e-6 of its plain version.
 13. profile — the paged, slot, prefix, sampled, int8kv, the ngram and
               model spec serves, the K = 8 decode-heavy async serve and
               the phase-17 disagg serve again under torch.profiler: each kernel's device time per
               launch at the shapes the serve gives it, the profiler's
               launch counts against the counters, the serve's device
               time over the unprofiled serve's wall, and the same tokens
               as before; then one record_shapes window over the paged
               serve names the shapes and the Python line of every GEMM.
 21. train   — training (runs after phase 13): (a) kernel 3 with its
               autograd rule at nectar's training rows (M 512): one
               launch a forward and none in the backward, the output
               within 1.5e-5 and dx, dW_up, dW_down within 1e-4
               (relative) of the plain version's autograd, with the
               forward's and the backward's device ms (its phase-3 row
               and the backward's time are measured in phase 3); (b)
               nectar trained 60 steps (B 8, S 64, lr 3e-3) on the card
               and on the CPU from the same params: ce falling below
               0.7x on both, card within 1e-3 of the CPU over the first
               20 steps, 6 kernel-3 launches a step, step ms, tokens/s,
               device events a step and the busy share; (c) ReLU
               sparsity before and after, layer 0 above 0.45; (d) 6 steps
               straight equal to 3 +
               checkpoint + restore + 3 bit for bit, the preemption guard
               stopping after one step with a checkpoint, 8-bit Adam
               within 20% of fp32 Adam after 50 steps; (e) the trained
               checkpoint served through the paged flash engine (kernels
               1 and 2) against the CPU, near-tie rule; (f) llama3.2-1b at
               full width in f32: 2 of 16 layers, one step's loss and
               gradients against the CPU, then 16 layers for 3 steps of
               8-bit Adam, peak memory and step ms.
 22. mesh    — multi-device (runs after phase 21): meshes of n shards on
               the one card (``["cuda:0"] * n``, one controller); (a)
               nectar paged with the naive read at model 2, model 4,
               model 4 with shard_kv_seq (the LSE-combine decode),
               model 2 with int8 KV and model 4 with the n-gram drafter
               and the prefix cache on phase 9's prompts: each
               token-identical (near-tie rule) to the unsharded card
               serve of its settings and to the CPU's unsharded serve
               (phases 6, 11, 9), kernel 2 n x the unsharded launches
               (once a shard, on its [640, 128 / n] column block of
               W_down), the per-shard pool bytes tiling the pool,
               tok/s, TPOT p50 and (model 4) the busy share beside the
               unsharded naive serve's (both profiled among phase 13's
               windows, where the profiler has its slack); kernel 2 at
               the shards' [640,
               64] and [640, 32] blocks are phase-3 rows; (b)
               llama3.2-1b in f32 at full width cut to 2 of 16 layers
               at model 4 (2 KV heads a shard) against its unsharded
               serve, bytes a shard; (c) lse_combine_decode_attention
               and ring_attention at model 4 against
               flash.reference_attention (2e-5, 3e-5); (d) the sharded
               train step, nectar on (data 2, model 2), 3 steps
               against the unsharded step: ce within 1e-4, params within
               1e-4 but for the w_up columns and w_down rows of the FFN
               units whose ReLU mask (kernel 3's backward recompute,
               recorded in both runs) differs between the runs (within
               2 x the steps' lr; printed with their pre-activation over
               its rounding scale), kernel 3 6 launches a
               data shard, w_up in 2 slices of [6, 128, 320];
               reshard_params (2, 2) -> (1, 2) bit-equal; a fleet of two
               model-2 engines scaled down, reaped and resharded.
It exits non-zero, printing no result, when there is no CUDA device or a
check fails. Its last line is the result JSON; the line before it holds
the per-kernel JSON. Details go to build/chip_smoke.json.
"""

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
STARTED = time.perf_counter()
SEED = 0
KERNEL_ATOL = 1e-4   # kernel vs plain version: the same f32 terms (bf16
#                      K/V widened exactly) summed in another order;
#                      errors seen are ~1e-6, and up to ~2e-5 for the
#                      fused FFN's 3xTF32 products at d 2048
FAMILY_ATOL = 1e-6   # kernel 1 at the new configs' head groupings (phase
FAMILY_RTOL = 1e-5   # 19 (b)) against its plain version evaluated in f64:
#                      |kernel - exact| <= ATOL + RTOL * |exact|. Both f32
#                      versions round the online and the plain softmax at
#                      Dh 128 by ~1e-6 (up to 1.49e-6 apart at G 5, the
#                      kernel up to 1.31e-6 from the exact answer at G 4,
#                      PR 22), so 1e-6 alone does not hold
FRONTEND_ATOL = 1.5e-6   # kernels 1 and 5 at the frontends' shapes (phase
#                      20 (d)) against their plain versions: the same f32
#                      terms summed in another order
LOGIT_ATOL = 1e-3    # card vs CPU logits of one whole forward step
NEAR_TIE = 1e-3      # a token flip with a CPU top-2 margin at most this
#                      is a summation-order near-tie, not a fault
ROUTER_TIE_SIGMAS = 8   # where a run taking another's expert choices would
#                      have chosen otherwise, the top-k boundary gap of its
#                      router logits must lie within this many RMS of the
#                      two runs' router-logit differences: a near-tie that
#                      the other summation order or bf16 rounding crossed,
#                      not a difference of its own
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
F32_FLOPS_PER_S = 67e12       # H100 SXM f32 rate outside the tensor cores
TF32_FLOPS_PER_S = 495e12     # H100 SXM dense TF32 tensor-core rate
INT8_OPS_PER_S = 1979e12      # H100 SXM dense int8 tensor-core rate
PROFILE_ITERS = 20
PROFILE_TRIES = 12            # windows a profiled measurement may take
PROFILE_PAUSE_S = 0.2         # before a window runs again, times the
#                               windows lost so far (see ``profiled``)
PROFILE_DEADLINE_S = 1000     # no window runs again after this: the
#                               last windows (phase 13's) end by about
#                               750 s, the script by about 800-970 s and
#                               must by 1200 s; past this a lossy window
#                               fails the check that reads it
BLIND = []                    # set once the profiler proved blind
TOP_DEVICE = 6                # device-time leaders listed per profiled serve
DRAFT_NAME = "nectar-relu-llama-draft"

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


def lap(clock, phase):
    """Print the seconds since the script started and since the last lap,
    at the end of ``phase``."""
    now = time.perf_counter()
    print(f"time: {phase} done at {now - clock[0]:.1f} s "
          f"({now - clock[-1]:.1f} s)")
    clock.append(now)


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


def profiled(fn, complete=None, setup=None):
    """Run ``fn`` under torch.profiler, given what ``setup`` returns where
    there is one (called before each window, outside it, so that a window
    that runs again starts afresh); returns (its result, the profiler's
    per-name averages). The profiler records CUDA activity only: the CPU
    side's ops are not read here, and recording them too made phase 13's
    windows about twice as slow to read back. The profiler loses events
    now and then: a window with no device activity at all although
    kernels ran in it, or one that lacks some of them (about one window in
    a hundred on an H100; several in a row on some machines). A window
    that shows no device activity, or that ``complete`` (a test of the
    averages) rejects, runs again after a pause that grows with each
    window lost (the losses come in streaks), up to PROFILE_TRIES
    times in all while the script is younger than PROFILE_DEADLINE_S. If
    no try showed device activity the averages are None: the profiler is
    blind here and the caller reports its device times as not measured
    (the launch counters still witness every kernel). If every try saw
    device activity but none was complete, the last window's averages
    return and the caller's own check decides."""
    from torch.profiler import ProfilerActivity, profile
    averages, fault = None, None
    for attempt in range(1 if BLIND else PROFILE_TRIES):
        if attempt and time.perf_counter() - STARTED > PROFILE_DEADLINE_S:
            print(f"profiler: window {attempt} {fault}; past "
                  f"{PROFILE_DEADLINE_S} s, not running it again")
            break
        if attempt:
            print(f"profiler: window {attempt} of {PROFILE_TRIES} {fault}; "
                  f"running it again")
            time.sleep(PROFILE_PAUSE_S * attempt)
        args = () if setup is None else (setup(),)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = fn(*args)
            torch.cuda.synchronize()
        window = device_averages(prof)
        if not any(e.self_device_time_total > 0
                   for e in device_events(window)):
            fault = "showed no device activity"
            continue
        averages, fault = window, "lost events"
        if complete is None or complete(averages):
            break
    if averages is None and not BLIND:
        # a profiler blind for PROFILE_TRIES windows in a row takes one
        # window a measurement from here on, so the run keeps its time
        BLIND.append(True)
        print(f"profiler: no device activity in {PROFILE_TRIES} windows; "
              f"device times from here on are not measured where a single "
              f"window shows none")
    return out, averages


class DeviceAverage:
    """One name's CUDA events in a profiler window: the fields of
    torch.profiler's FunctionEventAvg that this script reads, with the
    same values (a device event has no children, so its self time is its
    time, and an async one counts with no time)."""
    __slots__ = ("key", "count", "device_time_total", "device_type",
                 "is_user_annotation")

    def __init__(self, key, device_type, is_user_annotation):
        self.key, self.device_type = key, device_type
        self.is_user_annotation = is_user_annotation
        self.count, self.device_time_total = 0, 0.0

    @property
    def self_device_time_total(self):
        return self.device_time_total


AVERAGES_CHECKED = []   # set once a window's reading matched key_averages


def device_averages(prof):
    """The window's CUDA events summed by name (µs), read from the
    profiler's Kineto events. ``key_averages`` first builds a Python event
    object for every event, CPU-side launch records included: about 10 s
    for a serve's ~100k kernels, most of each profiled serve's time. The
    first window with device activity is read both ways and must agree
    (count and device µs for every name)."""
    from torch.autograd import DeviceType
    out, names = {}, {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or getattr(
                e, "is_hidden_event", lambda: False)():
            continue
        raw = e.name()
        name = names.get(raw)
        if name is None:
            # key_averages's names: demangled, as its StringTable does
            name = names[raw] = (torch._C._demangle(raw) if len(raw) > 1
                                 else raw)
        a = out.get(name)
        if a is None:
            a = out[name] = DeviceAverage(name, DeviceType.CUDA,
                                          e.is_user_annotation())
        a.count += 1
        if not (e.is_async() or e.start_thread_id() != e.end_thread_id()):
            a.device_time_total += (e.end_ns() - e.start_ns()) / 1e3
    averages = list(out.values())
    if not AVERAGES_CHECKED and any(a.device_time_total > 0
                                    for a in averages):
        slow = {e.key: (e.count, e.device_time_total)
                for e in device_events(prof.key_averages())}
        fast = {e.key: (e.count, e.device_time_total)
                for e in device_events(averages)}
        check(slow.keys() == fast.keys() and all(
            slow[k][0] == fast[k][0]
            and abs(slow[k][1] - fast[k][1]) <= 1e-6 * max(1.0, slow[k][1])
            for k in slow),
              f"profiler: the Kineto events read directly {fast} differ "
              f"from key_averages {slow}")
        AVERAGES_CHECKED.append(True)
    return averages


def launch_count(averages, kernel):
    """How often the profiler saw ``kernel``'s first CUDA kernel run (once
    per wrapper launch)."""
    return sum(e.count for e in averages if KERNELS[kernel][0][0] in e.key)


def kernel_device(averages, kernel):
    """(device µs, launches) the profiler attributes to ``kernel``: the
    CUDA time of all its CUDA kernels, and how often the first of them ran
    (one per wrapper launch). A kernel missing from a window that shows
    device activity fails the run: no other clock stands in for the device
    time."""
    names = KERNELS[kernel][0]
    us = sum(e.device_time_total for e in averages
             if any(n in e.key for n in names))
    count = launch_count(averages, kernel)
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


def window_averages(fn, complete=None):
    """torch.profiler's per-name averages over PROFILE_ITERS calls of
    ``fn``, after one call outside the window (None: see ``profiled``)."""
    fn()
    torch.cuda.synchronize()
    return profiled(lambda: [fn() for _ in range(PROFILE_ITERS)],
                    complete)[1]


def device_ms(fn, kernel):
    """The kernel's own device time per call, and the part of it its
    combine pass takes (0 where it has none or did not split): the CUDA
    time torch.profiler attributes to its kernels over PROFILE_ITERS
    calls, averaged. The window must count all PROFILE_ITERS launches;
    (None, None) where the profiler was blind."""
    averages = window_averages(
        fn, lambda a: launch_count(a, kernel) == PROFILE_ITERS)
    if averages is None:
        return None, None
    us, count = kernel_device(averages, kernel)
    check(count == PROFILE_ITERS,
          f"{kernel}: the profiler counted {count} of {PROFILE_ITERS} "
          f"launches in {PROFILE_TRIES} windows")
    combine = sum(e.device_time_total for e in averages
                  if any(n in e.key for n in KERNELS[kernel][0][1:]))
    return us / PROFILE_ITERS / 1e3, combine / PROFILE_ITERS / 1e3


def library_device_ms(fn):
    """A library call's device time per call: all the CUDA time
    torch.profiler sees in the window of PROFILE_ITERS calls, averaged; a
    window whose count of device events is no multiple of PROFILE_ITERS
    lost some and runs again. None where the profiler was blind."""
    averages = window_averages(
        fn, lambda a: sum(e.count for e in device_events(a))
        % PROFILE_ITERS == 0)
    if averages is None:
        return None
    total = sum(e.self_device_time_total for e in device_events(averages))
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


def attention_case(dev, rng, B, S, Hq, Kv, Dh, bs, MB, max_ctx,
                   pool_dtype=torch.float32):
    """Inputs for kernel 1: every row's blocks cover its causal limit,
    the rest of the table is sentinel; the last row is IDLE (all
    sentinel: it reads block 0, as the reference's kernel does)."""
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
    return (f32((B, S, Hq, Dh)), f32((n_blocks, bs, Kv, Dh)).to(pool_dtype),
            f32((n_blocks, bs, Kv, Dh)).to(pool_dtype), t(tables), t(lens))


def attention_work(q, k_pool, tables, lens):
    """(bytes, flops) this input needs: q and the output once, the
    tables and lens, the K and V blocks each row's queries can see (a
    sentinel entry among them reads block 0)."""
    B, S, Hq, Dh = q.shape
    n_blocks, bs, Kv, _ = k_pool.shape
    tb, ln = tables.cpu().numpy(), lens.cpu().numpy()
    blocks = set()
    flops = 0
    for b in range(B):
        n = min(tb.shape[1], (int(ln[b]) + S - 1) // bs + 1)
        blocks.update(int(x) if 0 <= x < n_blocks else 0 for x in tb[b, :n])
        vis = sum(min(int(ln[b]) + j + 1, tb.shape[1] * bs)
                  for j in range(S))
        flops += 4 * Dh * Hq * vis
    n_bytes = (2 * q.numel() + tables.numel() + lens.numel()) * 4 \
        + len(blocks) * bs * Kv * Dh * k_pool.element_size() * 2
    return n_bytes, flops


def paged_attention_f64(q, k_pool, v_pool, tables, lens):
    """``ref.paged_attention_plain``'s function evaluated in float64: the
    exact answer both f32 versions round, as f32."""
    from repro_torch.kernels import ref
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


def run_attention(dev, rng, label, exact=False, **shape):
    """One phase-3 row of kernel 1; with ``exact`` it also reads the
    kernel's and the f32 plain version's distances from the f64 answer
    (``f64_err``, ``plain_f64_err``)."""
    from repro_torch.kernels import decode_attn, ref
    import torch.nn.functional as F
    q, kp, vp, tables, lens = attention_case(dev, rng, **shape)
    err = held(f"{label}: paged_attention",
               lambda: decode_attn.paged_attention(q, kp, vp, tables, lens),
               lambda: ref.paged_attention_plain(q, kp, vp, tables, lens))
    # the live rows apart from the IDLE one, which reads block 0 at every
    # position of its context
    extra = {"live_rows_err": float(
        (decode_attn.paged_attention(q, kp, vp, tables, lens)[:-1]
         - ref.paged_attention_plain(q, kp, vp, tables, lens)[:-1])
        .abs().max())}
    if exact:
        want = paged_attention_f64(q, kp, vp, tables, lens)
        got = decode_attn.paged_attention(q, kp, vp, tables, lens)
        extra.update({
            "f64_err": float((got - want).abs().max()),
            "f64_excess": float(((got - want).abs()
                                 - FAMILY_RTOL * want.abs()).max()),
            "plain_f64_err": float((ref.paged_attention_plain(
                q, kp, vp, tables, lens) - want).abs().max())})
    # the library yardstick: SDPA over the gathered, masked sequence, in
    # the pools' dtype (a sentinel gathers block 0, as the kernel reads it)
    kg = ref._gather_clamped(kp, tables).transpose(1, 2)
    vg = ref._gather_clamped(vp, tables).transpose(1, 2)
    S, Skv = q.shape[1], kg.shape[2]
    vis = (torch.arange(Skv, device=dev)[None, None, :]
           <= (lens[:, None].long()
               + torch.arange(S, device=dev)[None, :])[:, :, None])
    qt, mask = q.to(kp.dtype).transpose(1, 2), vis[:, None]
    return dict(measure(
        "paged_attention", label, err,
        lambda: decode_attn.paged_attention(q, kp, vp, tables, lens),
        lambda: ref.paged_attention_plain(q, kp, vp, tables, lens),
        lambda: F.scaled_dot_product_attention(qt, kg, vg, attn_mask=mask,
                                               enable_gqa=True),
        *attention_work(q, kp, tables, lens)), **extra)


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


def attention_edge(dev, rng, S, G, Dh, bs, MB, lens, pool_dtype, label):
    """One edge case of kernel 1: rows of the given contexts (the last
    IDLE, all sentinel: block 0, as the plain version reads it) over
    scattered blocks. Returns its max abs error."""
    from repro_torch.kernels import decode_attn, ref
    Kv, B = 2, len(lens)
    n_blocks = B * MB
    tables = np.full((B, MB), n_blocks, np.int32)
    free = list(rng.permutation(n_blocks))
    for b in range(B - 1):                     # the last row is IDLE
        m = -(-(lens[b] + S) // bs)
        tables[b, :m] = [free.pop() for _ in range(m)]
    q = torch.tensor(rng.standard_normal((B, S, Kv * G, Dh)),
                     dtype=torch.float32, device=dev)
    kp, vp = (torch.tensor(rng.standard_normal((n_blocks, bs, Kv, Dh)),
                           dtype=pool_dtype, device=dev) for _ in range(2))
    t = torch.tensor(tables, device=dev)
    ln = torch.tensor(np.asarray(lens, np.int32), device=dev)
    return held(f"edges paged_attention {label}",
                lambda: decode_attn.paged_attention(q, kp, vp, t, ln),
                lambda: ref.paged_attention_plain(q, kp, vp, t, ln))


def attention_edges(dev, rng):
    """Kernel 1 at the edges of its split design. Rows: one block (where
    S <= bs), ending exactly on a block boundary, a long context that
    splits unevenly over warps and CTAs, a short one, an IDLE row (all
    sentinel: block 0); block sizes 8/16/32, S*G from 1 to 128, head
    dims 32/64/128, a narrow table (MB 4: no split). Then head dim 16 with
    f32 and bf16 pools and bf16 pools at nectar's head dim 32: contexts
    0, 1, 31-33, a full table less the row's queries and one short of it,
    G 1/2/4, S 1/3/16. Returns the cases' count and their largest
    error."""
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
            worst = max(worst, attention_edge(
                dev, rng, S, G, Dh, bs, MB, lens, torch.float32,
                f"bs={bs} S={S} G={G} Dh={Dh} MB={MB}"))
            n += 1
    bs, MB = 16, 96
    for dtype, Dh in ((torch.float32, 16), (torch.bfloat16, 16),
                      (torch.bfloat16, 32)):
        for S in (1, 3, 16):
            for G in (1, 2, 4):
                cap = MB * bs - S
                lens = [0, 1, 31, 32, 33, cap - 1, cap, 0]
                worst = max(worst, attention_edge(
                    dev, rng, S, G, Dh, bs, MB, lens, dtype,
                    f"{dtype} bs={bs} S={S} G={G} Dh={Dh} MB={MB}"))
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
    """Kernel 5 at the edges of its split design, for G in {1, 4, 8} at Dh
    32, 64, 80 and 128 and G in {1, 2, 4} at Dh 16, f32 and bf16 K/V,
    S = 333
    (no multiple of a chunk):
    kv_len 0 (a mean over all S), 1, 31/32/33, S-1, S, S+5 (an idle slot)
    and contexts one key either side of the last chunk of a round over the
    splits and over the warps of ``decode_plan``. Returns the cases' count
    and their largest error."""
    from repro_torch.kernels import build, decode_attn, ref
    n, worst, S, Kv = 0, 0.0, 333, 2
    n_sm = build.sm_count(dev.index)
    shapes = [(G, Dh) for G in (1, 4, 8) for Dh in (32, 64, 128)] \
        + [(G, 16) for G in (1, 2, 4)] + [(G, 80) for G in (1, 4, 8)]
    for dtype in (torch.float32, torch.bfloat16):
        for G, Dh in shapes:
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
        lib, lib_dev, dev, comb = (
            "none" if r[key] is None else f"{r[key]:.5f}"
            for key in ("library_ms", "library_device_ms", "device_ms",
                        "combine_device_ms"))
        print(f"kernel {kernel} [{r['case']}]: max_abs_err="
              f"{r['max_abs_err']:.3g} ms={r['ms']:.5f} device_ms="
              f"{dev} (combine {comb})"
              f" plain_ms="
              f"{r['plain_ms']:.5f} library_ms={lib} library_device_ms="
              f"{lib_dev} bound_ms="
              f"{r['bound_ms']:.6f} ({r['bound_by']})"
              + "".join(f" {key}={r[key]:.3g}" for key in (
                  "live_rows_err", "f64_err", "plain_f64_err") if key in r))


# ---------------------------------------------------------------------------
# phases 5-8: serving


def perturbed_scores(logits, presence, temp, top_k, top_p, rep, keys):
    """What each row's token is the argmax of, f32[B, V] on the host: the
    logits on an all-greedy tick; else the penalized logits of greedy rows
    and, for sampled rows, the Gumbel noise of their keys plus their
    filtered logits (``sampling.filter_batch``)."""
    from repro_torch.serve import prng, sampling
    logits = logits.float()
    if not np.any(temp > 0) and np.all(rep == 1.0):
        return logits.cpu().numpy()
    dev = logits.device
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    pen, final = sampling.filter_batch(logits, t(presence), t(temp),
                                       t(top_k), t(top_p), t(rep))
    noisy = prng.gumbel(t(keys.astype(np.int64)), logits.shape[-1]) + final
    return torch.where(t(temp)[:, None] > 0, noisy, pen).cpu().numpy()


def top2_margin(z):
    """The top-2 margin of a score vector f32[V]; of a codebook model's
    f32[nc, V], each codebook's (an array)."""
    z = np.sort(z, axis=-1)
    return z[..., -1] - z[..., -2]


def recording_engine(engine, scores=None):
    """Record the score vector behind every committed token (the logits,
    or the perturbed score of a sampled row) and its top-2 margin,
    {(rid, index): margin} (a codebook model's: the least of its
    codebooks'); with ``scores`` also each token's score vector there,
    {(rid, index): f32[V]} (f32[nc, V]). Every batched sample goes
    through ``engine.sampler``, a codebook model's through the engine's
    per-codebook argmax (``_sample_rows``); the slot engine samples a
    request's first token from its prefill logits on the host."""
    ticks, prefills, margins = [], [], {}
    sampler, append = engine.sampler, engine._append_token
    sample_rows = engine._sample_rows
    paged = engine.scfg.paged

    def recording_sampler(*args):
        ticks.append(perturbed_scores(*args))
        return sampler(*args)

    def recording_rows(pairs, last_logits):
        ticks.append(last_logits.float().cpu().numpy())
        return sample_rows(pairs, last_logits)

    def recording_append(req, slot, tok, lp):
        if paged or req.tokens_out:
            z = ticks[-1][slot]
        else:
            z = prefills[-1]
        if scores is not None:
            scores[(req.rid, len(req.tokens_out))] = z
        margins[(req.rid, len(req.tokens_out))] = float(
            np.min(top2_margin(z)))
        return append(req, slot, tok, lp)

    if not paged:
        prefill = engine.model.prefill

        def recording_prefill(*args):
            logits, cache = prefill(*args)
            prefills.append(logits[0, 0].float().cpu().numpy())
            return logits, cache
        engine.model.prefill = recording_prefill
    if engine.cfg.n_codebooks:
        engine._sample_rows = recording_rows
    else:
        engine.sampler = recording_sampler
    engine._append_token = recording_append
    return ticks, prefills, margins


def serve(engine, prompts, max_new, sps=None, forced=None):
    """Submit every prompt (with its SamplingParams, when given) through
    StreamingServer and drain it, with the launch counts set to 0 just
    before and read just after. With ``forced`` (a token list per prompt)
    the engine commits forced's tokens in place of the ones it samples:
    every step reads the forced stream (teacher forcing)."""
    from repro_torch.kernels import ops
    from repro_torch.serve import api
    server = api.StreamingServer(engine)
    for key in ops.LAUNCHES:
        ops.LAUNCHES[key] = 0
    stream = {}
    if forced is not None:
        # the slot engine commits a request's first token in submit
        append = engine._append_token

        def forced_append(req, slot, tok, lp):
            return append(req, slot, stream[req.rid][len(req.tokens_out)],
                          lp)
        engine._append_token = forced_append
    t0 = time.perf_counter()
    rids = []
    for i, p in enumerate(prompts):
        rid = engine.new_rid()
        stream[rid] = None if forced is None else forced[i]
        rids.append(server.submit(p, max_new=max_new, rid=rid,
                                  sampling=None if sps is None else sps[i]))
    finished = server.drain()
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    # a codebook model's token is a list of nc ids
    tokens = [[np.asarray(t).tolist() for t in finished[rid].tokens_out]
              for rid in rids]
    return tokens, rids, wall, engine.metrics.summary(), launches


def shard_devices(scfg, dev):
    """An engine's ``device`` for ``scfg``: one entry a shard of its mesh
    (``[dev] * n``, n shards on one card), else ``dev``."""
    mesh = scfg.mesh
    return [dev] * mesh.n_devices \
        if mesh is not None and mesh.n_devices > 1 else dev


def profile_serve(label, make_engine, prompts, max_new, tokens, launches,
                  wall, sps=None):
    """Serve ``prompts`` once more, on a fresh engine from ``make_engine``
    (one for each window the profiler takes), under torch.profiler. It
    must give the first serve's tokens and launch counts, and the profiler
    must count the launches the counters do. Returns each launched
    kernel's device time per launch at the shapes the serve gives it, the
    serve's device time (every CUDA kernel and copy), its share of the
    first, unprofiled serve's ``wall`` and the TOP_DEVICE names that took
    most of it (None and empty where the profiler was blind); for the slot
    engine also the range of kv_len its decode attention saw."""
    kv_lens, made = [], []

    def fresh_engine():
        engine = make_engine()
        kv_lens.clear()
        made[:] = [engine]
        if not engine.scfg.paged:
            decode_step = engine.model.decode_step

            def recording_step(params, tok, cache):
                kv_lens.append(cache["lens"].cpu().numpy() + 1)
                return decode_step(params, tok, cache)
            engine.model.decode_step = recording_step
        return engine

    (again, _, pwall, _, plaunches), averages = profiled(
        lambda engine: serve(engine, prompts, max_new, sps),
        lambda a: all(launch_count(a, key) == n
                      for key, n in launches.items() if n),
        fresh_engine)
    check(again == tokens,
          f"{label}: the profiled serve's tokens differ from the first's")
    check(plaunches == launches, f"{label}: the profiled serve launched "
          f"{plaunches}, the first {launches}")
    out = {"kernel_device_ms": {}, "device_ms": None, "busy_share": None,
           "profiled_wall_s": pwall, "top_device": [],
           "n_device_events": None}
    if averages is not None:
        graphs = getattr(getattr(made[0], "runner", None), "graph_replays",
                         0)
        for key, n in launches.items():
            if n:
                us, count = kernel_device(averages, key)
                check(count == n, f"{label}: the profiler saw {key} run "
                      f"{count} times, its counter {n}"
                      + (f" ({graphs} CUDA graph replays in the serve: "
                         f"the profiler does not see every kernel of a "
                         f"graph)" if graphs else ""))
                out["kernel_device_ms"][key] = us / n / 1e3
        on_device = device_events(averages)
        out["device_ms"] = sum(e.self_device_time_total
                               for e in on_device) / 1e3
        out["busy_share"] = out["device_ms"] / (wall * 1e3)
        out["n_device_events"] = sum(e.count for e in on_device)
        out["top_device"] = [[e.key[:60], e.count,
                              e.self_device_time_total / 1e3]
                             for e in on_device[:TOP_DEVICE]]
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
    shape = (max_new, cfg.n_codebooks) if cfg.n_codebooks else (max_new,)
    check(all(np.shape(t) == shape and np.all(np.asarray(t) >= 0)
              and np.all(np.asarray(t) < cfg.vocab) for t in tokens),
          f"{label}: every request must return max_new valid token ids"
          + (f", {cfg.n_codebooks} a token" if cfg.n_codebooks else ""))
    check(all(np.isfinite(z).all() for z in logits),
          f"{label}: non-finite logits")


def compare_cpu(label, gpu_tokens, cpu_tokens, margins, rids,
                tie=NEAR_TIE):
    """Card tokens vs CPU tokens per request; a difference is allowed only
    where the CPU run's top-2 margin is at most ``tie``. Returns the
    flips."""
    flips = []
    for i, (a, b) in enumerate(zip(gpu_tokens, cpu_tokens)):
        if a == b:
            continue
        step = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
        margin = margins[(rids[i], step)]
        check(margin <= tie,
              f"{label}: request {i} diverges at token {step} with a CPU "
              f"top-2 margin {margin} > {tie}")
        flips.append({"request": i, "step": step, "margin": margin})
    return flips


class RecordingRNG:
    """A numpy Generator as the acceptance rules use it (``random`` and
    ``choice(n, p=p)``, the latter exactly as numpy draws it: one uniform
    against the normalized CDF), recording each uniform and, for a draw,
    its distance to the nearest CDF boundary."""

    def __init__(self, rng):
        self.rng, self.events = rng, []

    def random(self):
        u = self.rng.random()
        self.events.append(u)
        return u

    def choice(self, n, p):
        cdf = np.cumsum(p)
        cdf /= cdf[-1]
        u = self.rng.random()
        i = int(np.searchsorted(cdf, u, side="right"))
        lo = cdf[i - 1] if i else 0.0
        self.events.append(min(u - lo, cdf[i] - u))
        return i


def spec_margins(logits, toks, qd, events, temperature):
    """The margins of the tokens a sampled verify row emitted: for each,
    the smallest distance, over the accept tests and the draw that decided
    it, between a uniform and its threshold (min(1, p/q), or a CDF
    boundary of the residual or bonus draw). ``events`` alternate as
    ``rejection_accept`` consumes them: one uniform per accept test, one
    draw margin after a rejection or after the last test."""
    from repro_torch.serve.sampling import softmax
    out, prev, ev = [], np.inf, iter(events)
    for j, d in enumerate(toks):
        u = next(ev)
        p = softmax(logits[j], temperature)
        q_d = 1.0 if qd is None else float(qd[j][d])
        t = min(1.0, p[d] / max(q_d, 1e-12))
        prev = min(prev, abs(u - t))
        if u < t:
            out.append(prev)
            continue
        out.append(min(prev, next(ev)))
        return out
    out.append(min(prev, next(ev)))
    return out


def recording_spec_engine(engine):
    """``recording_engine`` for a spec engine. A first token's margin is
    the top-2 gap of the score the sampler took it from; a greedy verify
    token's the top-2 gap of its verify row's logits at its position; a
    sampled verify token's is ``spec_margins``'s. Returns (the sampler's
    score vectors, {(rid, index): margin}, {(rid, index): the score or
    logits row that decided the token})."""
    ticks, margins, deciding = [], {}, {}
    state = {"logits": None, "verify": None}
    rngs = {}
    sampler, append, step = (engine.sampler, engine._append_token,
                             engine.runner.step)
    commit, accept_rng = engine._commit_verify, engine._accept_rng

    def recording_sampler(*args):
        ticks.append(perturbed_scores(*args))
        return sampler(*args)

    def recording_step(batch):
        out = step(batch)
        state["logits"] = out.logits.float().cpu().numpy()
        return out

    def recording_accept_rng(rid, sp):
        if rid not in rngs:
            rngs[rid] = RecordingRNG(accept_rng(rid, sp))
        return rngs[rid]

    def recording_append(req, slot, tok, lp):
        key = (req.rid, len(req.tokens_out))
        if state["verify"] is None:
            deciding[key] = ticks[-1][slot]
            z = np.sort(deciding[key])
            margins[key] = float(z[-1] - z[-2])
        else:
            state["verify"].setdefault(req.rid, []).append(key)
        return append(req, slot, tok, lp)

    def recording_commit(rows, proposals, out, finished):
        state["verify"] = {}
        for r in rngs.values():
            r.events.clear()
        try:
            return commit(rows, proposals, out, finished)
        finally:
            verify, state["verify"] = state["verify"], None
            for e in rows:
                keys = verify.get(e.req.rid, [])
                _, toks, qd = proposals[e.req.rid]
                z = state["logits"][e.slot]
                temp = engine._sp(e.req).temperature
                if temp <= 0:
                    ms = [float(np.diff(np.sort(z[j])[-2:])[0])
                          for j in range(len(keys))]
                else:
                    ms = spec_margins(z, toks, qd, rngs[e.req.rid].events,
                                      temp)
                margins.update(zip(keys, ms))
                deciding.update((key, z[j]) for j, key in enumerate(keys))

    engine.sampler = recording_sampler
    engine.runner.step = recording_step
    engine._accept_rng = recording_accept_rng
    engine._append_token = recording_append
    engine._commit_verify = recording_commit
    return ticks, margins, deciding


def flip_gaps(flips, rids, card_rows, cpu_rows):
    """Add to each flip the largest card-against-CPU difference of the
    scores or logits that decided its token (summation-order noise is
    ~1e-6; a top-k swap in the sparse FFN moves them much more)."""
    for f in flips:
        key = (rids[f["request"]], f["step"])
        f["logit_gap"] = float(np.abs(card_rows[key] - cpu_rows[key]).max())
    return flips


def timed_drafting(engine):
    """Accumulate the wall time of the engine's drafting calls (each ends
    with the draft logits on the host, so the device work is in it);
    returns the dict whose "s" holds it."""
    acc = {"s": 0.0}
    propose = engine._propose

    def timed(items):
        t0 = time.perf_counter()
        try:
            return propose(items)
        finally:
            acc["s"] += time.perf_counter() - t0
    engine._propose = timed
    return acc


# ---------------------------------------------------------------------------
# phase 16: observability


def kernel_ms(averages):
    """The CUDA kernel time (ms) in a profiler window: every device event
    but the memory copies and sets."""
    return sum(e.self_device_time_total for e in device_events(averages)
               if not e.key.startswith(("Memcpy", "Memset"))) / 1e3


def obs_phase(cfg, params, scfg, dev, prompts, max_new, ref_tokens,
              ref_margins, ref_rids, heavy, heavy_new, heavy_tokens,
              heavy_margins, heavy_rids, heavy_wall_per_tick):
    """Phase 16; returns (its details, the launches of its serves)."""
    import importlib.util
    import tempfile
    import urllib.request
    from repro_torch.configs.base import AsyncConfig, ObsConfig
    from repro_torch.obs import (attainment_table, start_metrics_server,
                                 write_jsonl, write_perfetto)
    from repro_torch.roofline import hw
    from repro_torch.serve.engine import Engine
    spec = importlib.util.spec_from_file_location(
        "check_trace", ROOT / "tools" / "check_trace.py")
    check_trace = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(check_trace)
    out, launches = {}, dict.fromkeys(KERNELS, 0)

    def add(counts):
        for key in KERNELS:
            launches[key] += counts[key]

    # (a) the traced, profiled paged serve
    psc = dataclasses.replace(scfg, obs=ObsConfig(enabled=True,
                                                  profile=True))
    eng = Engine(cfg, params, psc, device=dev)
    check(eng.profiler.chip is hw.H100_SXM,
          f"obs: the profiler judges against {eng.profiler.chip.name}")
    toks, _, wall, summary, lnch = serve(eng, prompts, max_new)
    add(lnch)
    steps = eng.runner.n_steps
    for key in ("paged_attention", "sparse_gather_matvec"):
        check(lnch[key] == cfg.n_layers * steps > 0,
              f"obs: {key} launched {lnch[key]} times in {steps} steps")
    flips = compare_cpu("obs vs paged", toks, ref_tokens, ref_margins,
                        ref_rids)
    print_serve("obs profiled", len(prompts), summary, wall, steps, lnch)
    print(f"obs: against the phase-15 sync serve "
          f"{len(prompts) - len(flips)}/{len(prompts)} requests "
          f"token-identical, near-tie flips {flips}")
    # (b) attainment against the H100 SXM entry
    rows = summary["bucket_attainment"]
    print(attainment_table(rows))
    check(rows, "obs: the profiler reports no bucket")
    for r in rows:
        check(r["attain"] is not None and 0.0 < r["attain"] <= 1.0,
              f"obs: bucket {r['bucket']} attain {r['attain']} "
              f"(raw {r['attain_raw']})")
        print(f"obs: bucket {r['bucket']}: {r['ticks']} ticks, device ms "
              f"{r['dev_ms']:.4f} a tick, {r['flops']:.0f} flops and "
              f"{r['hbm_bytes']:.0f} bytes a tick at {r['n_keys']:.1f} "
              f"live keys, attain {r['attain']:.6f}, attain_raw "
              f"{r['attain_raw']:.6f}, bound by {r['bound']}")
    ticks = eng.tracer.tick_summary()
    print(f"obs: ticks {ticks}; phase ms per tick "
          f"{eng.tracer.phase_ms_per_tick()}")
    out["profiled"] = dict(summary, wall_s=wall, launches=lnch,
                           flips=flips)
    # (c) the traces, through tools/check_trace.py
    with tempfile.TemporaryDirectory() as tmp:
        trace = write_perfetto(eng.tracer, f"{tmp}/obs.trace.json",
                               registry=eng.metrics.registry,
                               profiler=eng.profiler)
        events = write_jsonl(eng.tracer, f"{tmp}/obs.events.jsonl")
        errs = check_trace.check_perfetto(
            trace, expect_counters=("achieved_gflops", "achieved_gbs",
                                    "roofline_attainment")) \
            + check_trace.check_jsonl(events, expect_ordering=True)
        check(not errs, f"obs: check_trace: {errs}")
        sizes = [Path(trace).stat().st_size, Path(events).stat().st_size]
    print(f"obs: Perfetto and JSONL traces ({sizes[0]} and {sizes[1]} "
          f"bytes, {len(eng.tracer.spans)} spans, "
          f"{len(eng.tracer.events)} events, {eng.tracer.dropped} dropped)"
          f" pass tools/check_trace.py")
    # (g) one scrape of the metrics endpoint (the profiled engine's)
    srv = start_metrics_server(lambda: eng.metrics.registry, 0)
    try:
        port = srv.server_address[1]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=10) as r:
            body = r.read().decode()
    finally:
        srv.shutdown()
        srv.server_close()
    line = next((ln for ln in body.splitlines() if ln.startswith(
        'bucket_attainment_attainment{bucket="decode"}')), None)
    check(line is not None, "obs: the scrape has no decode attainment")
    print(f"obs: scraped 127.0.0.1:{port}/metrics ({len(body)} bytes): "
          f"{line}")
    out["scrape"] = {"bytes": len(body), "decode_attainment": line}
    # (d) the tracer's device time against torch.profiler's kernel time
    tsc = dataclasses.replace(scfg, obs=ObsConfig(enabled=True))
    made = []

    def traced_engine():
        made[:] = [Engine(cfg, params, tsc, device=dev)]
        return made[0]
    (ptoks, _, _, _, plnch), averages = profiled(
        lambda e: serve(e, prompts, max_new), None, traced_engine)
    check(ptoks == toks, "obs: the traced serve under the profiler gave "
          "other tokens")
    add(plnch)
    tracer_ms = sum(t["device_ms"] for t in made[0].tracer.tick_stats)
    if averages is None:
        print("obs: the profiler was blind; the tracer's device time "
              f"{tracer_ms:.3f} ms, the kernel time not measured")
        out["tracer_vs_profiler"] = {"tracer_ms": tracer_ms,
                                     "kernel_ms": None}
    else:
        kms = kernel_ms(averages)
        check(tracer_ms >= 0.95 * kms,
              f"obs: the tracer's device time {tracer_ms} ms < 0.95 of "
              f"the profiler's kernel time {kms} ms")
        print(f"obs: one traced serve under torch.profiler: the ticks' "
              f"device_ms sum to {tracer_ms:.3f} ms, the profiler's CUDA "
              f"kernel time {kms:.3f} ms, ratio {tracer_ms / kms:.3f}")
        out["tracer_vs_profiler"] = {"tracer_ms": tracer_ms,
                                     "kernel_ms": kms,
                                     "ratio": tracer_ms / kms}
    # (e) the decode-heavy traffic at K = 8, traced
    hsc = dataclasses.replace(
        scfg, obs=ObsConfig(enabled=True),
        async_cfg=AsyncConfig(enabled=True, max_device_ticks=8))
    heng = Engine(cfg, params, hsc, device=dev)
    htoks, _, hwall, hsummary, hlnch = serve(heng, heavy, heavy_new)
    add(hlnch)
    hflips = compare_cpu("obs heavy K8 vs sync", htoks, heavy_tokens,
                         heavy_margins, heavy_rids)
    hticks = heng.tracer.tick_summary()
    print(f"obs heavy K8: {len(heavy) - len(hflips)}/{len(heavy)} "
          f"requests token-identical to the sync serve, near-tie flips "
          f"{hflips}; device_ms_per_tick {hticks['device_ms_per_tick']:.4f}"
          f" and host_ms_per_tick {hticks['host_ms_per_tick']:.4f} over "
          f"{hticks['n_device_ticks']} device ticks ({hticks['n_ticks']} "
          f"ticks), against phase 15's wall per device tick "
          f"{heavy_wall_per_tick:.4f} ms; this serve's "
          f"{1e3 * hwall / heng.device_ticks:.4f} ms")
    out["heavy_K8"] = dict(hsummary, wall_s=hwall, flips=hflips,
                           wall_per_device_tick_ms=1e3 * hwall
                           / heng.device_ticks,
                           phase15_wall_per_device_tick_ms=(
                               heavy_wall_per_tick))
    # (f) the phase-5 prompts with tracing off and on
    walls = {}
    for label, sc in (("off", scfg), ("on", tsc)):
        e = Engine(cfg, params, sc, device=dev)
        t, _, w, _, lnch_ = serve(e, prompts, max_new)
        check(t == toks, f"obs: the serve with tracing {label} gave "
              f"other tokens")
        add(lnch_)
        walls[label] = w
    print(f"obs: the phase-5 prompts with tracing off {walls['off']:.4f} s,"
          f" on {walls['on']:.4f} s of wall (ratio "
          f"{walls['on'] / walls['off']:.4f})")
    out["walls"] = walls
    return out, launches


# ---------------------------------------------------------------------------
# phase 15: the async engine


def heavy_prompts(cfg):
    """The decode-heavy traffic: 8 prompts of 16-64 tokens, one admission
    wave at max_batch 8, so every tick after the prefills is decode only."""
    hrng = np.random.default_rng(SEED + 8)
    return [hrng.integers(0, cfg.vocab, int(n), dtype=np.int32)
            for n in hrng.integers(16, 65, 8)]


def async_record(label, cfg, engine, n, summary, wall, launches):
    """Check and print one serve of the paged engine, sync or async: kernels
    1 and 2 launch once per layer per device tick by the graph-aware
    counters (an eager step's launches, and each graph replay's; these
    serves have no stops, so every replay is a device tick); print
    tokens/s, TTFT and TPOT, wall per device tick, async_stats, graph
    captures and replays and the launches per device tick. Returns the
    serve's record."""
    r = engine.runner
    ticks = engine.device_ticks
    over = engine.async_stats()["overlap_ticks"] \
        if engine._async is not None else 0
    ran = r.n_steps - over + r.graph_replays
    for key in ("paged_attention", "sparse_gather_matvec"):
        check(launches[key] == cfg.n_layers * ticks == cfg.n_layers * ran,
              f"{label}: {key} launched {launches[key]} times in {ticks} "
              f"device ticks ({r.n_steps} runner steps, {r.graph_replays} "
              f"graph replays), expected {cfg.n_layers} a device tick")
    per_tick = {key: launches[key] / ticks
                for key in ("paged_attention", "sparse_gather_matvec")}
    rec = dict(summary, wall_s=wall, device_ticks=ticks,
               wall_per_device_tick_ms=1e3 * wall / ticks,
               launches=launches, launches_per_device_tick=per_tick,
               graph_captures=r.graph_captures,
               graph_replays=r.graph_replays)
    if engine._async is not None:
        rec["async"] = engine.async_stats()
    print_serve(label, n, summary, wall, ticks, launches)
    print(f"{label}: wall per device tick "
          f"{rec['wall_per_device_tick_ms']:.3f} ms; async_stats "
          f"{rec.get('async', '-')}; graph captures {r.graph_captures}, "
          f"replays {r.graph_replays}; kernel 1 / 2 launches per device "
          f"tick {per_tick['paged_attention']:.2f} / "
          f"{per_tick['sparse_gather_matvec']:.2f}")
    return rec


def sync_free_ticks(cfg, params, sc, dev, prompts, max_new):
    """Serve ``prompts`` through an async engine and run every tick after
    the prefills (everything between one reconcile and the next: host
    bookkeeping, staging, graph replays, the queued copies back) under
    torch.cuda.set_sync_debug_mode("error"): a device-to-host sync there
    raises. The designed waits, one CUDA event a reconcile or a burst, do
    not synchronize the stream. Returns the ticks so run and the engine's
    async_stats."""
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.scheduler import Request
    engine = Engine(cfg, params, sc, device=dev)
    reqs = [Request(rid=engine.new_rid(), prompt=p, max_new=max_new)
            for p in prompts]
    for req in reqs:
        check(engine.add_request(req), "sync-free: a request was refused")
    while not (engine.sched.decode_only()
               and all(req.tokens_out for req in reqs)):
        engine.step()
    before = dict(engine.async_stats())
    ticks = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        while engine._busy():
            engine.step()
            ticks += 1
        engine.step()               # reconciles the last, overrun tick
        ticks += 1
    except RuntimeError as exc:
        raise Failure(f"sync-free: an async tick synchronized: {exc}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(all(len(req.tokens_out) == max_new for req in reqs),
          "sync-free: a request did not finish")
    after = engine.async_stats()
    check(after["overlap_ticks"] + after["loop_bursts"]
          > before["overlap_ticks"] + before["loop_bursts"],
          "sync-free: no async tick ran under the debug mode")
    return ticks, after


class CallSites(torch.overrides.TorchFunctionMode):
    """Wraps each matmul the port calls in a profiler range named after
    the port's source line that called it ("site attention.py:62 ...")."""

    MATMULS = (torch.Tensor.__matmul__, torch.Tensor.matmul, torch.matmul)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func not in self.MATMULS:
            return func(*args, **kwargs)
        import traceback
        site = next((f"{Path(f.filename).name}:{f.lineno} {f.line}"
                     for f in reversed(traceback.extract_stack()[:-1])
                     if "repro_torch" in f.filename), "?")
        with torch.profiler.record_function(f"site {site}"):
            return func(*args, **kwargs)


def gemm_shapes(engine, prompts, max_new):
    """One torch.profiler window with record_shapes over a serve, each
    matmul in a range named after its calling line (``CallSites``): every
    GEMM kernel it ran, grouped by kernel, launching op, input shapes and
    calling line, most device time first (kernel, op, shapes, site,
    calls, device ms per call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof, CallSites():
        serve(engine, prompts, max_new)
        torch.cuda.synchronize()
    rows = {}
    for e in prof.events():
        if e.device_type != DeviceType.CPU:
            continue
        for k in getattr(e, "kernels", []):
            if "gemm" not in k.name.lower():
                continue
            site, up = "?", e
            while up is not None:
                if up.name.startswith("site "):
                    site = up.name[5:]
                    break
                up = up.cpu_parent
            key = (k.name, e.name, str(e.input_shapes), site)
            r = rows.setdefault(key, [0, 0.0])
            r[0] += 1
            r[1] += k.duration
    out = [[*key, n, us / n / 1e3] for key, (n, us) in rows.items()]
    return sorted(out, key=lambda r: -r[4] * r[5])


def verify_against_sequential(cfg, params, dev, n_tok, bs=16):
    """Max abs difference between one VERIFY row of ``n_tok`` tokens
    (kernel 1 at S = n_tok, kernel 2 over its rows) and the same tokens
    fed one DECODE row at a time, after a 13-token prompt."""
    from repro_torch.models import Model
    model = Model(cfg)
    rng = np.random.default_rng(SEED + 6)
    prompt = rng.integers(0, cfg.vocab, 13, dtype=np.int32)
    toks = rng.integers(0, cfg.vocab, n_tok, dtype=np.int32)
    MB = 8
    P = len(prompt)
    t = lambda a: torch.tensor(a, device=dev)  # noqa: E731

    def fresh():
        c = model.init_paged_cache(1, MB, bs, MB, device=dev)
        c["block_tables"] = torch.arange(MB, dtype=torch.int32,
                                         device=dev)[None]
        c["lens"] = t(np.zeros(1, np.int32))
        model.forward_step(params, t(np.pad(prompt, (0, 32 - P))[None]), c,
                           t(np.array([P], np.int32)),
                           t(np.ones(1, bool)), bs, backend="flash")
        return c

    def step(c, x, lens):
        c["lens"] = t(np.array([lens], np.int32))
        return model.forward_step(
            params, t(np.asarray(x, np.int32)[None]), c,
            t(np.array([len(x)], np.int32)), t(np.zeros(1, bool)), bs,
            backend="flash", has_prefill=False)[0].cpu().numpy()

    with torch.no_grad():
        verify = step(fresh(), toks, P)
        c = fresh()
        seq = np.stack([step(c, [x], P + i)[0] for i, x in enumerate(toks)])
    return float(np.abs(verify - seq).max())


# ---------------------------------------------------------------------------
# phase 17: disagg and the fleet


def engine_launches(coord):
    """Per-engine launch counts of a disagg coordinator: each engine's step
    adds the change of ops.LAUNCHES across it to the engine's own dict
    (the handoff's block copies launch no port kernel). Returns
    {"prefill": {...}, "decode": {...}}."""
    from repro_torch.kernels import ops
    per = {}
    for role in ("prefill", "decode"):
        eng = getattr(coord, role)
        counts = per[role] = dict.fromkeys(KERNELS, 0)

        def step(inner=eng.step, counts=counts):
            before = dict(ops.LAUNCHES)
            try:
                return inner()
            finally:
                for key in KERNELS:
                    counts[key] += ops.LAUNCHES[key] - before[key]
        eng.step = step
    return per


def record_handoffs(coord, label, compare=False):
    """Record each adopted handoff's block count and the host seconds of
    the coordinator's handoff passes; with ``compare``, check right after
    each copy, before the prefill engine releases its blocks, that every
    leaf's imported rows equal the exported rows bit for bit (int8
    payloads and scales). Returns (block counts, blocks checked, host
    seconds per pass)."""
    sizes, checked, passes = [], [], []
    dec = coord.decode
    adopt, transfer = dec.adopt_handoff, coord._transfer_ready

    def adopt_handoff(packet, src_runner):
        ok = adopt(packet, src_runner)
        if ok:
            sizes.append(len(packet.blocks))
        if ok and compare:
            dst = dec.pool.export_blocks(dec.sched.active[packet.req.rid].slot)
            src = src_runner.cache["units"]["b0"]
            for name, leaf in dec.runner.cache["units"]["b0"].items():
                check(torch.equal(leaf[:, dst], src[name][:, packet.blocks]),
                      f"{label}: request {packet.req.rid}'s imported {name} "
                      f"rows differ from the exported ones")
            checked.append(len(dst))
        return ok

    def transfer_ready():
        t0 = time.perf_counter()
        transfer()
        passes.append(time.perf_counter() - t0)
    dec.adopt_handoff = adopt_handoff
    coord._transfer_ready = transfer_ready
    return sizes, checked, passes


def recording_coordinator(coord):
    """recording_engine on both engines of a coordinator: the prefill
    engine samples each request's first token, the decode engine the rest.
    Returns (the score vectors of every tick, the margins)."""
    pre_ticks, _, pre_margins = recording_engine(coord.prefill)
    dec_ticks, _, dec_margins = recording_engine(coord.decode)
    return pre_ticks + dec_ticks, {**pre_margins, **dec_margins}


def check_engine_launches(label, cfg, coord, per, attention=True):
    """Kernels 1 and 2 on each engine, once per layer per device tick
    (graph replays counted), kernel 1 only where the read is flash. The
    prefill engine launches kernel 2 too: a step with prefill rows
    computes both down-projections from one hidden activation and keeps
    the dense one for prefill rows (``models/ffn.py`` ``ffn_step``, as
    the reference's jitted step does), so its sparse gather runs for rows
    that discard it."""
    ticks = {"prefill": coord.prefill.device_ticks,
             "decode": coord.decode.device_ticks}
    for role, n in ticks.items():
        check(n > 0, f"{label}: the {role} engine ran no step")
        for key, on in (("paged_attention", attention),
                        ("sparse_gather_matvec", True)):
            want = cfg.n_layers * n if on else 0
            check(per[role][key] == want,
                  f"{label}: the {role} engine launched {key} "
                  f"{per[role][key]} times in {n} device ticks, expected "
                  f"{want}")


def fleet_serve(router, prompts, max_new, after_submit=None):
    """The fleet's traffic: one request arrives per router poll, then the
    fleet drains; ``after_submit(router)`` runs after the last arrival.
    Launch counts are set to 0 just before and read just after. Returns
    (tokens, rids, wall, fleet_summary, launches)."""
    from repro_torch.kernels import ops
    for key in ops.LAUNCHES:
        ops.LAUNCHES[key] = 0
    t0 = time.perf_counter()
    rids = []
    for p in prompts:
        rids.append(router.submit(p, max_new=max_new))
        router.poll()
    if after_submit is not None:
        after_submit(router)
    done = router.drain_all()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return ([list(done[r].tokens_out) for r in rids], rids, wall,
            router.fleet_summary(), dict(ops.LAUNCHES))


def fleet_record(label, cfg, router, tokens, max_new, wall, summary,
                 launches):
    """Check and print one fleet serve: valid tokens, kernels 1 and 2 once
    per layer per device tick of every replica; prints tokens/s, TTFT, the
    pooled prefix hit rate and the router's decisions per replica and
    reason. Returns its record."""
    reps = list(router.fleet.live()) + list(router.fleet.stopped.values())
    ticks = sum(rep.engine.device_ticks for rep in reps)
    for key in ("paged_attention", "sparse_gather_matvec"):
        check(launches[key] == cfg.n_layers * ticks > 0,
              f"{label}: {key} launched {launches[key]} times in {ticks} "
              f"device ticks of the replicas")
    check_tokens(label, tokens, cfg, max_new, [])
    decisions = {}
    for d in router.decisions:
        key = f"{d.replica}:{d.reason}"
        decisions[key] = decisions.get(key, 0) + 1
    rec = {"wall_s": wall, "tokens_per_s": summary["tokens_per_s"],
           "ttft_p50_ms": summary["ttft_p50_ms"],
           "ttft_p99_ms": summary["ttft_p99_ms"],
           "tpot_p50_ms": summary["tpot_p50_ms"],
           "prefix_lookups": summary["prefix_lookups"],
           "prefix_hits": summary["prefix_hits"],
           "prefix_hit_rate": summary["prefix_hit_rate"],
           "decisions": decisions, "router": summary["router"],
           "device_ticks": ticks, "launches": launches,
           "graph_replays": sum(rep.engine.runner.graph_replays
                                for rep in reps)}
    print(f"{label}: {len(tokens)} requests, {summary['generated_tokens']} "
          f"tokens in {wall:.3f} s ({summary['tokens_per_s']:.1f} tok/s), "
          f"TTFT p50 {summary['ttft_p50_ms']:.2f} ms p99 "
          f"{summary['ttft_p99_ms']:.2f} ms, TPOT p50 "
          f"{summary['tpot_p50_ms']:.3f} ms; prefix hits "
          f"{summary['prefix_hits']}/{summary['prefix_lookups']} "
          f"({summary['prefix_hit_rate']:.4f}); decisions (replica:reason) "
          f"{decisions}; {ticks} device ticks, {rec['graph_replays']} graph "
          f"replays, launches {launches}")
    return rec


def disagg_phase(cfg, params, scfg, q8_scfg, dev, prompts, max_new,
                 paged, q8_tokens, sync_summary, prefix_prompts, prefix):
    """Phase 17. ``paged``: phase 5's (tokens, margins, rids); ``prefix``:
    phase 9's cache-on serve's (tokens, margins, rids). Returns (its
    details, the launches of its serves, the disagg serve's
    (tokens, launches, wall) for phase 13)."""
    from repro_torch.configs.base import AsyncConfig
    from repro_torch.serve.disagg import DisaggCoordinator
    from repro_torch.serve.router import build_fleet
    out, launches = {}, dict.fromkeys(KERNELS, 0)

    def add(counts):
        for key in KERNELS:
            launches[key] += counts[key]

    # (a) the phase-5 prompts through a DisaggCoordinator
    coord = DisaggCoordinator(cfg, params, scfg, device=dev)
    # the bytes a token's KV takes in the pools, every leaf of every layer
    per_tok = sum(leaf[:, :1].nbytes for leaf in
                  coord.decode.runner.cache["units"]["b0"].values()) \
        / scfg.block_size
    per = engine_launches(coord)
    sizes, _, passes = record_handoffs(coord, "disagg")
    ticks, margins = recording_coordinator(coord)
    toks, rids, wall, summary, lnch = serve(coord, prompts, max_new)
    add(lnch)
    check_tokens("disagg", toks, cfg, max_new, ticks)
    check_engine_launches("disagg", cfg, coord, per)
    check(summary["n_handoffs"] == len(prompts) == len(sizes)
          and summary["handoff_blocks"] == sum(sizes)
          and summary["evictions"] == 0,
          f"disagg: {summary['n_handoffs']} handoffs of "
          f"{summary['handoff_blocks']} blocks, {summary['evictions']} "
          f"evictions, for {len(prompts)} requests")
    paged_flips = compare_cpu("disagg vs paged", toks, *paged)
    cpu = DisaggCoordinator(cfg, params, scfg, device="cpu")
    _, cpu_margins = recording_coordinator(cpu)
    cpu_toks, cpu_rids, _, cpu_summary, _ = serve(cpu, prompts, max_new)
    cpu_flips = compare_cpu("disagg-cpu", toks, cpu_toks, cpu_margins,
                            cpu_rids)
    check((cpu_summary["n_handoffs"], cpu_summary["handoff_blocks"])
          == (summary["n_handoffs"], summary["handoff_blocks"]),
          "disagg-cpu: the CPU run's handoffs differ from the card's")
    moved = summary["handoff_blocks"] * scfg.block_size * per_tok
    # the handoff copy's device time at the serve's largest handoff, into
    # the idle pools after the serve
    n = max(sizes)
    ids = list(range(n))

    def copy():
        coord.decode.runner.import_blocks_from(coord.prefill.runner, ids,
                                               ids)
    copy_bytes = n * scfg.block_size * per_tok
    handoff = {"n_handoffs": summary["n_handoffs"],
               "handoff_blocks": summary["handoff_blocks"],
               "bytes_moved": moved, "largest_blocks": n,
               "largest_bytes": copy_bytes,
               "copy_device_ms": library_device_ms(copy),
               "copy_ms": time_ms(copy),
               "copy_bound_ms": bound(2 * copy_bytes, 0)[0],
               "host_ms_per_handoff": 1e3 * sum(passes)
               / summary["n_handoffs"]}
    ratio = summary["tokens_per_s"] / sync_summary["tokens_per_s"]
    split = {k: summary[k] for k in (
        "tpot_p50_prefill_overlap_ms", "tpot_p99_prefill_overlap_ms",
        "tpot_p50_steady_ms", "tpot_p99_steady_ms", "tpot_overlap_samples",
        "tpot_steady_samples")}
    print_serve("disagg", len(prompts), summary, wall,
                f"{coord.prefill.runner.n_steps} prefill + "
                f"{coord.decode.runner.n_steps} decode", lnch)
    print(f"disagg: launches by engine {per}; {handoff['n_handoffs']} "
          f"handoffs of {handoff['handoff_blocks']} blocks, "
          f"{moved:.0f} bytes moved ({per_tok:.0f} B a token); the largest "
          f"({n} blocks, {copy_bytes:.0f} B) copies in "
          f"{handoff['copy_device_ms']} device ms "
          f"({handoff['copy_ms']:.5f} ms by events, bound "
          f"{handoff['copy_bound_ms']:.6f} ms); host "
          f"{handoff['host_ms_per_handoff']:.4f} ms a handoff in the "
          f"coordinator's handoff passes")
    print(f"disagg: {ratio:.3f}x the phase-15 sync paged serve's tokens/s; "
          f"interference split {split} (the single engine's: "
          + str({k: sync_summary[k] for k in split}) + ")")
    print(f"disagg: against the paged serve "
          f"{len(prompts) - len(paged_flips)}/{len(prompts)} requests "
          f"token-identical, near-tie flips {paged_flips}; against its CPU "
          f"run {len(prompts) - len(cpu_flips)}/{len(prompts)}, near-tie "
          f"flips {cpu_flips}")
    out["disagg"] = dict(summary, wall_s=wall, launches=lnch,
                         engine_launches=per, handoff=handoff,
                         tokens_per_s_ratio=ratio, paged_flips=paged_flips,
                         cpu_flips=cpu_flips)
    out["disagg"].pop("prefill_engine", None)

    # (b) int8 KV pools: imported rows bit-equal to the exported rows
    q8 = DisaggCoordinator(cfg, params, q8_scfg, device=dev)
    per8 = engine_launches(q8)
    sizes8, checked8, _ = record_handoffs(q8, "disagg int8kv", compare=True)
    _, margins8 = recording_coordinator(q8)
    toks8, rids8, wall8, summary8, lnch8 = serve(q8, prompts, max_new)
    add(lnch8)
    check(checked8 == sizes8 and len(sizes8) == len(prompts),
          f"disagg int8kv: {len(checked8)} of {len(sizes8)} handoffs "
          f"compared")
    check_engine_launches("disagg int8kv", cfg, q8, per8, attention=False)
    q8_flips = compare_cpu("disagg int8kv vs int8kv", q8_tokens, toks8,
                           margins8, rids8)
    print(f"disagg int8kv: {len(checked8)} handoffs of {sum(checked8)} "
          f"blocks, every leaf (int8 k, v and their f32 scales) bit-equal "
          f"after the copy; against the phase-11 int8kv serve "
          f"{len(prompts) - len(q8_flips)}/{len(prompts)} requests "
          f"token-identical, near-tie flips {q8_flips}; launches by engine "
          f"{per8}")
    out["int8kv"] = {"handoffs": len(checked8), "blocks": sum(checked8),
                     "wall_s": wall8, "launches": lnch8,
                     "engine_launches": per8, "flips": q8_flips}

    # (c) an async decode engine (K = 8): replays read the imported blocks
    asc = dataclasses.replace(scfg, async_cfg=AsyncConfig(
        enabled=True, max_device_ticks=8))
    ac = DisaggCoordinator(cfg, params, asc, device=dev)
    pools = ac.decode.runner.cache["units"]["b0"]
    ptrs = {k: v.data_ptr() for k, v in pools.items()}
    per_a = engine_launches(ac)
    toks_a, _, wall_a, summary_a, lnch_a = serve(ac, prompts, max_new)
    add(lnch_a)
    check_tokens("disagg async", toks_a, cfg, max_new, [])
    check_engine_launches("disagg async", cfg, ac, per_a)
    replays = ac.decode.runner.graph_replays
    check(replays > 0 and {k: v.data_ptr() for k, v in pools.items()}
          == ptrs, f"disagg async: {replays} graph replays; the decode "
          f"pools must stay where the graphs captured them")
    async_flips = compare_cpu("disagg async vs disagg", toks_a, toks,
                              margins, rids)
    print_serve("disagg async K8", len(prompts), summary_a, wall_a,
                ac.decode.device_ticks, lnch_a)
    print(f"disagg async K8: decode engine {ac.decode.async_stats()}, "
          f"{replays} graph replays over the imported blocks (pools in "
          f"place); against the sync disagg serve "
          f"{len(prompts) - len(async_flips)}/{len(prompts)} requests "
          f"token-identical, near-tie flips {async_flips}; "
          f"{summary_a['tokens_per_s'] / summary['tokens_per_s']:.3f}x its "
          f"tokens/s")
    out["async"] = dict(summary_a, wall_s=wall_a, launches=lnch_a,
                        engine_launches=per_a, flips=async_flips,
                        graph_replays=replays,
                        decode_async=ac.decode.async_stats())
    out["async"].pop("prefill_engine", None)

    # (d) two replicas, the phase-9 traffic: affinity, then round robin
    psc = dataclasses.replace(scfg, prefix_cache=True)
    out["fleet"] = {}
    fleet_tokens = {}
    fleet_margins = {}
    for policy in ("affinity", "round_robin"):
        router = build_fleet(cfg, params, psc, n_replicas=2, policy=policy,
                             device=dev)
        for rep in router.fleet.live():
            fleet_margins.setdefault(policy, {}).update(
                recording_engine(rep.engine)[2])
        ftoks, frids, fwall, fsum, flnch = fleet_serve(
            router, prefix_prompts, max_new)
        add(flnch)
        rec = fleet_record(f"fleet {policy}", cfg, router, ftoks, max_new,
                           fwall, fsum, flnch)
        flips = compare_cpu(f"fleet {policy} vs prefix", ftoks, *prefix)
        print(f"fleet {policy}: against the phase-9 single engine "
              f"{len(ftoks) - len(flips)}/{len(ftoks)} requests "
              f"token-identical, near-tie flips {flips}")
        rec["flips"] = flips
        out["fleet"][policy] = rec
        fleet_tokens[policy] = (ftoks, frids)
    # async replicas (K = 8), polled serially and from a thread pool
    apsc = dataclasses.replace(psc, async_cfg=AsyncConfig(
        enabled=True, max_device_ticks=8))
    par = {}
    for parallel in (False, True):
        label = f"fleet async K8 {'parallel' if parallel else 'serial'}"
        router = build_fleet(cfg, params, apsc, n_replicas=2,
                             policy="affinity", parallel=parallel,
                             device=dev)
        ftoks, _, fwall, fsum, flnch = fleet_serve(router, prefix_prompts,
                                                   max_new)
        add(flnch)
        rec = fleet_record(label, cfg, router, ftoks, max_new, fwall, fsum,
                           flnch)
        check(rec["graph_replays"] > 0, f"{label}: no graph replay")
        par[parallel] = (ftoks, flnch, [(d.rid, d.replica, d.reason)
                                        for d in router.decisions])
        out["fleet"][label] = rec
    check(par[True] == par[False],
          "fleet: parallel polling changed the async replicas' tokens, "
          "launches or decisions")
    aff_toks, aff_rids = fleet_tokens["affinity"]
    async_fleet_flips = compare_cpu("fleet async vs affinity", par[False][0],
                                    aff_toks, fleet_margins["affinity"],
                                    aff_rids)
    print(f"fleet async K8: parallel polling gave the serial run's tokens, "
          f"launches and decisions; against the sync affinity fleet "
          f"{len(aff_toks) - len(async_fleet_flips)}/{len(aff_toks)} "
          f"requests token-identical, near-tie flips {async_fleet_flips}")
    out["fleet"]["async_flips"] = async_fleet_flips

    # (e) scale-down: the round-robin traffic again, replica 1 drained
    # after the last arrival and reaped once idle
    router = build_fleet(cfg, params, psc, n_replicas=2,
                         policy="round_robin", device=dev)
    seen = {}

    def scale_down(r):
        seen["victims"] = r.fleet.scale_down(1)
        seen["in_flight"] = r.fleet.get(1).queue_depth
        seen["placed"] = [rid for rid, rep in r._placement.items()
                          if rep == 1]
    stoks, srids, swall, ssum, slnch = fleet_serve(router, prefix_prompts,
                                                   max_new, scale_down)
    add(slnch)
    rr_toks, rr_rids = fleet_tokens["round_robin"]
    check(seen["victims"] == [1] and seen["in_flight"] > 0
          and sorted(router.fleet.replicas) == [0]
          and sorted(router.fleet.stopped) == [1],
          f"scale-down: victims {seen['victims']}, {seen['in_flight']} in "
          f"flight, live {sorted(router.fleet.replicas)}, stopped "
          f"{sorted(router.fleet.stopped)}")
    check(stoks == rr_toks and srids == rr_rids,
          "scale-down: the drained replica's requests changed tokens")
    print(f"scale-down: replica 1 drained with {seen['in_flight']} requests "
          f"in flight ({len(seen['placed'])} placed there), reaped once "
          f"idle; every request's tokens equal the round-robin fleet's; "
          f"{ssum['n_finished']} finished, {ssum['n_replicas']} collectors")
    out["scale_down"] = {"victims": seen["victims"],
                         "in_flight": seen["in_flight"],
                         "placed": len(seen["placed"]), "wall_s": swall,
                         "launches": slnch}
    return out, launches, (toks, lnch, wall)



# ---------------------------------------------------------------------------
# phase 18: the recurrent families through the slot engine


def tree_map(fn, tree):
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def tree_leaves(tree):
    return [x for v in tree.values()
            for x in (tree_leaves(v) if isinstance(v, dict) else [v])]


def bf16_error(cfg, params, prompts):
    """The bf16 error of ``cfg`` measured on the CPU: the largest |logit -
    f32 logit| of the port's bf16 forward against the f32 forward of the
    same bf16-rounded weights (``params``, on the CPU), over every
    position of ``prompts``; for an MoE config the f32 forward takes the
    bf16 forward's expert choices (``replay_routing``), and where its own
    would differ they must be near-ties. Returns (the error, the
    replayed routing's ties)."""
    from repro_torch.models import transformer
    f32_cfg = dataclasses.replace(cfg, dtype="float32")
    f32_params = tree_map(lambda t: t.float(), params)
    worst, ties = 0.0, {"ties": [], "dsq": 0.0, "n": 0}
    with torch.no_grad():
        for p in prompts:
            tok = torch.tensor(p[None])
            ROUTE_SINK.append([])
            try:
                bf = transformer.project_logits(
                    params, cfg, transformer.forward(params, cfg, tok)[0])
            finally:
                calls = ROUTE_SINK.pop()
            with replay_routing(calls) as rep:
                f32 = transformer.project_logits(
                    f32_params, f32_cfg,
                    transformer.forward(f32_params, f32_cfg, tok)[0])
            for key in ("ties", "dsq", "n"):
                ties[key] += rep[key]
            worst = max(worst, float((bf - f32).abs().max()))
    return worst, ties


def timed_prefills(engine):
    """The slot engine's prefills, each timed to its end on the card (ms
    per prefill)."""
    acc = []
    prefill = engine.model.prefill

    def timed(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = prefill(*args)
        torch.cuda.synchronize()
        acc.append(1e3 * (time.perf_counter() - t0))
        return out
    engine.model.prefill = timed
    return acc


def faulty_state(engine, fault):
    """A control fault in the slot engine's decode step, on every
    recurrent block's state: "bf16" rounds the f32 state to bf16 after
    each step (the reference keeps it in f32 in a bf16 config); "stale"
    keeps the first decode step from advancing it (a lost write)."""
    from repro_torch.models import transformer
    step = engine.model.decode_step
    kinds = engine.cfg.pattern_unit()
    calls = [0]

    def state(cache):
        return [leaf for j, kind in enumerate(kinds)
                if kind not in transformer.ATTN_KINDS
                for leaf in cache["units"][f"b{j}"].values()]

    def faulty_step(params, tok, cache):
        before = [t.clone() for t in state(cache)]
        logits, cache = step(params, tok, cache)
        for new, old in zip(state(cache), before):
            if fault == "stale" and calls[0] == 0:
                new.copy_(old)
            elif fault == "bf16" and new.dtype == torch.float32:
                new.copy_(new.bfloat16().float())
        calls[0] += 1
        return logits, cache
    engine.model.decode_step = faulty_step


def forced_scores(engine, prompts, max_new, tokens, replay=None):
    """Serve ``prompts`` on ``engine`` teacher-forced through ``tokens``:
    {(request, index): the score vector behind token index}, the CPU-side
    top-2 margins keyed the same way, and the serve's seconds; with
    ``replay`` (another serve's MoE calls) the serve also takes its expert
    choices, and the replay's ties come last."""
    scores = {}
    _, _, margins = recording_engine(engine, scores)
    t0 = time.perf_counter()
    if replay is None:
        got, rids, _, _, _ = serve(engine, prompts, max_new, forced=tokens)
    else:
        with replay_routing(replay) as rep:
            got, rids, _, _, _ = serve(engine, prompts, max_new,
                                       forced=tokens)
    secs = time.perf_counter() - t0
    check(got == tokens, "a teacher-forced serve did not commit the "
          "forced tokens")
    index = {rid: i for i, rid in enumerate(rids)}
    out = ({(index[r], j): z for (r, j), z in scores.items()},
           {(index[r], j): m for (r, j), m in margins.items()}, secs)
    return out if replay is None else out + (rep,)


def max_diff(a, b, keys=None):
    """The largest |a - b| over two {key: score vector} of the same keys
    (over ``keys`` alone where given)."""
    check(a.keys() == b.keys(), "two teacher-forced serves scored "
          "different tokens")
    return max((float(np.abs(a[k] - b[k]).max())
                for k in (a if keys is None else keys)), default=0.0)


def card_vs_cpu(label, cfg, params, sc, dev, prompts, max_new, bf16,
                plain=False, control=False, judge="cpu", prompt_err=None):
    """Serve ``prompts`` greedily on the card, then teacher-force the CPU
    (the same weights, moved) through the card's tokens, so that every
    token's logits read the same inputs on both sides. f32 models: the
    card's logits of every token within LOGIT_ATOL of the CPU's, and a
    token apart from the CPU's choice only where the CPU top-2 margin is
    at most NEAR_TIE. bf16 models, ROADMAP §3's rule: the bf16 error
    ``err`` is measured on the CPU, as the largest |bf16 - f32| logit of
    the CPU's serve against an f32 serve of the same bf16-rounded weights
    teacher-forced the same way and of ``bf16_error`` over every prompt
    position; the card's logits must lie within ``err`` of the CPU's and
    of the f32 serve's, and a token may differ from the CPU's choice only
    where the CPU margin is within ``err``. ``judge="f32"`` (phase 19's
    full-width serves) holds the card to the f32 serve alone, as the
    CPU's bf16 serve is held: the card's logits within ``err`` of it, a
    token apart from its choice only where its top-2 margin is within
    ``err``; the card's distance from the CPU's bf16 serve is reported
    (two bf16 roundings of one forward part by up to the sum of their
    errors: qwen3-4b's card lies 0.093 from the f32 forward, the CPU
    0.102, and the two 0.122 from each other, PR 22). ``plain``: serve once more on
    the card with no recording, for the times (the first serve syncs
    around each prefill and copies each tick's logits to the host).
    ``control``: also teacher-force a card serve for each control fault
    of ``faulty_state`` and report how far its logits lie from the
    CPU's; a lost state write must lie beyond the bound. An MoE config
    (paged) routes each token to discrete experts, and where two runs
    route a token differently (a router near-tie, or a capacity drop one
    causes) its logits jump: so the CPU serves (bf16 and f32) take the
    card serve's expert choices (``replay_routing``), every token's
    logits are compared, and every choice the CPU would have made
    otherwise must sit at a near-tie (``check_ties``). Returns the
    record, with the card's tokens, rids, launches, wall, engine and
    (MoE) its ``RoutingRecorder``."""
    from repro_torch.serve.engine import Engine

    def make(c, device, p):
        return Engine(c, p, sc, device=device)
    routed = "moe" in cfg.pattern_unit()
    eng = make(cfg, dev, params)
    scores = {}
    ticks, prefills, _ = recording_engine(eng, scores)
    card_rec = RoutingRecorder(eng) if routed else None
    prefill_ms = [] if sc.paged else timed_prefills(eng)
    tokens, rids, wall, summary, launches = serve(eng, prompts, max_new)
    check_tokens(label, tokens, cfg, max_new, ticks + prefills)
    index = {rid: i for i, rid in enumerate(rids)}
    card = {(index[r], j): z for (r, j), z in scores.items()}
    timing = {"instrumented_wall_s": wall,
              "instrumented_tpot_p50_ms": summary["tpot_p50_ms"]}
    if plain:
        again = make(cfg, dev, params)
        p_tokens, _, wall, summary, p_launches = serve(again, prompts,
                                                       max_new)
        check(p_tokens == tokens and p_launches == launches,
              f"{label}: the plain serve's tokens or launches differ from "
              f"the first's")
    cpu_params = tree_map(lambda t: t.cpu(), params)
    replay = card_rec.calls if routed else None
    cpu, cpu_margins, cpu_s, *ties = forced_scores(
        make(cfg, "cpu", cpu_params), prompts, max_new, tokens,
        replay=replay)
    routing = {"CPU": check_ties(f"{label} CPU", ties[0])} if routed else {}
    keys = sorted(cpu)
    logit_err = max_diff(card, cpu)
    err, tie, bound_, f32_err, err_s = None, NEAR_TIE, LOGIT_ATOL, None, 0.0
    if bf16:
        t0 = time.perf_counter()
        f32_cfg = dataclasses.replace(cfg, dtype="float32")
        f32, _, _, *ties = forced_scores(
            make(f32_cfg, "cpu", tree_map(lambda t: t.float(), cpu_params)),
            prompts, max_new, tokens, replay=replay)
        if routed:
            routing["f32"] = check_ties(f"{label} f32", ties[0])
        err_tokens = max_diff(cpu, f32)
        # the prompts' error depends on the weights and prompts alone: a
        # caller serving them through two engines passes one dict
        if prompt_err is None:
            prompt_err = {}
        if "err" not in prompt_err:
            prompt_err["err"] = bf16_error(cfg, cpu_params, prompts)
        err_prompts, ties = prompt_err["err"]
        if routed:
            routing["f32 forward of the prompts"] = check_ties(
                f"{label} f32 prompts", ties)
        err_s = time.perf_counter() - t0
        err = tie = bound_ = max(err_tokens, err_prompts)
        f32_err = max_diff(card, f32)
        check(f32_err <= err,
              f"{label}: card logits differ by {f32_err} from the f32 "
              f"forward of the same weights (bound {err})")
        timing.update(bf16_error_tokens=err_tokens,
                      bf16_error_prompts=err_prompts, f32_err=f32_err)
    check(judge == "cpu" or (judge == "f32" and bf16),
          f"{label}: judge {judge!r}")
    if judge == "cpu":
        check(logit_err <= bound_,
              f"{label}: card logits differ by {logit_err} from the CPU's "
              f"(bound {bound_})")
        ref_scores, ref_name, ref_margins = cpu, "CPU", cpu_margins
    else:
        ref_scores, ref_name = f32, "f32 forward"
        ref_margins = {key: float(np.min(top2_margin(f32[key])))
                       for key in keys}
    flips = []
    for i, j in keys:
        z = ref_scores[(i, j)]
        # the codebooks (a codebook model) whose choice parts from the card's
        parted = np.atleast_1d(np.argmax(z, axis=-1)
                               != np.asarray(tokens[i][j]))
        if parted.any():
            margin = float(np.atleast_1d(top2_margin(z))[parted].max())
            check(margin <= tie,
                  f"{label}: request {i} token {j} is {tokens[i][j]} on "
                  f"the card, {np.argmax(z, axis=-1).tolist()} on the "
                  f"{ref_name}, whose top-2 margin {margin} > {tie}")
            flips.append({"request": i, "step": j, "margin": margin})
    all_margins = np.array([ref_margins[key] for key in keys])
    median_margin = float(np.median(all_margins))
    within_tie = int((all_margins <= tie).sum())
    ctrl_err = {}
    for fault in ("bf16", "stale") if control else ():
        ctrl_eng = make(cfg, dev, params)
        faulty_state(ctrl_eng, fault)
        ctrl, _, _ = forced_scores(ctrl_eng, prompts, max_new, tokens)
        ctrl_err[fault] = max_diff(ctrl, cpu)
    check(ctrl_err.get("stale", np.inf) > bound_,
          f"{label}: a lost state write moves the logits by only "
          f"{ctrl_err.get('stale')}, within the bound {bound_}")
    steps = eng.runner.n_steps if sc.paged else eng.metrics.decode_steps
    print_serve(label + (" (plain serve)" if plain else ""), len(prompts),
                summary, wall, steps, launches)
    if plain:
        print(f"{label}: the recording serve took "
              f"{timing['instrumented_wall_s']:.3f} s, TPOT p50 "
              f"{timing['instrumented_tpot_p50_ms']:.3f} ms")
    if routed:
        print(f"{label}: routing, the CPU runs took the card serve's expert "
              f"choices; where their own differed (count, largest top-k "
              f"boundary gap, the RMS router-logit difference; each gap a "
              f"near-tie within {ROUTER_TIE_SIGMAS} RMS): "
              + "; ".join(f"{k} {v['n']}, {v['max_gap']:.4g}, "
                          f"{v['rms']:.3g}" for k, v in routing.items()))
    print(f"{label}: teacher-forced, {len(keys)} tokens' logits compared "
          f"({len(prompts)} prefills, "
          f"{len(cpu) - len(prompts)} decode steps); card against CPU "
          f"max_abs_err {logit_err:.4g}"
          + (" (reported: held to the f32 forward)" if judge == "f32"
             else "")
          + (f", against the f32 forward {f32_err:.4g}, bound {bound_:.4g}"
             f" = the bf16 error on the CPU (CPU bf16 against f32: "
             f"{timing['bf16_error_tokens']:.4g} over the served tokens, "
             f"{timing['bf16_error_prompts']:.4g} over every prompt "
             f"position; {err_s:.1f} s)" if bf16
             else f" (bound {bound_:.4g})")
          + f"; {len(keys) - len(flips)}/{len(keys)} tokens the "
          f"{ref_name}'s choice, flips ({ref_name} margin <= {tie:.4g}): "
          f"{flips}; {ref_name} top-2 margin median {median_margin:.4g}, "
          f"{within_tie}/{len(keys)} within the tie"
          + "".join(f"; control fault {f} state against CPU {e:.4g}, "
                    + ("beyond" if e > bound_ else "within") + " the bound"
                    for f, e in ctrl_err.items())
          + f"; CPU serve {cpu_s:.1f} s")
    return {"tokens": tokens, "rids": rids, "launches": launches,
            "wall_s": wall, "summary": summary, "steps": steps,
            "engine": eng, "routing": card_rec,
            "record": dict(summary, wall_s=wall, steps=steps,
                           launches=launches, logit_err=logit_err,
                           bound=bound_, bf16_error=err, flips=flips,
                           n_compared=len(keys), judge=judge,
                           routing_ties=routing,
                           median_margin=median_margin,
                           within_tie=within_tie, control_err=ctrl_err,
                           cpu_serve_s=cpu_s, prefill_ms=prefill_ms,
                           **timing)}


# ---------------------------------------------------------------------------
# MoE routing across two runs (phase 19)

ROUTE_SINK = []     # the dispatch list of the step (or forward) in flight
ROUTE_FORCE = []    # a replay in flight: another serve's (logits, table)s


def record_routing():
    """Wrap ``moe.route``. While a ``replay_routing`` is open, each call
    takes the expert choices and dispatch table of the replayed serve's
    call of the same order (gates and aux from this call's own router
    probabilities) and notes where its own top-k would have differed,
    with its k-th minus (k+1)-th router logit there. Each call appends
    (router logits f32[T, E], dispatch table i32[E, cap]), on the host,
    to ROUTE_SINK's last list while one is open (a ``RoutingRecorder``
    step or ``bf16_error``'s forward). Returns the undo."""
    from repro_torch.models import moe
    route = moe.route

    def recording_route(logits, cfg, cap):
        if ROUTE_FORCE:
            rec = ROUTE_FORCE[-1]
            check(rec["next"] < len(rec["calls"]),
                  "routing replay: more MoE calls than the replayed serve")
            out = forced_route(logits, cfg, *rec["calls"][rec["next"]],
                               rec)
            rec["next"] += 1
        else:
            out = route(logits, cfg, cap)
        if ROUTE_SINK:
            ROUTE_SINK[-1].append((logits.float().cpu().numpy(),
                                   out[0].cpu().numpy()))
        return out
    moe.route = recording_route
    return lambda: setattr(moe, "route", route)


def forced_route(logits, cfg, rec_logits, rec_table, rep):
    """``moe.route`` with the experts and slots another run chose (its
    router logits ``rec_logits`` and dispatch table ``rec_table``): the
    gates are this run's normalized top-k probabilities at those experts,
    the aux loss this run's. Adds to ``rep`` this run's k-th minus
    (k+1)-th logit wherever its own top-k differs from the forced
    (``ties``), and the squared differences of the two runs' router
    logits (``dsq`` over ``n``)."""
    T, E = logits.shape
    k, dev = cfg.top_k, logits.device
    check(rec_logits.shape == (T, E) and rec_table.shape[0] == E,
          f"routing replay: a call of {T} x {E} router logits replays one of "
          f"{rec_logits.shape}")
    probs = torch.softmax(logits.float(), dim=-1)
    idx = torch.topk(torch.from_numpy(rec_logits).to(dev), k,
                     dim=-1).indices
    own = torch.topk(probs, k, dim=-1).indices
    differ = (torch.sort(own, dim=-1).values
              != torch.sort(idx, dim=-1).values).any(-1).cpu().numpy()
    mine = logits.float().cpu().numpy()
    rep["dsq"] += float(((mine - rec_logits) ** 2).sum())
    rep["n"] += mine.size
    if differ.any():
        z = np.sort(mine[differ], axis=-1)
        rep["ties"].extend((z[:, -k] - z[:, -k - 1]).tolist())
    vals = probs.gather(1, idx)
    vals = vals / vals.sum(-1, keepdim=True)
    full = torch.zeros((T + 1, E), dtype=torch.float32, device=dev)
    full[torch.arange(T, device=dev)[:, None], idx] = vals
    table = torch.from_numpy(rec_table).to(dev)
    gates = full[table.long(), torch.arange(E, device=dev)[:, None]]
    ce = (idx[:, :1] == torch.arange(E, device=dev)).float().mean(0)
    return table, gates, E * (probs.mean(0) * ce).sum()


class replay_routing:
    """``with replay_routing(calls) as rep:`` every MoE call inside takes
    ``calls``' choices in order (``forced_route``); ``rep`` collects the
    top-k boundary gaps where the run's own choice differed and the
    router-logit differences (``check_ties``). Every recorded call must
    be replayed."""

    def __init__(self, calls):
        self.rec = {"calls": calls, "next": 0, "ties": [], "dsq": 0.0,
                    "n": 0}

    def __enter__(self):
        ROUTE_FORCE.append(self.rec)
        return self.rec

    def __exit__(self, kind, *_):
        ROUTE_FORCE.pop()
        if kind is None:
            check(self.rec["next"] == len(self.rec["calls"]),
                  f"routing replay: {self.rec['next']} MoE calls, the "
                  f"replayed serve made {len(self.rec['calls'])}")
        return False


class RoutingRecorder:
    """The MoE dispatch of every step of one paged engine's serve: per
    step, its rows' n_valid, its width and each MoE block's (router
    logits, table), in call order (``calls`` flattens them)."""

    def __init__(self, engine):
        check(engine.scfg.paged, "RoutingRecorder: a paged engine")
        self.steps = []
        step = engine.runner.step

        def recording_step(batch):
            rec = {"n_valid": batch.n_valid.copy(),
                   "S": batch.tokens.shape[1], "calls": []}
            self.steps.append(rec)
            ROUTE_SINK.append(rec["calls"])
            try:
                return step(batch)
            finally:
                ROUTE_SINK.pop()
        engine.runner.step = recording_step

    @property
    def calls(self):
        return [c for st in self.steps for c in st["calls"]]


def check_ties(label, rep):
    """Every routing choice a replayed run would have made otherwise must
    sit at a router near-tie: its top-k boundary gap within
    ROUTER_TIE_SIGMAS root-mean-squares of the two runs' router-logit
    differences. Returns the count, the largest gap and that RMS."""
    rms = (rep["dsq"] / rep["n"]) ** 0.5 if rep["n"] else 0.0
    worst = max(rep["ties"], default=0.0)
    check(worst <= ROUTER_TIE_SIGMAS * rms,
          f"{label}: a routing choice differs at a top-k boundary gap of "
          f"{worst}, beyond {ROUTER_TIE_SIGMAS} x the router logits' RMS "
          f"difference {rms}: not a near-tie")
    return {"n": len(rep["ties"]), "max_gap": worst, "rms": rms}


def capacity_drops(rec, k):
    """Per step of a recorded serve, the assignments its MoE blocks
    dropped: of valid tokens (rows' tokens below n_valid) and of all
    routed rows (padding and idle rows too), summed over the blocks."""
    out = []
    for st in rec.steps:
        valid = total = 0
        for _, tb in st["calls"]:
            T = len(st["n_valid"]) * st["S"]
            kept = np.bincount(tb[tb < T].ravel(), minlength=T)
            total += T * k - int(kept.sum())
            mask = (np.arange(st["S"])[None, :]
                    < st["n_valid"][:, None]).ravel()
            valid += int((k - kept)[mask].sum())
        out.append({"valid": valid, "all": total, "width": st["S"]})
    return out


def check_launches(label, launches, want):
    """Every kernel's launches as ``want`` says (0 where it names none)."""
    for key in KERNELS:
        check(launches[key] == want.get(key, 0),
              f"{label}: {key} launched {launches[key]} times, expected "
              f"{want.get(key, 0)}")


def recurrent_phase(dev, cfg, params, scfg, prompts, max_new, paged_run,
                    big=("zamba2-2.7b", "xlstm-125m")):
    """Phase 18 ((a), kernel 5 at zamba2-2.7b's decode shape, is a phase-3
    row): (b) zamba2-smoke and xlstm-smoke, f32,
    on the slot engine, card against CPU teacher-forced; (c) zamba2-2.7b
    at full width, 18 of 54 layers, in bf16, 4 requests, card against CPU
    teacher-forced under the bf16 rule with the state control faults,
    then a plain serve for the times and once more under torch.profiler;
    (d) xlstm-125m in bf16 the same way, unprofiled; (e)
    llama3.2-1b-smoke in bf16 through the paged flash engine (kernel 1
    with a bf16 model's q); (f) the sequential drafter: a
    recurrent draft model (zamba2-smoke with nectar's vocab) drafting for
    the paged nectar engine, against phase 5's paged serve and the CPU.
    ``paged_run`` is phase 5's (tokens, margins, rids). Returns (details,
    the serves' launches summed)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ServeConfig, SpecConfig
    from repro_torch.models import Model
    from repro_torch.serve.engine import Engine
    from repro_torch.spec.drafter import ModelDrafter
    details, total = {}, dict.fromkeys(KERNELS, 0)
    rrng = np.random.default_rng(SEED + 12)
    # zamba2-2.7b at 18 of its 54 layers (3 of its 9 units): the CPU's
    # bf16 and f32 runs of the full depth took 60-105 s of the script
    zcfg = dataclasses.replace(get_config(big[0]), n_layers=18)

    def add(launches):
        for key in KERNELS:
            total[key] += launches[key]

    def seeded(c, seed):
        return Model(c).init(torch.Generator(device=dev).manual_seed(seed),
                             device=dev)

    def smoke_prompts(c, n, lo, hi):
        return [rrng.integers(0, c.vocab, int(m), dtype=np.int32)
                for m in rrng.integers(lo, hi + 1, n)]

    # (b) the SMOKEs, f32, slot engine
    slot_sc = ServeConfig(paged=False, max_batch=8, max_seq=256)
    for name in ("zamba2-smoke", "xlstm-smoke"):
        c = get_config(name)
        r = card_vs_cpu(f"recurrent {name}", c, seeded(c, SEED + 12),
                        slot_sc, dev, smoke_prompts(c, 16, 8, 128), 16,
                        bf16=False)
        n_attn = c.pattern_unit().count("shared_attn") * c.n_units
        check(r["steps"] > 0, f"recurrent {name}: no decode step ran")
        check_launches(f"recurrent {name}", r["launches"],
                       {"decode_attention": n_attn * r["steps"]})
        details[name] = r["record"]
        add(r["launches"])

    # (c) zamba2-2.7b, full width, 18 layers, bf16: 4 requests of 32-128
    # prompt tokens, 16 new tokens each
    big_sc = ServeConfig(paged=False, max_batch=4, max_seq=512)
    t0 = time.perf_counter()
    zparams = seeded(zcfg, SEED + 13)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(zparams))
    w_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(zparams))
    # a decode step reads every weight but the embedding table's rows
    step_bound_ms = (w_bytes - zparams["embed"].numel()
                     * zparams["embed"].element_size()) \
        / HBM_BYTES_PER_S * 1e3
    print(f"recurrent {zcfg.name}: {zcfg.n_layers} layers "
          f"({zcfg.pattern_unit()} x {zcfg.n_units}), {n_params} parameters "
          f"(the analytic param_count() {zcfg.param_count()} leaves out the "
          f"shared block's FFN), {w_bytes} bytes of weights, made on the "
          f"card in {time.perf_counter() - t0:.1f} s")
    zprompts = smoke_prompts(zcfg, 4, 32, 128)
    r = card_vs_cpu(f"recurrent {zcfg.name}", zcfg, zparams, big_sc, dev,
                    zprompts, 16, bf16=True, plain=True, control=True)
    n_attn = zcfg.pattern_unit().count("shared_attn") * zcfg.n_units
    check(n_attn == 3 and r["steps"] > 0,
          f"recurrent {zcfg.name}: {n_attn} shared attention invocations a "
          f"step, {r['steps']} decode steps")
    check_launches(f"recurrent {zcfg.name}", r["launches"],
                   {"decode_attention": n_attn * r["steps"]})
    add(r["launches"])
    prof = profile_serve(f"profile {zcfg.name}",
                         lambda: Engine(zcfg, zparams, big_sc, device=dev),
                         zprompts, 16, r["tokens"], r["launches"],
                         r["wall_s"])
    s = r["summary"]
    k5 = prof["kernel_device_ms"].get("decode_attention")
    busy = ("not measured" if prof["busy_share"] is None
            else f"{100 * prof['busy_share']:.2f}%")
    print(f"recurrent {zcfg.name}: plain serve {s['tokens_per_s']:.2f} "
          f"tok/s; prefill ms (each synced) "
          f"{['%.1f' % x for x in r['record']['prefill_ms']]}; TPOT p50 "
          f"{s['tpot_p50_ms']:.2f} ms (bound of a decode step: "
          f"{step_bound_ms:.3f} ms for the bf16 weights it reads at "
          f"{HBM_BYTES_PER_S / 1e12} TB/s), busy share {busy} of the "
          f"plain serve's wall, "
          f"{prof['n_device_events']} CUDA kernels and copies in the serve's "
          f"{r['steps']} decode steps and 4 prefills; kernel 5 at Dh 80: "
          + ("not measured" if k5 is None else f"{k5:.5f}")
          + f" device ms a call, {n_attn} launches a decode step; "
          f"most device time: "
          + "; ".join(f"{n} x{c} {t:.3f}" for n, c, t in prof["top_device"]))
    details[zcfg.name] = dict(r["record"], profile=prof, n_params=n_params,
                              weight_bytes=w_bytes,
                              step_bound_ms=step_bound_ms)
    del zparams, r
    torch.cuda.empty_cache()

    # (d) xlstm-125m, bf16, the same rule
    xcfg = get_config(big[1])
    r = card_vs_cpu(f"recurrent {xcfg.name}", xcfg, seeded(xcfg, SEED + 14),
                    big_sc, dev, smoke_prompts(xcfg, 4, 32, 128), 16,
                    bf16=True, plain=True, control=True)
    check_launches(f"recurrent {xcfg.name}", r["launches"], {})
    s = r["summary"]
    print(f"recurrent {xcfg.name}: plain serve {s['tokens_per_s']:.2f} "
          f"tok/s, TPOT p50 {s['tpot_p50_ms']:.2f} ms; prefill ms (each "
          f"synced) {['%.1f' % x for x in r['record']['prefill_ms']]}")
    details[xcfg.name] = r["record"]
    add(r["launches"])

    # (e) a bf16 model through the paged flash engine: kernel 1 with a
    # bf16 model's q, widened at the call (fault 2(c))
    lcfg = dataclasses.replace(get_config("llama3.2-1b-smoke"),
                               dtype="bfloat16")
    lparams = seeded(lcfg, SEED + 15)
    check(lparams["embed"].dtype == torch.bfloat16,
          "bf16 paged: the weights are not bf16")
    r = card_vs_cpu("recurrent bf16 paged flash llama3.2-1b-smoke", lcfg,
                    lparams, scfg, dev, [p % lcfg.vocab for p in prompts],
                    max_new, bf16=True)
    check_launches("recurrent bf16 paged flash", r["launches"],
                   {"paged_attention": lcfg.n_layers * r["steps"]})
    check(r["steps"] > 0, "bf16 paged: no step ran")
    details["bf16_paged_flash"] = r["record"]
    add(r["launches"])

    # (f) the sequential drafter: zamba2-smoke with nectar's vocab drafts
    # for the paged nectar engine
    dcfg = dataclasses.replace(get_config("zamba2-smoke"), vocab=cfg.vocab)
    dparams = seeded(dcfg, SEED + 16)
    sc = dataclasses.replace(scfg, spec=SpecConfig(drafter="model", k=4,
                                                   k_max=8))

    def spec_engine(device, p):
        return Engine(cfg, p, sc, device=device, drafter=ModelDrafter(
            dcfg, tree_map(lambda t: t.to(device), dparams), sc.max_seq,
            max_batch=sc.max_batch, device=device))
    eng = spec_engine(dev, params)
    ticks, _, _ = recording_spec_engine(eng)
    tokens, rids, wall, summary, launches = serve(eng, prompts, max_new)
    check_tokens("recurrent drafter", tokens, cfg, max_new, ticks)
    cpu = spec_engine("cpu", tree_map(lambda t: t.cpu(), params))
    cpu_ticks, cpu_margins, _ = recording_spec_engine(cpu)
    t0 = time.perf_counter()
    cpu_tokens, cpu_rids, _, _, _ = serve(cpu, prompts, max_new)
    cpu_s = time.perf_counter() - t0
    # the target's logits at the first verify step only, as phase 6 does:
    # a top-k swap of the sparse FFN at a near-tie moves later logits by
    # more than LOGIT_ATOL without a fault (see ``flip_probe``)
    logit_err = float(np.abs(ticks[0] - cpu_ticks[0]).max())
    check(logit_err <= LOGIT_ATOL,
          f"recurrent drafter: first-step logits differ by {logit_err} "
          f"from the CPU's")
    flips = compare_cpu("recurrent drafter-cpu", tokens, cpu_tokens,
                        cpu_margins, cpu_rids)
    steps = eng.runner.n_steps
    print_serve("recurrent drafter", len(prompts), summary, wall, steps,
                launches)
    print(f"recurrent drafter: card against CPU first-step logits "
          f"max_abs_err {logit_err:.4g}; {len(prompts) - len(flips)}/"
          f"{len(prompts)} requests token-identical, near-tie flips "
          f"{flips}; CPU serve {cpu_s:.1f} s")
    r = {"tokens": tokens, "launches": launches, "steps": steps,
         "summary": summary, "engine": eng,
         "record": dict(summary, wall_s=wall, steps=steps,
                        launches=launches, logit_err=logit_err,
                        flips=flips, cpu_serve_s=cpu_s)}
    eng = r["engine"]
    dsteps = eng.drafter.steps
    check(not eng.drafter._batched and dsteps > 0,
          f"recurrent drafter: {dsteps} sequential draft steps")
    check_launches("recurrent drafter", r["launches"], {
        "paged_attention": cfg.n_layers * r["steps"],
        "sparse_gather_matvec": cfg.n_layers * r["steps"],
        "decode_attention": dcfg.n_units * dsteps})
    paged_flips = compare_cpu("recurrent drafter vs paged", r["tokens"],
                              *paged_run)
    print(f"recurrent drafter: {r['summary']['spec_steps']} verify steps, "
          f"acceptance {r['summary']['spec_acceptance_rate']:.4f}, {dsteps} "
          f"sequential draft steps (kernel 5 once each); against the "
          f"phase-5 paged serve {len(prompts) - len(paged_flips)}/"
          f"{len(prompts)} requests token-identical, near-tie flips "
          f"{paged_flips}")
    details["drafter"] = dict(r["record"], draft_steps=dsteps,
                              paged_flips=paged_flips)
    add(r["launches"])
    return details, total


# ---------------------------------------------------------------------------
# phase 19: the paper's C4 dispatch, then the attention variants and MoE

DISPATCH_ATOL = 1e-5   # kernel 2 and the dense product against their plain
#                        versions (kernel 4 must be exact)


def dispatch_phase(dev):
    """Phase 19 (a): ``core.heterogeneous``'s decision tables at the v5e's
    ridge and at the H100 SXM's, side by side, for four configs' decode
    widths (batch 8); then a ``Dispatcher`` judged at the H100 SXM, its
    three regimes bound on the card (``gemv_stream``: int8 weights from
    ``core.quant`` through ``ops.nmce_matmul``, kernel 4; ``sparse_gather``:
    ``ops.sparse_gather_matvec``, kernel 2; ``gemm_mxu``: ``torch.matmul``,
    cuBLAS), takes each decode site of nectar-relu-llama-1.7m and a
    prefill-sized site (2048 x 512 x 8192, the dense regime), each output held
    against its regime's plain version on the card. Returns (details, the
    kernel launches of the dispatched calls)."""
    from repro_torch.configs import get_config
    from repro_torch.core import heterogeneous, quant, sparsity
    from repro_torch.kernels import ops, ref
    from repro_torch.roofline import hw
    tables = {}
    for name in ("nectar-relu-llama-1.7m", "llama3.2-1b", "qwen3-4b",
                 "moonshot-v1-16b-a3b"):
        c = get_config(name)
        args = (c.d_model, c.d_ff, c.vocab, 8)
        v5e = heterogeneous.decode_regime_report(*args, chip=hw.V5E)
        h100 = heterogeneous.decode_regime_report(*args, chip=hw.H100_SXM)
        sites = heterogeneous.decode_sites(*args)
        tables[name] = {
            site: {"v5e": v5e[site], "h100_sxm": h100[site],
                   "intensity": heterogeneous.arithmetic_intensity(
                       sites[site])} for site in v5e}
        print(f"dispatch {name} (d {c.d_model}, d_ff {c.d_ff}, vocab "
              f"{c.vocab}, batch 8), site: FLOP/byte, tpu-v5e / h100-sxm: "
              + "; ".join(f"{site} {t['intensity']:.2f}, {t['v5e']} / "
                          f"{t['h100_sxm']}" for site, t in
                          tables[name].items()))
    ridges = {chip.name: chip.peak_flops / chip.hbm_bw
              for chip in (hw.V5E, hw.H100_SXM)}
    print(f"dispatch: ridge points (bf16 peak over HBM rate) "
          + ", ".join(f"{k} {v:.1f} FLOP/byte" for k, v in ridges.items()))

    def gemv(x, w):
        return ops.nmce_matmul(x, quant.quantize_int8(w, axis=1))

    def gemv_plain(x, w):
        w_q, x_q = quant.quantize_int8(w, axis=1), quant.quantize_int8(x,
                                                                       axis=0)
        return ref.nmce_matmul_plain(x_q.q, w_q.q, x_q.scale.reshape(-1, 1),
                                     w_q.scale.reshape(1, -1))
    impls = {"gemv_stream": gemv,
             "sparse_gather": ops.sparse_gather_matvec,
             "gemm_mxu": torch.matmul}
    plain = {"gemv_stream": gemv_plain,
             "sparse_gather": ref.sparse_gather_matvec_plain,
             "gemm_mxu": lambda x, w: (x.double() @ w.double()).float()}
    disp = heterogeneous.Dispatcher(impls, chip=hw.H100_SXM)
    drng = np.random.default_rng(SEED + 19)

    def normal(shape, scale=1.0):
        return torch.tensor(drng.standard_normal(shape) * scale,
                            dtype=torch.float32, device=dev)
    cfg = get_config("nectar-relu-llama-1.7m")
    sites = dict(heterogeneous.decode_sites(cfg.d_model, cfg.d_ff, cfg.vocab,
                                            8))
    # a prefill-sized site above the H100's ridge; K 512 keeps the f32
    # product's rounding under DISPATCH_ATOL (at K 2048 cuBLAS's f32
    # product parts from the f64 one by 1.2e-5)
    sites["prefill 2048 rows"] = heterogeneous.MatmulSite(
        rows=2048, k=512, n=8192)
    calls = []
    for name, site in sites.items():
        w = normal((site.k, site.n), site.k ** -0.5)
        if site.sparsity:
            # the top (1 - sparsity) of a ReLU hidden's units, the rest
            # empty slots (index d_ff)
            h = torch.relu(normal((site.rows, site.k)))
            k = round(site.k * (1 - site.sparsity))
            idx, valid = sparsity.topk_indices(h, k)
            hk = torch.where(valid, torch.gather(h, -1, idx.long()), 0.0)
            args = (hk.contiguous(),
                    torch.where(valid, idx, site.k).contiguous(), w)
        else:
            args = (normal((site.rows, site.k)), w)
        calls.append((name, site, args))
    for key in ops.LAUNCHES:
        ops.LAUNCHES[key] = 0
    outs = [disp(site, *args) for _, site, args in calls]
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    rows, want = {}, dict.fromkeys(KERNELS, 0)
    for (name, site, args), (out, regime) in zip(calls, outs):
        check(regime == heterogeneous.classify(site, hw.H100_SXM),
              f"dispatch {name}: regime {regime}")
        expect = plain[regime](*args)
        err = float((out - expect).abs().max())
        if regime == "gemv_stream":
            check(torch.equal(out, expect), f"dispatch {name}: kernel 4 "
                  f"differs from its plain version by {err}")
            want["nmce_matmul"] += 1
        else:
            check(err <= DISPATCH_ATOL, f"dispatch {name} ({regime}): "
                  f"max_abs_err {err} against its plain version")
            want["sparse_gather_matvec"] += regime == "sparse_gather"
        rows[name] = {"regime": regime, "max_abs_err": err,
                      "rows": site.rows, "k": site.k, "n": site.n}
    check_launches("dispatch", launches, want)
    print("dispatch: a Dispatcher at h100-sxm on the card: "
          + "; ".join(f"{n} {r['rows']}x{r['k']}x{r['n']} -> {r['regime']}"
                      f" max_abs_err {r['max_abs_err']:.3g}"
                      for n, r in rows.items())
          + f" (kernel 4 exact); launches {launches}")
    return {"tables": tables, "ridges": ridges, "sites": rows}, launches


def moe_device_share(make_engine, prompts, max_new):
    """One more serve under torch.profiler (CPU and CUDA activity), every
    MoE block inside a ``record_function`` range: the device time of the
    kernels those ranges launched over all the serve's device time, as
    (moe ms, total ms), or None where the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.models import moe
    forward = moe.moe_forward

    def annotated(*args, **kwargs):
        with record_function("moe_block"):
            return forward(*args, **kwargs)
    engine = make_engine()
    moe.moe_forward = annotated
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            serve(engine, prompts, max_new)
            torch.cuda.synchronize()
    finally:
        moe.moe_forward = forward
    from torch.autograd import DeviceType
    total = sum(e.self_device_time_total
                for e in device_events(prof.key_averages()))
    # the CPU side of each range: the device time of the kernels its ops
    # launched (the device side of a range spans its first to its last
    # kernel, idle time included)
    moe_us = sum(e.device_time_total for e in prof.events()
                 if e.name == "moe_block" and e.device_type == DeviceType.CPU)
    if not total or not moe_us or moe_us > total:
        return None
    return moe_us / 1e3, total / 1e3


def families_phase(dev, scfg, prompts, max_new):
    """Phase 19 ((b), kernel 1 at the new head groupings, is a phase-3
    row): (a) ``dispatch_phase``; (c) the four SMOKEs (qwen3-4b-smoke,
    qwen2.5-3b-smoke, moonshot-v1-smoke, llama4-maverick-smoke), f32,
    through the paged flash engine on the phase-5 prompts (token ids mod
    the vocab), card against CPU teacher-forced (the near-tie rule; MoE
    judged before each request's first routing difference), and
    moonshot-v1-smoke again through the async engine at K = 8 with the
    sync serve's tokens; (d) qwen3-4b at full width in bf16, cut to 12
    of its 36 layers (seeded weights made on the card), 4
    prompts of 32-128 tokens, 16 new tokens each, through the paged flash
    engine, held to ROADMAP §3's bf16 rule under teacher forcing, its
    times from a plain serve and a profiled one; (e) moonshot-v1-16b-a3b at full width cut to 2 layers,
    the same, with the MoE blocks' share of the device time and the
    capacity drops per step. Returns (details, the serves' and the
    dispatcher's launches summed)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import AsyncConfig
    from repro_torch.models import Model
    from repro_torch.serve.engine import Engine
    details, total = {}, dict.fromkeys(KERNELS, 0)

    def add(launches):
        for key in KERNELS:
            total[key] += launches[key]

    def seeded(c, seed):
        return Model(c).init(torch.Generator(device=dev).manual_seed(seed),
                             device=dev)
    undo = record_routing()
    try:
        details["dispatch"], launches = dispatch_phase(dev)
        add(launches)

        # (c) the SMOKEs, f32, paged flash, the phase-5 prompts
        for name in ("qwen3-4b-smoke", "qwen2.5-3b-smoke",
                     "moonshot-v1-smoke", "llama4-maverick-smoke"):
            c = get_config(name)
            params = seeded(c, SEED + 19)
            sm_prompts = [p % c.vocab for p in prompts]
            r = card_vs_cpu(f"families {name}", c, params, scfg, dev,
                            sm_prompts, max_new, bf16=False)
            check(r["steps"] > 0, f"families {name}: no step ran")
            check_launches(f"families {name}", r["launches"],
                           {"paged_attention": c.n_layers * r["steps"]})
            details[name] = r["record"]
            add(r["launches"])
            if name != "moonshot-v1-smoke":
                continue
            acfg = AsyncConfig(enabled=True, max_device_ticks=8)
            eng = Engine(c, params, dataclasses.replace(scfg,
                                                        async_cfg=acfg),
                         device=dev)
            a_tokens, _, a_wall, a_summary, a_launches = serve(
                eng, sm_prompts, max_new)
            stats = eng.async_stats()
            check(a_tokens == r["tokens"], f"families {name}: the async "
                  f"K = 8 serve's tokens differ from the sync serve's")
            check(stats["loop_bursts"] > 0 and a_launches["paged_attention"]
                  > 0, f"families {name}: async K = 8 ran no burst "
                  f"({stats}, launches {a_launches})")
            print_serve(f"families {name} async K=8", len(sm_prompts),
                        a_summary, a_wall, eng.runner.n_steps, a_launches)
            print(f"families {name} async K=8: the sync serve's tokens, "
                  f"{len(sm_prompts)}/{len(sm_prompts)} requests; "
                  f"async_stats {stats}, "
                  f"{getattr(eng.runner, 'graph_replays', 0)} graph "
                  f"replays")
            details[name + " async K8"] = dict(
                a_summary, wall_s=a_wall, launches=a_launches,
                async_stats=stats)
            add(a_launches)
            del eng
        lap_ = time.perf_counter()

        # (d) qwen3-4b and (e) moonshot-v1-16b-a3b cut to 2 layers, bf16,
        # at full width: 4 prompts of 32-128 tokens, 16 new tokens each
        big_sc = dataclasses.replace(scfg, max_batch=4, max_seq=512)
        frng = np.random.default_rng(SEED + 20)
        # qwen3-4b at 12 of its 36 layers since phase 20 joined: the CPU
        # runs of the full depth took ~110 s of the script's time (at 4
        # layers the card's bf16 error passed the CPU's bound: PERF.md
        # §7)
        for name, cut, seed in (("qwen3-4b", 12, SEED + 21),
                                ("moonshot-v1-16b-a3b", 2, SEED + 22)):
            c = get_config(name)
            if cut:
                c = dataclasses.replace(c, n_layers=cut)
            t0 = time.perf_counter()
            params = seeded(c, seed)
            torch.cuda.synchronize()
            made_s = time.perf_counter() - t0
            leaves = tree_leaves(params)
            n_params = sum(t.numel() for t in leaves)
            w_bytes = sum(t.numel() * t.element_size() for t in leaves)
            label = f"families {name}" + (f" ({cut} layers)" if cut else "")
            print(f"{label}: {c.n_layers} layers ({c.pattern_unit()} x "
                  f"{c.n_units}), d_model {c.d_model}, Hq {c.n_heads} / Kv "
                  f"{c.n_kv_heads} / Dh {c.d_head}, vocab {c.vocab}, "
                  f"{n_params} parameters (param_count() {c.param_count()}),"
                  f" {w_bytes} bytes of bf16 weights (the router f32) made "
                  f"on the card in {made_s:.1f} s")
            big_prompts = [frng.integers(0, c.vocab, int(n), dtype=np.int32)
                           for n in frng.integers(32, 129, 4)]
            r = card_vs_cpu(label, c, params, big_sc, dev, big_prompts, 16,
                            bf16=True, plain=True, judge="f32")
            check_launches(label, r["launches"],
                           {"paged_attention": c.n_layers * r["steps"]})
            add(r["launches"])
            prof = profile_serve(f"profile {name}",
                                 lambda: Engine(c, params, big_sc,
                                                device=dev),
                                 big_prompts, 16, r["tokens"],
                                 r["launches"], r["wall_s"])
            s = r["summary"]
            k1 = prof["kernel_device_ms"].get("paged_attention")
            busy = ("not measured" if prof["busy_share"] is None
                    else f"{100 * prof['busy_share']:.2f}%")
            extra = {}
            if "moe" in c.pattern_unit():
                drops = capacity_drops(r["routing"], c.top_k)
                share = moe_device_share(
                    lambda: Engine(c, params, big_sc, device=dev),
                    big_prompts, 16)
                extra = {"capacity_drops": drops,
                         "moe_device_ms": None if share is None
                         else share[0],
                         "device_ms_all": None if share is None
                         else share[1]}
                pre = [x for x in drops if x["width"] > 1]
                dec = [x for x in drops if x["width"] == 1]
                print(f"{label}: capacity drops a step (assignments of "
                      f"valid tokens / of all routed rows, summed over the "
                      f"{c.n_layers} MoE blocks): prefill steps "
                      f"{[(x['valid'], x['all']) for x in pre]}, decode "
                      f"steps {sum(x['valid'] for x in dec)} / "
                      f"{sum(x['all'] for x in dec)} over {len(dec)}; MoE "
                      f"blocks' device time "
                      + ("not measured" if share is None else
                         f"{share[0]:.3f} of {share[1]:.3f} ms = "
                         f"{100 * share[0] / share[1]:.2f}%"))
            print(f"{label}: plain serve {s['tokens_per_s']:.2f} tok/s, "
                  f"TTFT p50 {s['ttft_p50_ms']:.2f} ms p99 "
                  f"{s['ttft_p99_ms']:.2f} ms, TPOT p50 "
                  f"{s['tpot_p50_ms']:.3f} ms p99 {s['tpot_p99_ms']:.3f} ms;"
                  f" busy share {busy} of the plain serve's wall, "
                  f"{prof['n_device_events']} CUDA kernels and copies; "
                  f"kernel 1 "
                  + ("not measured" if k1 is None else f"{k1:.5f}")
                  + f" device ms a call, {c.n_layers} launches a step; "
                  f"most device time: "
                  + "; ".join(f"{n} x{cnt} {t:.3f}"
                              for n, cnt, t in prof["top_device"]))
            details[label] = dict(r["record"], profile=prof,
                                  n_params=n_params, weight_bytes=w_bytes,
                                  **extra)
            del params, r
            torch.cuda.empty_cache()
        details["full_width_s"] = time.perf_counter() - lap_
    finally:
        undo()
    return details, total


# ---------------------------------------------------------------------------
# phase 20: the frontends (qwen2-vl's M-RoPE and vision stub, musicgen's
# sinusoidal positions and codebook streams)


def codebook_prompts(rng, c, lengths):
    """A codebook model's prompts: [L, nc] token ids for each L."""
    return [rng.integers(0, c.vocab, (int(n), c.n_codebooks), dtype=np.int32)
            for n in lengths]


def frontend_forward(dev, c, params):
    """One ``Model.forward`` of qwen2-vl (bf16) on the card with patch
    embeddings over the first half of 64 positions and M-RoPE positions
    whose channels differ (a 1 x 4 x 8 t/h/w grid, then text), against
    the CPU: held, as the bf16 serves are, to the f32 forward of the same
    bf16-rounded weights within the CPU's own bf16 error there."""
    from repro_torch.models import Model
    frng = np.random.default_rng(SEED + 27)
    S = 64
    toks = frng.integers(0, c.vocab, (1, S)).astype(np.int32)
    vis = frng.standard_normal((1, S // 2, c.d_model)).astype(np.float32)
    grid = np.stack([np.zeros(32), np.repeat(np.arange(4), 8),
                     np.tile(np.arange(8), 4)])
    text = np.broadcast_to(8 + np.arange(S - 32), (3, S - 32))
    pos = np.concatenate([grid, text], 1)[:, None].astype(np.int32)
    f32_cfg = dataclasses.replace(c, dtype="float32")

    def run(cfg, p, device):
        t = lambda a: torch.from_numpy(np.array(a)).to(device)  # noqa: E731
        with torch.no_grad():
            logits, _ = Model(cfg).forward(p, t(toks), vision_embeds=t(vis),
                                           mrope_positions=t(pos))
        return logits.float().cpu()
    card = run(c, params, dev)
    cpu_params = tree_map(lambda t: t.cpu(), params)
    cpu = run(c, cpu_params, "cpu")
    f32 = run(f32_cfg, tree_map(lambda t: t.float(), cpu_params), "cpu")
    err = float((cpu - f32).abs().max())
    f32_err = float((card - f32).abs().max())
    cpu_err = float((card - cpu).abs().max())
    check(bool(torch.isfinite(card).all()) and card.shape == (1, S, c.vocab),
          "frontends qwen2-vl forward: non-finite logits or a wrong shape")
    check(f32_err <= err, f"frontends qwen2-vl forward: card logits differ "
          f"by {f32_err} from the f32 forward (bound {err}, the CPU's bf16 "
          f"error)")
    print(f"frontends {c.name} Model.forward: {S} positions, patch "
          f"embeddings over the first {S // 2}, M-RoPE t/h/w grid 1x4x8 then "
          f"text; card against the f32 forward {f32_err:.4g} (bound "
          f"{err:.4g} = CPU bf16 against f32), against the CPU's bf16 "
          f"forward {cpu_err:.4g}")
    return {"f32_err": f32_err, "bound": err, "cpu_err": cpu_err,
            "positions": S}


def frontends_phase(dev, scfg, slot_scfg, prompts, max_new):
    """Phase 20 ((d), kernels 1 and 5 at the new shapes, is a phase-3
    row): (a) qwen2-vl-smoke and musicgen-smoke, f32, on the phase-5
    prompts (token ids mod the vocab; musicgen's [L, 2] of the same
    lengths, from the same seed) through the paged flash and the slot
    engines, card against CPU teacher-forced (the near-tie rule, codebook
    by codebook), and qwen2-vl-smoke through the async engine at K = 8
    with the sync serve's tokens; (b) musicgen-medium at full width in
    bf16, cut to 12 of 48 layers (seeded weights made on the card), 4
    prompts of 32-128 frames x 4 codebooks, 16 new tokens each, paged
    flash and slot, held to phase 18's bf16 rule under teacher forcing,
    times from a plain serve and a
    profiled one; (c) qwen2-vl-72b at full width cut to 2 layers in bf16,
    the same through the paged flash engine under phase 19's
    ``judge="f32"`` on 4 prompts of 16-64 tokens, and one
    ``Model.forward`` with the vision stub and distinct M-RoPE channels
    (``frontend_forward``). Returns (details,
    the serves' launches summed)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import AsyncConfig
    from repro_torch.models import Model
    from repro_torch.serve.engine import Engine
    details, total = {}, dict.fromkeys(KERNELS, 0)

    def add(launches):
        for key in KERNELS:
            total[key] += launches[key]

    def seeded(c, seed):
        return Model(c).init(torch.Generator(device=dev).manual_seed(seed),
                             device=dev)

    def want(c, sc, steps):
        key = "paged_attention" if sc.paged else "decode_attention"
        return {key: c.n_layers * steps}

    # (a) the SMOKEs, f32, paged flash and slot, the phase-5 prompts
    for name in ("qwen2-vl-smoke", "musicgen-smoke"):
        c = get_config(name)
        params = seeded(c, SEED + 25)
        sm_prompts = codebook_prompts(
            np.random.default_rng(SEED), c, [len(p) for p in prompts]) \
            if c.n_codebooks else [p % c.vocab for p in prompts]
        for engine, sc in (("paged flash", scfg), ("slot", slot_scfg)):
            label = f"frontends {name} {engine}"
            r = card_vs_cpu(label, c, params, sc, dev, sm_prompts, max_new,
                            bf16=False)
            check(r["steps"] > 0, f"{label}: no step ran")
            check_launches(label, r["launches"], want(c, sc, r["steps"]))
            details[f"{name} {engine}"] = r["record"]
            add(r["launches"])
            if c.n_codebooks or not sc.paged:
                continue
            acfg = AsyncConfig(enabled=True, max_device_ticks=8)
            eng = Engine(c, params, dataclasses.replace(sc, async_cfg=acfg),
                         device=dev)
            a_tokens, _, a_wall, a_summary, a_launches = serve(
                eng, sm_prompts, max_new)
            stats = eng.async_stats()
            check(a_tokens == r["tokens"], f"{label}: the async K = 8 "
                  f"serve's tokens differ from the sync serve's")
            check(stats["loop_bursts"] > 0
                  and a_launches["paged_attention"] > 0,
                  f"{label}: async K = 8 ran no burst ({stats}, launches "
                  f"{a_launches})")
            print_serve(f"{label} async K=8", len(sm_prompts), a_summary,
                        a_wall, eng.runner.n_steps, a_launches)
            print(f"{label} async K=8: the sync serve's tokens, "
                  f"{len(sm_prompts)}/{len(sm_prompts)} requests; "
                  f"async_stats {stats}, {eng.runner.graph_replays} graph "
                  f"replays")
            details[f"{name} async K8"] = dict(
                a_summary, wall_s=a_wall, launches=a_launches,
                async_stats=stats)
            add(a_launches)
            del eng
    lap_ = time.perf_counter()

    # (b) musicgen-medium at full width cut to 12 of 48 layers (the CPU's
    # runs of the full depth took 100-145 s), 4 prompts of 32-128 frames x
    # 4 codebooks, and (c) qwen2-vl-72b cut to 2 layers, 4 prompts of 16-64
    # tokens (its CPU runs project every position to 152,064 logits),
    # bf16, 16 new tokens each
    frng = np.random.default_rng(SEED + 26)
    for name, cut, seed, engines, judge, (lo, hi) in (
            ("musicgen-medium", 12, SEED + 28,
             (("paged flash", scfg), ("slot", slot_scfg)), "cpu", (32, 128)),
            ("qwen2-vl-72b", 2, SEED + 29, (("paged flash", scfg),), "f32",
             (16, 64))):
        c = get_config(name)
        if cut:
            c = dataclasses.replace(c, n_layers=cut)
        t0 = time.perf_counter()
        params = seeded(c, seed)
        torch.cuda.synchronize()
        made_s = time.perf_counter() - t0
        leaves = tree_leaves(params)
        n_params = sum(t.numel() for t in leaves)
        w_bytes = sum(t.numel() * t.element_size() for t in leaves)
        base = f"frontends {name}" + (f" ({cut} layers)" if cut else "")
        print(f"{base}: {c.n_layers} layers, d_model {c.d_model}, Hq "
              f"{c.n_heads} / Kv {c.n_kv_heads} / Dh {c.d_head}, vocab "
              f"{c.vocab}" + (f" x {c.n_codebooks} codebooks"
                              if c.n_codebooks else "")
              + f", {n_params} parameters (param_count() "
              f"{c.param_count()}), {w_bytes} bytes of bf16 weights made "
              f"on the card in {made_s:.1f} s")
        lengths = frng.integers(lo, hi + 1, 4)
        prompt_err = {}                 # shared by the engines' CPU runs
        big_prompts = codebook_prompts(frng, c, lengths) if c.n_codebooks \
            else [frng.integers(0, c.vocab, int(n), dtype=np.int32)
                  for n in lengths]
        for engine, sc in engines:
            big_sc = dataclasses.replace(sc, max_batch=4, max_seq=512)
            label = f"{base} {engine}"
            r = card_vs_cpu(label, c, params, big_sc, dev, big_prompts, 16,
                            bf16=True, plain=True, judge=judge,
                            prompt_err=prompt_err)
            check_launches(label, r["launches"],
                           want(c, big_sc, r["steps"]))
            add(r["launches"])
            prof = profile_serve(f"profile {name} {engine}",
                                 lambda: Engine(c, params, big_sc,
                                                device=dev),
                                 big_prompts, 16, r["tokens"],
                                 r["launches"], r["wall_s"])
            s = r["summary"]
            key = "paged_attention" if big_sc.paged else "decode_attention"
            k_ms = prof["kernel_device_ms"].get(key)
            busy = ("not measured" if prof["busy_share"] is None
                    else f"{100 * prof['busy_share']:.2f}%")
            print(f"{label}: plain serve {s['tokens_per_s']:.2f} tok/s, "
                  f"TTFT p50 {s['ttft_p50_ms']:.2f} ms p99 "
                  f"{s['ttft_p99_ms']:.2f} ms, TPOT p50 "
                  f"{s['tpot_p50_ms']:.3f} ms p99 {s['tpot_p99_ms']:.3f} "
                  f"ms; busy share {busy} of the plain serve's wall, "
                  f"{prof['n_device_events']} CUDA kernels and copies; "
                  f"{key} "
                  + ("not measured" if k_ms is None else f"{k_ms:.5f}")
                  + f" device ms a call, {c.n_layers} launches a step; "
                  f"most device time: "
                  + "; ".join(f"{n} x{cnt} {t:.3f}"
                              for n, cnt, t in prof["top_device"]))
            details[label] = dict(r["record"], profile=prof,
                                  n_params=n_params, weight_bytes=w_bytes)
            del r
        if c.mrope:
            details[f"{base} forward"] = frontend_forward(dev, c, params)
        del params
        torch.cuda.empty_cache()
    details["full_width_s"] = time.perf_counter() - lap_
    return details, total


# ---------------------------------------------------------------------------
# phase 21: training (the loss, flash attention's backward, kernel 3 with a
# gradient, the optimizer, data, checkpoints, fault handling)


TRAIN_FFN_ATOL = 1.5e-5   # kernel 3 at the training rows against its plain
#                           version (3xTF32 against f32: ~1e-6 at d 128)
TRAIN_GRAD_RTOL = 1e-4    # its gradients (relative, Frobenius) against
#                           autograd through the plain version
TRAIN_CE_ATOL = 1e-3      # card against CPU ce, each of the first 20 steps
TRAIN_ROWS = 8 * 64       # nectar's training rows: B 8 x S 64


class TimedSource:
    """A batch source that stamps the clock as each batch is taken: with
    ``log_every=1`` the loop reads each step's metrics on the host, so the
    stamps are one step apart."""

    def __init__(self, source):
        self.source, self.stamps = source, []

    def iterate(self, start=0):
        for item in self.source.iterate(start):
            self.stamps.append(time.perf_counter())
            yield item


def step_times_ms(timed, end):
    t = timed.stamps + [end]
    return [(b - a) * 1e3 for a, b in zip(t, t[1:])]


def rel_err(want, got):
    return float(torch.linalg.norm((got - want).double())
                 / max(float(torch.linalg.norm(want.double())), 1e-30))


def ffn_sparsity(model, params, tokens):
    """The fraction of exact zeros of relu(x @ W_up) in every layer's FFN
    over ``tokens`` (one forward, no gradient), read at kernel 3's
    dispatch (``ops._relu_ffn``)."""
    from repro_torch.kernels import ops
    fracs, real = [], ops._relu_ffn

    def spy(x, w_up, w_down):
        fracs.append(float((torch.relu(x @ w_up) == 0).float().mean()))
        return real(x, w_up, w_down)

    ops._relu_ffn = spy
    try:
        with torch.no_grad():
            model.forward(params, tokens)
    finally:
        ops._relu_ffn = real
    return fracs


def layer0_sparsity(params, tokens, cfg):
    """``tests/test_system.py``'s measure: relu(rms_norm(embed) @ W_up) of
    layer 0 with its norm2, the fraction of exact zeros."""
    from repro_torch.models import layers
    with torch.no_grad():
        x = params["embed"][tokens.long()]
        h = layers.rms_norm(x, params["units"]["b0"]["norm2"][0],
                            cfg.norm_eps)
        hid = torch.relu(h @ params["units"]["b0"]["ffn"]["w_up"][0])
        return float((hid == 0).float().mean())


def relu_ffn_backward_ms(dev, rng, M, d, f):
    """The device ms of one backward of kernel 3's autograd rule (its
    four cuBLAS GEMMs and the mask) at M x d x f: all the CUDA time of
    PROFILE_ITERS backwards, averaged (None where the profiler was
    blind)."""
    from repro_torch.kernels import ops
    inputs = [a.requires_grad_(True) for a in ffn_case(dev, rng, M, d, f, ())]
    y = ops.relu_ffn_fused(*inputs)
    dy = torch.tensor(rng.standard_normal((M, d)), dtype=torch.float32,
                      device=dev)
    return library_device_ms(lambda: torch.autograd.grad(
        y, inputs, dy, retain_graph=True))


def training_phase(dev, cfg, scfg, prompts, max_new, paged_run, train_ffn):
    """Phase 21. ``paged_run``: phase 5's (tokens/s, params, tokens) of
    the random-weight paged serve; ``train_ffn``: phase 3's kernel-3 row
    at the training rows and its backward's device ms. Returns (details,
    launch counts of the card's runs that train and serve)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.kernels import ops, ref
    from repro_torch.models import Model
    from repro_torch.train import checkpoint, data, fault
    from repro_torch.train import optimizer as opt
    from repro_torch.train.loop import make_train_step, run_training
    from repro_torch.train.loop import value_and_grad
    from repro_torch.serve.engine import Engine
    from repro_torch.tree import leaves
    out, launches = {}, {key: 0 for key in KERNELS}

    def counted(fn):
        for key in ops.LAUNCHES:
            ops.LAUNCHES[key] = 0
        res = fn()
        torch.cuda.synchronize()
        got = dict(ops.LAUNCHES)
        for key in KERNELS:
            launches[key] += got[key]
        return res, got

    # (a) kernel 3 with a gradient at the training rows (B 8 x S 64)
    trng = np.random.default_rng(SEED + 22)
    B, S = 8, 64
    M, d, f = B * S, cfg.d_model, cfg.d_ff
    row, bwd_ms = train_ffn
    check(row["max_abs_err"] <= TRAIN_FFN_ATOL,
          f"train: relu_ffn at M={M} differs by {row['max_abs_err']} from "
          f"its plain version, beyond {TRAIN_FFN_ATOL}")
    arrays = list(ffn_case(dev, trng, M, d, f, ()))
    mine = [a.clone().requires_grad_(True) for a in arrays]
    plain = [a.clone().requires_grad_(True) for a in arrays]
    dy = torch.tensor(trng.standard_normal((M, d)), dtype=torch.float32,
                      device=dev)
    n0 = ops.LAUNCHES["relu_ffn"]
    y = ops.relu_ffn_fused(*mine)
    n1 = ops.LAUNCHES["relu_ffn"]
    grads = torch.autograd.grad(y, mine, dy)
    torch.cuda.synchronize()
    check(n1 - n0 == 1 and ops.LAUNCHES["relu_ffn"] == n1,
          f"train: kernel 3's Function launched {n1 - n0} times in its "
          f"forward and {ops.LAUNCHES['relu_ffn'] - n1} in its backward, "
          f"expected 1 and 0")
    check(type(y.grad_fn).__name__ == "ReluFFNBackward",
          f"train: kernel 3's output has grad_fn {y.grad_fn}")
    y_plain = ref.relu_ffn_plain(*plain)
    want = torch.autograd.grad(y_plain, plain, dy)
    fwd_err = float((y - y_plain).detach().abs().max())
    errs = {n: rel_err(w, g) for n, w, g in zip(("dx", "dW_up", "dW_down"),
                                                want, grads)}
    check(fwd_err <= TRAIN_FFN_ATOL and max(errs.values()) <= TRAIN_GRAD_RTOL,
          f"train: kernel 3's Function output {fwd_err}, gradients {errs} "
          f"against the plain version's autograd")
    out["kernel3"] = {"forward_err": fwd_err, "grad_rel_err": errs,
                      "forward_device_ms": row["device_ms"],
                      "backward_device_ms": bwd_ms}
    print(f"train (a): kernel 3 at M={M} d {d} d_ff {f}: forward within "
          f"{fwd_err:.3g} of plain, device ms {row['device_ms']} (bound "
          f"{row['bound_ms']:.6f}); backward (4 cuBLAS GEMMs and the mask) "
          f"device ms {bwd_ms}; gradients' relative errors "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
          + "; one launch a forward, none in the backward")

    # (b) 60 steps of the paper's model, card then CPU, the same params
    model = Model(cfg)
    p0 = model.init(torch.Generator(device=dev).manual_seed(SEED), device=dev)
    p0_cpu = tree_map(lambda t: t.cpu(), p0)
    tcfg = TrainConfig(lr=3e-3, warmup_steps=5, total_steps=60, seed=0)
    src = data.TinyStoriesSynth(data.DataConfig(seq_len=S, batch_size=B,
                                                vocab_size=cfg.vocab))
    timed = TimedSource(src)
    (trained, ostate, info), got = counted(lambda: run_training(
        model, cfg, tcfg, timed, steps=60, params=p0, log_every=1,
        device=dev))
    step_ms = step_times_ms(timed, time.perf_counter())
    check(got["relu_ffn"] == 60 * cfg.n_layers,
          f"train (b): kernel 3 launched {got['relu_ffn']} times in 60 "
          f"steps, expected {cfg.n_layers} a step")
    t0 = time.perf_counter()
    _, _, cinfo = run_training(model, cfg, tcfg, src, steps=60,
                               params=p0_cpu, log_every=1, device="cpu")
    cpu_s = time.perf_counter() - t0
    ce = [m["ce"] for _, m in info["history"]]
    ce_cpu = [m["ce"] for _, m in cinfo["history"]]
    diff = [abs(a - b) for a, b in zip(ce, ce_cpu)]
    check(all(np.isfinite(ce)) and ce[-1] < 0.7 * ce[0]
          and ce_cpu[-1] < 0.7 * ce_cpu[0],
          f"train (b): ce {ce[0]} -> {ce[-1]} on the card, {ce_cpu[0]} -> "
          f"{ce_cpu[-1]} on the CPU, expected a fall below 0.7x")
    check(max(diff[:20]) <= TRAIN_CE_ATOL,
          f"train (b): card and CPU ce differ by {max(diff[:20])} in the "
          f"first 20 steps, beyond {TRAIN_CE_ATOL}")
    # the step's device time, kernels and busy share: 10 steps under the
    # profiler against the same 10 steps unprofiled
    step = make_train_step(cfg, tcfg)
    batches = [{k: torch.as_tensor(v).to(dev)
                for k, v in src.batch_at(i).items()} for i in range(10)]

    def ten(state=(trained, ostate)):
        p, o = state
        for b in batches:
            p, o, _ = step(p, o, b)
        return p
    ten()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ten()
    torch.cuda.synchronize()
    ten_wall = time.perf_counter() - t0
    _, averages = profiled(ten)
    busy = n_events = dev_ms = None
    if averages is not None:
        on_device = device_events(averages)
        dev_ms = sum(e.self_device_time_total for e in on_device) / 1e3 / 10
        n_events = sum(e.count for e in on_device) / 10
        busy = dev_ms * 10 / (ten_wall * 1e3)
    p50, p99 = (float(np.percentile(step_ms, q)) for q in (50, 99))
    out["nectar"] = {
        "ce": ce, "ce_cpu": ce_cpu, "max_diff": max(diff),
        "max_diff_first20": max(diff[:20]), "step_ms": step_ms,
        "step_ms_p50": p50, "step_ms_p99": p99,
        "tokens_per_s": B * S / (p50 / 1e3), "wall_s": info["wall_s"],
        "cpu_wall_s": cpu_s, "launches": got,
        "kernel3_per_step": got["relu_ffn"] / 60,
        "ten_steps_wall_s": ten_wall, "device_ms_per_step": dev_ms,
        "device_events_per_step": n_events, "busy_share": busy}
    print(f"train (b): {cfg.name} 60 steps (B {B}, S {S}, lr 3e-3): ce "
          f"{ce[0]:.4f} -> {ce[-1]:.4f} on the card, {ce_cpu[0]:.4f} -> "
          f"{ce_cpu[-1]:.4f} on the CPU ({cpu_s:.1f} s); card against CPU "
          f"max |ce diff| {max(diff[:20]):.3g} in the first 20 steps, "
          f"{max(diff):.3g} over all 60")
    print(f"train (b): step ms p50 {p50:.3f} p99 {p99:.3f} (host-timed, "
          f"metrics read each step), {B * S / (p50 / 1e3):.0f} tokens/s; "
          f"10 steps {ten_wall * 1e3 / 10:.3f} ms a step unprofiled, device "
          f"{dev_ms} ms a step, busy share "
          + ("not measured" if busy is None else f"{100 * busy:.2f}%")
          + f", {n_events} device events (kernels and copies) a step; "
          f"kernel 3 {got['relu_ffn'] / 60:.0f} launches a step")

    # (c) ReLU sparsity before and after training, batch 0
    tok0 = torch.as_tensor(src.batch_at(0)["tokens"]).to(dev)
    l0 = {"before": layer0_sparsity(p0, tok0, cfg),
          "after": layer0_sparsity(trained, tok0, cfg)}
    per_layer = {"before": ffn_sparsity(model, p0, tok0),
                 "after": ffn_sparsity(model, trained, tok0)}
    check(l0["after"] > 0.45,
          f"train (c): layer-0 ReLU sparsity {l0['after']} after training, "
          f"expected above 0.45")
    out["sparsity"] = {"layer0": l0, "per_layer": per_layer}
    print(f"train (c): layer-0 ReLU sparsity (tests/test_system.py's "
          f"measure) {l0['before']:.4f} -> {l0['after']:.4f}; in the model, "
          f"per layer before " + ", ".join(f"{x:.4f}" for x in
                                           per_layer["before"])
          + "; after " + ", ".join(f"{x:.4f}" for x in per_layer["after"]))

    # (d) resume, preemption, 8-bit Adam
    ck = ROOT / "build" / "train_ckpt"
    import shutil
    shutil.rmtree(ck, ignore_errors=True)
    rcfg = TrainConfig(lr=1e-3, warmup_steps=2, total_steps=6, seed=0)
    rsrc = data.TinyStoriesSynth(data.DataConfig(seq_len=32, batch_size=2,
                                                 vocab_size=cfg.vocab))
    (pA, oA, _), _ = counted(lambda: run_training(
        model, cfg, rcfg, rsrc, steps=6, params=p0, device=dev))
    (pB, oB, _), _ = counted(lambda: run_training(
        model, cfg, rcfg, rsrc, steps=3, params=p0, device=dev))
    checkpoint.save(str(ck / "resume"), 3, {"p": pB, "o": oB}, data_cursor=3)
    restored, man = checkpoint.restore(str(ck / "resume"), 3,
                                       {"p": pB, "o": oB}, device=dev)
    (pC, oC, _), _ = counted(lambda: run_training(
        model, cfg, rcfg, rsrc, steps=6, params=restored["p"],
        opt_state=restored["o"], start_step=man["data_cursor"], device=dev))
    unequal = [i for i, (a, c) in enumerate(zip(leaves(pA) + leaves(oA),
                                                leaves(pC) + leaves(oC)))
               if not torch.equal(a, c)]
    check(not unequal, f"train (d): resume is not bit-exact on the card: "
          f"leaves {unequal} differ")
    guard = fault.PreemptionGuard()
    guard.should_stop = True
    (_, _, pinfo), _ = counted(lambda: run_training(
        model, cfg, rcfg, rsrc, steps=10, params=p0, guard=guard,
        on_checkpoint=lambda s, p, o: checkpoint.save(
            str(ck / "preempt"), s, {"params": p, "opt": o}, data_cursor=s),
        device=dev))
    check(pinfo["steps_done"] == 1
          and checkpoint.latest_step(str(ck / "preempt")) == 1,
          f"train (d): the preemption guard stopped after "
          f"{pinfo['steps_done']} steps with checkpoint "
          f"{checkpoint.latest_step(str(ck / 'preempt'))}")
    finals, sizes = {}, {}
    for eight in (False, True):
        acfg = TrainConfig(lr=3e-3, warmup_steps=5, total_steps=50, seed=0,
                           adam_8bit=eight)
        (_, ost, ainfo), _ = counted(lambda: run_training(
            model, cfg, acfg, src, steps=50, params=p0, log_every=49,
            device=dev))
        finals[eight] = ainfo["history"][-1][1]["ce"]
        sizes[eight] = opt.state_bytes(ost)
    gap = abs(finals[True] - finals[False]) / finals[False]
    check(gap < 0.2, f"train (d): 8-bit Adam's final ce {finals[True]} "
          f"against fp32 Adam's {finals[False]}: {gap:.3f} apart")
    out["resume"] = {"bit_exact": True, "preempt_steps": pinfo["steps_done"],
                     "adam_final_ce": finals[False],
                     "adam8_final_ce": finals[True], "adam8_gap": gap,
                     "adam_state_bytes": sizes[False],
                     "adam8_state_bytes": sizes[True]}
    print(f"train (d): 6 steps straight equal 3 + save + restore + 3 bit "
          f"for bit (params and optimizer state); the preemption guard "
          f"stopped after 1 step with a checkpoint; 50 steps fp32 Adam ce "
          f"{finals[False]:.4f}, 8-bit Adam {finals[True]:.4f} "
          f"({100 * gap:.2f}% apart); optimizer state {sizes[False]} B fp32, "
          f"{sizes[True]} B int8")

    # (e) serve the trained checkpoint through kernels 1 and 2
    checkpoint.save(str(ck / "serve"), 60, {"params": trained,
                                            "opt": ostate}, data_cursor=60)
    served = checkpoint.restore_params(
        str(ck / "serve"), checkpoint.latest_step(str(ck / "serve")),
        model.init(torch.Generator(), device="meta"), device=dev)
    check(all(torch.equal(a, b) for a, b in zip(leaves(served),
                                                leaves(trained))),
          "train (e): the checkpoint's params differ from the trained ones")
    engine = Engine(cfg, served, scfg, device=dev)
    ticks, _, _ = recording_engine(engine)
    (tokens, rids, wall, summary, slaunches) = serve(engine, prompts,
                                                     max_new)
    for key in KERNELS:
        launches[key] += slaunches[key]
    steps = engine.runner.n_steps
    check(slaunches["paged_attention"] == cfg.n_layers * steps > 0
          and slaunches["sparse_gather_matvec"] == cfg.n_layers * steps,
          f"train (e): the trained serve launched {slaunches} in {steps} "
          f"steps, expected kernels 1 and 2 once per layer per step")
    check_tokens("train (e)", tokens, cfg, max_new, ticks)
    cpu_engine = Engine(cfg, tree_map(lambda t: t.cpu(), served), scfg,
                        device="cpu")
    _, _, cpu_margins = recording_engine(cpu_engine)
    cpu_tokens, cpu_rids, _, _, _ = serve(cpu_engine, prompts, max_new)
    flips = compare_cpu("train (e)", tokens, cpu_tokens, cpu_margins,
                        cpu_rids)
    tps_random, rparams, rtokens = paged_run

    def served_sparsity(params, toks):
        seqs = [np.concatenate([p, np.asarray(t, np.int32)])
                for p, t in zip(prompts, toks)]
        fr = [ffn_sparsity(model, params,
                           torch.as_tensor(s[None]).to(dev)) for s in seqs]
        return float(np.mean(fr))
    spars = {"trained": served_sparsity(served, tokens),
             "random": served_sparsity(rparams, rtokens)}
    out["serve"] = dict(summary, wall_s=wall, steps=steps,
                        launches=slaunches, flips=flips,
                        tokens_per_s_random=tps_random,
                        ffn_sparsity=spars)
    print_serve("train (e) trained checkpoint", len(prompts), summary, wall,
                steps, slaunches)
    print(f"train (e): {len(prompts) - len(flips)}/{len(prompts)} requests "
          f"token-identical card against CPU, near-tie flips {flips}; "
          f"{summary['tokens_per_s']:.1f} tok/s against "
          f"{tps_random:.1f} for the random weights (phase 5, same "
          f"prompts); FFN ReLU sparsity over the served sequences "
          f"{spars['trained']:.4f} trained, {spars['random']:.4f} random")

    # (f) llama3.2-1b at full width, f32: 2 of 16 layers card against CPU,
    # then the full depth on the card alone with 8-bit Adam
    lfull = dataclasses.replace(get_config("llama3.2-1b"), dtype="float32")
    lcut = dataclasses.replace(lfull, n_layers=2)
    lsrc = data.TinyStoriesSynth(data.DataConfig(seq_len=64, batch_size=2,
                                                 vocab_size=lfull.vocab))
    lb = {k: torch.as_tensor(v) for k, v in lsrc.batch_at(0).items()}
    lp = Model(lcut).init(torch.Generator(device=dev).manual_seed(SEED),
                          device=dev)
    loss, _, lg = value_and_grad(lp, lcut, {k: v.to(dev)
                                           for k, v in lb.items()})
    lg = tree_map(lambda t: t.cpu(), lg)
    t0 = time.perf_counter()
    closs, _, cg = value_and_grad(tree_map(lambda t: t.cpu(), lp), lcut, lb)
    lcpu_s = time.perf_counter() - t0
    gerr = max(rel_err(c, g) for c, g in zip(leaves(cg), leaves(lg)))
    lerr = abs(float(loss) - float(closs))
    check(lerr <= 1e-4 and gerr <= 1e-3,
          f"train (f): llama3.2-1b (2 layers) loss {float(loss)} against "
          f"the CPU's {float(closs)}, worst gradient leaf {gerr}")
    del lp, lg, cg
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    # lr 1e-5: Adam's first updates move every weight by about lr at once,
    # and from random weights the 16-layer stack overshot at the second
    # step on an H100 (ce 12.08 -> 9.48 -> 14.11 at 1e-3, 12.08 -> 9.06 ->
    # 16.77 at 3e-4 after a 3-step warm-up; fp32 Adam alike)
    fcfg = TrainConfig(lr=1e-5, warmup_steps=0, total_steps=3, seed=0,
                       adam_8bit=True)
    ltimed = TimedSource(lsrc)
    t0 = time.perf_counter()
    lparams = Model(lfull).init(torch.Generator(device=dev).manual_seed(SEED),
                                device=dev)
    init_s = time.perf_counter() - t0
    _, lstate, linfo = run_training(Model(lfull), lfull, fcfg, ltimed,
                                    steps=3, params=lparams, log_every=1,
                                    device=dev)
    lms = step_times_ms(ltimed, time.perf_counter())
    peak = torch.cuda.max_memory_allocated(dev)
    lce = [m["ce"] for _, m in linfo["history"]]
    check(all(np.isfinite(lce)) and lce[-1] < lce[0],
          f"train (f): llama3.2-1b full depth, 8-bit Adam: ce {lce}, "
          f"expected finite and falling")
    n_params = Model(lfull).param_count(lparams)
    out["llama"] = {"cut_loss": float(loss), "cut_loss_cpu": float(closs),
                    "cut_loss_err": lerr, "cut_grad_rel_err": gerr,
                    "cut_cpu_s": lcpu_s, "ce": lce, "step_ms": lms,
                    "peak_bytes": peak, "params": n_params,
                    "init_s": init_s,
                    "adam8_state_bytes": opt.state_bytes(lstate)}
    del lparams, lstate
    torch.cuda.empty_cache()
    print(f"train (f): llama3.2-1b f32 at full width, 2 of 16 layers, B 2 S "
          f"64: loss {float(loss):.6f}, {lerr:.3g} from the CPU's, worst "
          f"gradient leaf {gerr:.3g} relative (CPU {lcpu_s:.1f} s); 16 "
          f"layers ({n_params} params), 3 steps of 8-bit Adam: ce "
          + " -> ".join(f"{x:.4f}" for x in lce)
          + f", step ms " + ", ".join(f"{x:.1f}" for x in lms)
          + f", peak memory {peak / 2 ** 30:.2f} GiB, optimizer state "
          f"{out['llama']['adam8_state_bytes'] / 2 ** 30:.2f} GiB")
    return out, launches


def pool_shard_bytes(engine):
    """Bytes of each shard's slice of the engine's block pools (the pools
    proper, not the trash blocks behind them), in shard order; one entry
    for a meshless engine."""
    from repro_torch.dist.sharding import Sharded
    n = engine.mesh.size if engine.mesh is not None else 1
    out = [0] * n
    for pools in engine.runner.cache["units"].values():
        for leaf in pools.values():
            parts = leaf.shards if isinstance(leaf, Sharded) else [leaf]
            for i, t in enumerate(parts):
                out[i] += t.numel() * t.element_size()
    return out


def param_shard_bytes(params, n):
    """Bytes of each shard's block of a placed param tree; a replicated
    leaf counts on the home shard (0), where it lives."""
    from repro_torch.dist.sharding import Sharded
    from repro_torch.tree import leaves
    out = [0] * n
    for leaf in leaves(params):
        if isinstance(leaf, Sharded):
            for i, t in enumerate(leaf.shards):
                out[i] += t.numel() * t.element_size()
        else:
            out[0] += leaf.numel() * leaf.element_size()
    return out


def mesh_train_check(dev, smi, cfg, add):
    """Phase 22 (d): three steps of ``compile_train_step`` for nectar on a
    (data 2, model 2) mesh of ``dev`` against the unsharded step from the
    same params. The ce agrees within 1e-4 at each step and kernel 3 runs
    n_layers times a data shard. The params agree within 1e-4 but for the
    FFN units that flipped: a unit whose pre-activation x . w_up (the
    f32 product kernel 3's backward recomputes for its ReLU mask, each
    call recorded here at its own shape: 256 rows a data shard, 512
    unsharded) is > 0 in one run and not in the other for some row at
    some step. Such a unit's dh differs by a whole dy . w_down term, and
    Adam's first updates, ~lr * sign(g), part by up to 2 lr a step, so
    its column of w_up and row of w_down are held to 2 x the steps'
    summed lr. The flipped units are printed with their largest |x .
    w_up| at the rows that flipped, over that entry's sum |x| . |w_up|
    (the rounding scale). ``add`` takes the sharded runs' launches.
    Returns (details, the sharded params, their gathered tree)."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.dist import sharding as shd
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Model
    from repro_torch.train import data, loop
    from repro_torch.train import optimizer as opt

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()
    tcfg = TrainConfig(lr=3e-3, warmup_steps=5, total_steps=60, seed=0)
    src = data.TinyStoriesSynth(data.DataConfig(seq_len=64, batch_size=8,
                                                vocab_size=cfg.vocab))
    tparams = Model(cfg).init(torch.Generator(device=dev).manual_seed(SEED),
                              device=dev)
    state = opt.adam_init(tparams)
    batches = [{k: torch.as_tensor(v).to(dev)
                for k, v in src.batch_at(i).items()} for i in range(3)]
    mesh22 = make_mesh((2, 2), ("data", "model"), [dev] * 4)
    fn, (p_sh, o_sh, x_sh) = loop.compile_train_step(
        cfg, tcfg, mesh22, tparams, state, batches[0])
    P = shd.shard_tree(tparams, p_sh, mesh22)
    O = shd.shard_tree(state, o_sh, mesh22)
    up = P["units"]["b0"]["ffn"]["w_up"]
    slices = {id(t): tuple(t.shape) for t in up.shards}
    check(sorted(slices.values()) == [(cfg.n_units, 128, 320)] * 2,
          f"mesh train: w_up stored as {sorted(slices.values())}")
    step = loop.make_train_step(cfg, tcfg)
    p1, s1 = tparams, state
    ce_diff, k3 = [], []
    t_sharded = t_plain = 0.0
    real = ops.relu_ffn_fused
    calls = []

    def recording(x, w_up, w_down):
        with torch.no_grad():
            xd, wd = x.detach(), w_up.detach()
            calls.append((torch.matmul(xd, wd),
                          torch.matmul(xd.abs(), wd.abs())))
        return real(x, w_up, w_down)
    L = cfg.n_layers
    flipped = torch.zeros(L, cfg.d_ff, dtype=torch.bool, device=dev)
    rel = torch.zeros(L, cfg.d_ff, device=dev)
    ops.relu_ffn_fused = recording
    try:
        for batch in batches:
            X = shd.shard_tree(batch, x_sh, mesh22)
            for key in ops.LAUNCHES:
                ops.LAUNCHES[key] = 0
            calls.clear()
            t0 = time.perf_counter()
            P, O, m = fn(P, O, X)
            sync()
            t_sharded += time.perf_counter() - t0
            got = dict(ops.LAUNCHES)
            add(got)
            k3.append(got["relu_ffn"])
            sharded = list(calls)
            calls.clear()
            t0 = time.perf_counter()
            p1, s1, m1 = step(p1, s1, batch)
            sync()
            t_plain += time.perf_counter() - t0
            ce_diff.append(abs(float(m["ce"]) - float(m1["ce"])))
            # the data shards run one after the other, layers in order:
            # shard 0's rows are the first half of the unsharded step's
            check(len(sharded) == 2 * L and len(calls) == L,
                  f"mesh train: {len(sharded)} and {len(calls)} FFN calls")
            for layer in range(L):
                hs = torch.cat([sharded[layer][0], sharded[L + layer][0]])
                ss = torch.cat([sharded[layer][1], sharded[L + layer][1]])
                hp, sp = calls[layer]
                flip = (hs > 0) != (hp > 0)
                size = torch.maximum(hs.abs(), hp.abs()) \
                    / torch.maximum(ss, sp).clamp_min(1e-30)
                flipped[layer] |= flip.any(dim=0)
                rel[layer] = torch.maximum(
                    rel[layer], torch.where(flip, size, 0).amax(dim=0))
    finally:
        ops.relu_ffn_fused = real
    check(max(ce_diff) <= 1e-4, f"mesh train: ce differs by {ce_diff}")
    check(k3 == [2 * L] * 3,
          f"mesh train: kernel 3 launched {k3} times a step, expected "
          f"{L} a data shard")
    whole = shd.gather_tree(P)
    lr_sum = sum(float(opt.lr_schedule(tcfg, torch.tensor(t)))
                 for t in (1, 2, 3))
    units = [(int(i), int(j), float(rel[i, j]))
             for i, j in flipped.nonzero().tolist()]
    p_err = exempt_err = 0.0
    n_exempt = n_all = 0
    over = []
    pairs = []
    shd.map_with(lambda a, b: pairs.append((a, b)), whole, p1)
    names = []
    shd.map_with_path(lambda path, leaf: names.append("/".join(path)),
                      whole)
    for name, (a, b) in zip(names, pairs):
        d = (a - b).abs()
        ex = torch.zeros_like(d, dtype=torch.bool)
        if name.endswith("ffn/w_up"):            # [U, d, d_ff]
            ex |= flipped[:, None, :]
        elif name.endswith("ffn/w_down"):        # [U, d_ff, d]
            ex |= flipped[:, :, None]
        n_exempt += int(ex.sum())
        n_all += d.numel()
        p_err = max(p_err, float(d[~ex].max()))
        if ex.any():
            exempt_err = max(exempt_err, float(d[ex].max()))
        for idx in (d > 1e-4).nonzero().tolist()[:8]:
            over.append((name, idx, float(d[tuple(idx)]),
                         bool(ex[tuple(idx)])))
    print(f"mesh train: nectar on (data 2, model 2), B 8 x S 64, 3 steps: ce "
          f"within {max(ce_diff):.3g} of the unsharded card step; FFN units "
          f"whose ReLU mask differs between the runs (layer, unit, largest "
          f"|x . w_up| at a flipped row over its sum |x| . |w_up|): "
          f"{units}; params within {p_err:.3g} outside those units' w_up "
          f"columns and w_down rows ({n_exempt} of {n_all} elements), "
          f"within {exempt_err:.3g} inside (2 x the steps' lr "
          f"{2 * lr_sum:.3g}); elements past 1e-4 (leaf, index, diff, in a "
          f"flipped unit): {over}; kernel 3 {k3} launches a step; step "
          f"{1e3 * t_sharded / 3:.2f} ms (unsharded {1e3 * t_plain / 3:.2f}"
          f" ms) [{smi}]")
    check(p_err <= 1e-4 and exempt_err <= 2 * lr_sum,
          f"mesh train: params differ by {p_err} outside the flipped units "
          f"{units}, by {exempt_err} inside")
    return dict(ce_diff=ce_diff, param_err=p_err,
                flipped_units=units, flipped_unit_err=exempt_err,
                flipped_unit_elements=n_exempt, n_params=n_all,
                past_1e4=over, kernel3_launches=k3,
                step_ms=1e3 * t_sharded / 3,
                unsharded_step_ms=1e3 * t_plain / 3), P, whole


def mesh_phase(dev, smi, cfg, params, scfg, prompts, max_new, prefix_prompts,
               int8_run, cpu_runs, rows, profs):
    """Phase 22: sharded serving and training, every mesh ``[dev] * n``
    (one controller, n shards on the card). ``int8_run``: phase 11's
    (scfg, card tokens, card rids, card margins, launches) of the
    unsharded int8 naive serve; ``cpu_runs``: the CPU's unsharded serves
    each sharded serve is held to, (tokens, margins, rids) by setting:
    "naive" phase 6's paged serve, "int8" phase 11's, "spec" phase 9's
    prefix-cache serve (greedy speculation commits the tokens of plain
    greedy decoding); ``rows``: phase 3's rows (kernel 2's at the shards'
    shapes are printed here); ``profs``: phase 13's profiled serves of
    the unsharded naive setting ("naive") and of the model-4 mesh (4),
    whose busy shares are printed beside the serves here. Returns
    (details, the launches of the phase's sharded runs)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import MeshConfig, SpecConfig
    from repro_torch.dist import collectives, elastic
    from repro_torch.dist import sharding as shd
    from repro_torch.dist.ring import ring_attention
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Model, flash
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.fleet import Fleet
    from repro_torch.tree import leaves
    out, total = {}, {key: 0 for key in KERNELS}
    clock = [time.perf_counter()]

    def add(launches):
        for key in KERNELS:
            total[key] += launches[key]

    def part(name):
        now = time.perf_counter()
        print(f"time: 22 {name} {now - clock[-1]:.1f} s")
        clock.append(now)

    # (a) nectar at full width, paged, the naive read: the unsharded card
    # serve of each setting, then the sharded ones
    naive = dataclasses.replace(scfg, attn_backend="naive")
    spec_pre = dataclasses.replace(
        naive, prefix_cache=True,
        spec=SpecConfig(drafter="ngram", k=4, k_max=8))
    q8_scfg, q8_tokens, q8_rids, q8_margins, q8_launches = int8_run

    def baseline(sc, ps):
        """(tokens, rids, margins, launches, summary, wall) of the
        unsharded card serve of ``sc``."""
        eng = Engine(cfg, params, sc, device=dev)
        margins = (recording_spec_engine(eng)[1] if sc.spec is not None
                   else recording_engine(eng)[2])
        toks, rids, wall, summ, launches = serve(eng, ps, max_new)
        return toks, rids, margins, launches, summ, wall

    base = {"naive": baseline(naive, prompts),
            "spec": baseline(spec_pre, prefix_prompts),
            "int8": (q8_tokens, q8_rids, q8_margins, q8_launches, None,
                     None)}
    b = base["naive"]
    flips = compare_cpu("mesh: naive card vs CPU", b[0], *cpu_runs["naive"])
    print(f"mesh: unsharded naive serve {b[4]['tokens_per_s']:.1f} tok/s, "
          f"TPOT p50 {b[4]['tpot_p50_ms']:.3f} ms, {b[5]:.3f} s [{smi}]; "
          f"against the CPU near-tie flips {flips}")
    base_prof = profs["naive"]
    cases = (("model 2", 2, False, naive, prompts, "naive"),
             ("model 4", 4, False, naive, prompts, "naive"),
             ("model 4 kv_seq", 4, True, naive, prompts, "naive"),
             ("model 2 int8", 2, False, q8_scfg, prompts, "int8"),
             ("model 4 ngram prefix", 4, False, spec_pre, prefix_prompts,
              "spec"))
    out["serves"] = {}
    for label, n, kv_seq, sc, ps, key in cases:
        msc = dataclasses.replace(sc, mesh=MeshConfig(
            model=n, shard_kv_seq=kv_seq))
        eng = Engine(cfg, params, msc, device=[dev] * n)
        toks, rids, wall, summ, launches = serve(eng, ps, max_new)
        add(launches)
        steps = eng.runner.n_steps
        bt, brids, bm, bl, _, _ = base[key]
        check(launches["sparse_gather_matvec"]
              == n * cfg.n_layers * steps > 0
              and launches["paged_attention"] == 0,
              f"mesh {label}: launches {launches} in {steps} steps, "
              f"expected kernel 2 {n} x {cfg.n_layers} a step")
        card_flips = compare_cpu(f"mesh {label} vs unsharded card", toks,
                                 bt, bm, brids)
        cpu_flips = compare_cpu(f"mesh {label} vs CPU", toks,
                                *cpu_runs[key])
        if toks == bt:
            check(launches["sparse_gather_matvec"]
                  == n * bl["sparse_gather_matvec"],
                  f"mesh {label}: kernel 2 launched "
                  f"{launches['sparse_gather_matvec']} times, the "
                  f"unsharded serve {bl['sparse_gather_matvec']}")
        pool = summ["kv_pool"]
        shard_bytes = pool_shard_bytes(eng)
        check(pool["model_shards"] == n
              and pool["per_shard_capacity_bytes"] * n
              == pool["capacity_bytes"]
              and pool["per_shard_used_bytes"] * n == pool["used_bytes"]
              and shard_bytes == [shard_bytes[0]] * n
              and sum(shard_bytes) == sum(pool_shard_bytes(
                  Engine(cfg, params, sc, device=dev))),
              f"mesh {label}: the per-shard pool bytes {shard_bytes} "
              f"({pool}) do not tile the pool")
        check(summ["mesh"]["shape"] == {"data": 1, "model": n}
              and summ["mesh"]["kv_pool_shards"] == n
              and summ["mesh"]["shard_kv_seq"] == kv_seq,
              f"mesh {label}: summary mesh {summ['mesh']}")
        prof = profs[4] if label == "model 4" else None
        busy = None if prof is None else prof["busy_share"]
        k2_ms = None if prof is None \
            else prof["kernel_device_ms"].get("sparse_gather_matvec")
        print(f"mesh {label}: {summ['tokens_per_s']:.1f} tok/s (unsharded "
              f"naive {b[4]['tokens_per_s']:.1f}), TPOT p50 "
              f"{summ['tpot_p50_ms']:.3f} ms ({b[4]['tpot_p50_ms']:.3f}), "
              f"busy share {busy} ({base_prof['busy_share']}; phase 13's "
              f"windows), {steps} "
              f"steps, kernel 2 {launches['sparse_gather_matvec']} "
              f"launches (device ms a launch {k2_ms}), pool bytes a "
              f"shard {shard_bytes[0]} [{smi}]; "
              f"flips against the unsharded card {card_flips}, against "
              f"the CPU {cpu_flips}")
        out["serves"][label] = dict(
            tokens_per_s=summ["tokens_per_s"], tpot_p50_ms=summ["tpot_p50_ms"],
            wall_s=wall, steps=steps, launches=launches, busy_share=busy,
            kernel2_device_ms=k2_ms,
            pool_bytes_per_shard=shard_bytes[0], card_flips=card_flips,
            cpu_flips=cpu_flips, mesh=summ["mesh"])
    out["unsharded_naive"] = dict(
        tokens_per_s=b[4]["tokens_per_s"], tpot_p50_ms=b[4]["tpot_p50_ms"],
        wall_s=b[5], busy_share=base_prof["busy_share"], launches=b[3],
        kernel2_device_ms=base_prof["kernel_device_ms"].get(
            "sparse_gather_matvec"))

    part("(a) nectar serves")

    # (b) llama3.2-1b at full width in f32, cut to 2 of 16 layers, model 4
    lcfg = dataclasses.replace(get_config("llama3.2-1b"), n_layers=2,
                               dtype="float32")
    lparams = Model(lcfg).init(torch.Generator(device=dev).manual_seed(
        SEED + 23), device=dev)
    lrng = np.random.default_rng(SEED + 23)
    lprompts = [lrng.integers(0, lcfg.vocab, int(n), dtype=np.int32)
                for n in lrng.integers(16, 65, 4)]
    lsc = dataclasses.replace(naive, max_batch=4, max_seq=128)
    lbase = Engine(lcfg, lparams, lsc, device=dev)
    _, _, lmargins = recording_engine(lbase)
    ltoks, lrids, lwall, lsum, _ = serve(lbase, lprompts, 16)
    del lbase
    leng = Engine(lcfg, lparams, dataclasses.replace(
        lsc, mesh=MeshConfig(model=4)), device=[dev] * 4)
    ltoks4, _, lwall4, lsum4, l4_launches = serve(leng, lprompts, 16)
    add(l4_launches)
    lflips = compare_cpu("mesh llama3.2-1b model 4 vs unsharded card",
                         ltoks4, ltoks, lmargins, lrids)
    # the tied head's layouts side by side in this run, alternated: split
    # on its vocab rows (the serving layout) against split on d and
    # gathered whole for every step's logits (the layout it replaced)
    lold = Engine(lcfg, lparams, leng.scfg, device=[dev] * 4)
    lold.runner.params["embed"] = shd.place(
        lparams["embed"], (None, "model"), lold.runner.mesh)
    tied_tpot = {"rows": [lsum4["tpot_p50_ms"]], "gathered": []}
    for layout, e in (("gathered", lold), ("gathered", lold),
                      ("rows", leng)):
        t, _, _, sm, _ = serve(e, lprompts, 16)
        compare_cpu(f"mesh llama3.2-1b model 4 ({layout} tied head) vs "
                    f"unsharded card", t, ltoks, lmargins, lrids)
        tied_tpot[layout].append(sm["tpot_p50_ms"])
    del lold
    print(f"mesh llama3.2-1b model 4, the tied head split on its vocab rows"
          f" / on d and gathered a step, alternated: TPOT p50 "
          f"{tied_tpot['rows']} / {tied_tpot['gathered']} ms [{smi}]")
    pbytes = param_shard_bytes(leng.runner.params, 4)
    kbytes = pool_shard_bytes(leng)
    check(leng.pool.model_shards == 4 and kbytes == [kbytes[0]] * 4,
          f"mesh llama3.2-1b: pool shards {kbytes}")
    print(f"mesh llama3.2-1b (f32, d 2048, 32/8 heads, d_ff 8192, vocab "
          f"128256, 2 of 16 layers) at model 4: {lsum4['tokens_per_s']:.1f}"
          f" tok/s (unsharded {lsum['tokens_per_s']:.1f}), TPOT p50 "
          f"{lsum4['tpot_p50_ms']:.3f} ms ({lsum['tpot_p50_ms']:.3f}) "
          f"[{smi}]; param bytes a shard {pbytes} (replicated leaves on "
          f"shard 0), pool bytes a shard {kbytes[0]}; flips against the "
          f"unsharded card {lflips}")
    out["llama"] = dict(tokens_per_s=lsum4["tokens_per_s"],
                        unsharded_tokens_per_s=lsum["tokens_per_s"],
                        tpot_p50_ms=lsum4["tpot_p50_ms"],
                        tied_head_tpot_p50_ms=tied_tpot,
                        param_bytes_per_shard=pbytes,
                        pool_bytes_per_shard=kbytes[0], flips=lflips)
    del leng, lparams
    torch.cuda.empty_cache()

    part("(b) llama3.2-1b")

    # (c) the collectives on the card against the plain attention
    mesh4 = make_mesh((4,), ("model",), [dev] * 4)
    crng = np.random.default_rng(SEED + 24)

    def card(*shape):
        return torch.tensor(crng.standard_normal(shape), dtype=torch.float32,
                            device=dev)
    B, Kv, G, Dh, S = 4, 8, 4, 64, 4096
    q, k, v = card(B, Kv, G, Dh), card(B, S, Kv, Dh), card(B, S, Kv, Dh)
    kv_len = torch.tensor(crng.integers(1, S + 1, B), dtype=torch.int32,
                          device=dev)
    got = collectives.lse_combine_decode_attention(mesh4, q, k, v, kv_len)
    want = flash.reference_attention(q[:, None], k, v, causal=False,
                                      kv_len=kv_len)[:, 0]
    lse_err = (got - want).abs().max().item()
    check(lse_err <= 2e-5, f"mesh: lse_combine differs by {lse_err}")
    lse_ms = time_ms(lambda: collectives.lse_combine_decode_attention(
        mesh4, q, k, v, kv_len), iters=10, warmup=1)
    rq, rk, rv = card(1, 2048, 8, 4, 64), card(1, 2048, 8, 64), \
        card(1, 2048, 8, 64)
    ring_err, ring_ms = {}, {}
    for causal in (True, False):
        got = ring_attention(mesh4, rq, rk, rv, causal=causal)
        want = flash.reference_attention(rq, rk, rv, causal=causal)
        ring_err[causal] = (got - want).abs().max().item()
        check(ring_err[causal] <= 3e-5,
              f"mesh: ring attention (causal {causal}) differs by "
              f"{ring_err[causal]}")
        ring_ms[causal] = time_ms(lambda c=causal: ring_attention(
            mesh4, rq, rk, rv, causal=c), iters=5, warmup=1)
    print(f"mesh: lse_combine at model 4 (B 4, Kv 8, G 4, Dh 64, S 4096) "
          f"max_abs_err {lse_err:.3g}, {lse_ms:.3f} ms; ring attention at "
          f"model 4 (S 2048) causal {ring_err[True]:.3g} "
          f"{ring_ms[True]:.3f} ms, non-causal {ring_err[False]:.3g} "
          f"{ring_ms[False]:.3f} ms [{smi}]")
    out["collectives"] = dict(lse_err=lse_err, lse_ms=lse_ms,
                              ring_err=ring_err, ring_ms=ring_ms)
    del q, k, v, rq, rk, rv

    part("(c) collectives")

    # (d) the sharded train step: nectar on a (data 2, model 2) mesh
    out["train"], P, whole = mesh_train_check(dev, smi, cfg, add)
    back = elastic.reshard_params(P, cfg, make_mesh(
        (1, 2), ("data", "model"), [dev] * 2))
    check(all(torch.equal(a, b) for a, b in zip(
        leaves(shd.gather_tree(back)), leaves(whole))),
          "mesh train: reshard_params (2, 2) -> (1, 2) changed a value")
    print("mesh train: reshard_params (2, 2) -> (1, 2) bit-equal")
    fsc = dataclasses.replace(naive, max_batch=2, mesh=MeshConfig(model=2))
    fleet = Fleet(cfg, params, fsc, n_replicas=2, device=[dev] * 2)
    victims = fleet.scale_down(1)
    reaped = [r.id for r in fleet.reap()]
    n_resharded = fleet.reshard_surviving()
    check(victims == [1] and reaped == [1] and n_resharded == 1,
          f"mesh fleet: scale_down {victims}, reaped {reaped}, "
          f"reshard_surviving {n_resharded}")
    print(f"mesh fleet: two model-2 replicas, scale_down(1) drained "
          f"{victims}, reap retired {reaped}, reshard_surviving() = "
          f"{n_resharded}")

    part("(d) training, elastic, fleet")
    for r in rows["sparse_gather_matvec"]:
        if "shard of model" in r["case"]:
            print(f"mesh: kernel 2 {r['case']} (phase 3): device "
                  f"{r['device_ms']} ms, bound {r['bound_ms']:.3g} ms "
                  f"({r['bound_by']}), embedding_bag "
                  f"{r['library_device_ms']} ms, max_abs_err "
                  f"{r['max_abs_err']:.3g} [{smi}]")
    out["launches"] = dict(total)
    return out, total


def main():
    details = {}
    clock = [time.perf_counter()]

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

    lap(clock, "2) build")

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
    # d_head 16 (llama3.2-1b-smoke: Hq 4, Kv 2, bs 16) and bf16 pools at
    # nectar's shape, from a stream of their own
    nrng = np.random.default_rng(SEED + 3)
    smoke_attn = dict(B=8, Hq=4, Kv=2, Dh=16, bs=16, MB=128, max_ctx=232)
    rows["paged_attention"] += [
        run_attention(dev, nrng, f"llama3.2-1b-smoke Dh16 S={S}", S=S,
                      **smoke_attn) for S in (1, 32)]
    rows["paged_attention"] += [
        run_attention(dev, nrng, f"nectar bf16 pools S={S}", S=S,
                      pool_dtype=torch.bfloat16, **nectar_attn)
        for S in (1, scfg.prefill_chunk)]
    rows["decode_attention"] += [
        run_decode(dev, nrng, f"llama3.2-1b-smoke Dh16 {dt}", B=8, S=S,
                   Hq=4, Kv=2, Dh=16, kv_len=serve_len, dtype=dtype)
        for dt, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16))]
    # phase 18 (a): zamba2-2.7b's shared attention through the slot engine
    # (B 4, Hq = Kv = 32, Dh 80, S 512, f32 K/V, kv_len 1-192), from a
    # stream of its own
    zrng = np.random.default_rng(SEED + 11)
    zcfg = get_config("zamba2-2.7b")
    rows["decode_attention"] += [
        run_decode(dev, zrng, f"{zcfg.name} shared attention Dh80 f32",
                   B=4, S=512, Hq=zcfg.n_heads, Kv=zcfg.n_kv_heads,
                   Dh=zcfg.d_head, kv_len=list(zrng.integers(1, 193, 4)),
                   dtype=torch.float32)]
    # phase 19 (b): kernel 1 at Dh 128, f32 pools, at the head groupings
    # of the new paged configs (G 4 qwen3-4b, G 8 qwen2.5-3b, G 5
    # llama4-maverick, G 1 moonshot), decode rows (S = 1) and verify rows
    # (S = 4), at the full-width serves' shape (B 4, bs 16, MB 32: max_seq
    # 512, contexts to 145), from a stream of its own
    grng = np.random.default_rng(SEED + 18)
    for cname, Hq, Kv in (("qwen3-4b", 32, 8), ("qwen2.5-3b", 16, 2),
                          ("llama4-maverick", 40, 8),
                          ("moonshot-v1-16b-a3b", 16, 16)):
        for S in (1, 4):
            row = run_attention(dev, grng, f"{cname} G{Hq // Kv} Dh128 S={S}",
                                exact=True, S=S, B=4, Hq=Hq, Kv=Kv, Dh=128,
                                bs=16, MB=32, max_ctx=145 + S)
            check(row["f64_excess"] <= FAMILY_ATOL,
                  f"{row['case']}: paged_attention differs by "
                  f"{row['f64_err']} from its plain version in f64, beyond "
                  f"{FAMILY_ATOL} + {FAMILY_RTOL} of it")
            rows["paged_attention"].append(row)
    # phase 20 (d): kernel 1 at musicgen-medium's head grouping (Hq = Kv =
    # 24, Dh 64, G 1) and qwen2-vl-72b's (Hq 64 / Kv 8, Dh 128, G 8), f32
    # pools, decode rows at the full-width serves' shape (B 4, bs 16, MB
    # 32: max_seq 512, contexts to 145), and kernel 5 at musicgen-medium's
    # slot decode (B 4, S 512, f32 cache, kv_len 33-145), from a stream
    # of their own; each within FRONTEND_ATOL of its plain version
    frng = np.random.default_rng(SEED + 24)
    for cname, Hq, Kv, Dh in (("musicgen-medium", 24, 24, 64),
                              ("qwen2-vl-72b", 64, 8, 128)):
        rows["paged_attention"].append(run_attention(
            dev, frng, f"{cname} G{Hq // Kv} Dh{Dh} S=1", exact=True, S=1,
            B=4, Hq=Hq, Kv=Kv, Dh=Dh, bs=16, MB=32, max_ctx=146))
    rows["decode_attention"].append(run_decode(
        dev, frng, "musicgen-medium slot Dh64 f32", B=4, S=512, Hq=24, Kv=24,
        Dh=64, kv_len=list(frng.integers(33, 146, 4)), dtype=torch.float32))
    for row in (rows["paged_attention"][-2:] + rows["decode_attention"][-1:]):
        check(row["max_abs_err"] <= FRONTEND_ATOL,
              f"{row['case']}: max_abs_err {row['max_abs_err']} against the "
              f"plain version, beyond {FRONTEND_ATOL}")
    # the shapes speculative decoding gives kernels 1, 2 and 5 (phase 14),
    # from a stream of their own: nectar verify rows at k_max 4 and 8; the
    # draft model's step with rows parked at lens = max_seq; the gathers of
    # the verify rows, of the draft model and of self-spec's predicted
    # down rows (k = 32 of 640)
    vrng = np.random.default_rng(SEED + 5)
    rows["paged_attention"] += [
        run_attention(dev, vrng, f"nectar verify S={S}", S=S, **nectar_attn)
        for S in (5, 9)]
    dcfg = get_config(DRAFT_NAME)
    parked = [int(x) for x in vrng.integers(1, 233, slot_scfg.max_batch)]
    for b in (3, 5, 7):
        parked[b] = S + 1                  # parked: lens = max_seq
    rows["decode_attention"] += [
        run_decode(dev, vrng, "draft model, 3 of 8 rows parked", B=8, S=S,
                   Hq=dcfg.n_heads, Kv=dcfg.n_kv_heads, Dh=dcfg.d_head,
                   kv_len=parked, dtype=torch.float32)]
    rows["sparse_gather_matvec"] += [
        run_sparse(dev, vrng, label, B=B, k=k, d_ff=f, d=d, empty_frac=0.1)
        for label, B, k, f, d in (
            ("nectar verify rows=72", scfg.max_batch * 9, k_nectar,
             cfg.d_ff, cfg.d_model),
            ("draft model rows=8", 8, 128, dcfg.d_ff, dcfg.d_model),
            ("selfspec predicted rows=8", 8, 32, cfg.d_ff, cfg.d_model))]
    # phase 22: kernel 2 on a shard's column block of W_down ([640, 64] at
    # model 2, [640, 32] at model 4), from a stream of its own
    mrng = np.random.default_rng(SEED + 25)
    rows["sparse_gather_matvec"] += [
        run_sparse(dev, mrng, f"nectar shard of model {n} rows=8",
                   B=scfg.max_batch, k=k_nectar, d_ff=cfg.d_ff,
                   d=cfg.d_model // n, empty_frac=0.1) for n in (2, 4)]
    rows["relu_ffn"] = [
        run_relu_ffn(dev, krng, f"nectar prefill M={M}", M=M, d=cfg.d_model,
                     f=cfg.d_ff, dead_blocks=(1, 3))
        for M in (200, 8)]
    rows["relu_ffn"] += [run_relu_ffn(dev, krng, "llama3.2-1b M=32", M=32,
                                      d=2048, f=8192, dead_blocks=(5,))]
    # phase 21 (a): kernel 3 at nectar's training rows (B 8 x S 64), and
    # the device time of its autograd rule's backward, from a stream of
    # their own (measured here, where every kernel row is)
    trng = np.random.default_rng(SEED + 21)
    rows["relu_ffn"].append(run_relu_ffn(
        dev, trng, f"nectar training M={TRAIN_ROWS}", M=TRAIN_ROWS,
        d=cfg.d_model, f=cfg.d_ff, dead_blocks=()))
    train_ffn = (rows["relu_ffn"][-1],
                 relu_ffn_backward_ms(dev, trng, TRAIN_ROWS, cfg.d_model,
                                      cfg.d_ff))
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

    lap(clock, "3) kernels")

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

    lap(clock, "4) W8A8 entry point")

    # ---- 5) serve on the card (paged engine) ----------------------------------
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = Model(cfg).init(gen, device=dev)
    prompts = [rng.integers(0, cfg.vocab, int(n), dtype=np.int32)
               for n in rng.integers(8, 201, 16)]
    from repro_torch.tools import flip_probe
    check(all(np.array_equal(a, b) for a, b in zip(
        flip_probe.chip_smoke_prompts(cfg.vocab, SEED), prompts)),
          "serve: flip_probe.chip_smoke_prompts no longer replays these "
          "prompts")
    max_new = 32
    engine = Engine(cfg, params, scfg, device=dev)
    gpu_ticks, _, gpu_margins = recording_engine(engine)
    gpu_tokens, gpu_rids, wall, summary, launches = serve(engine, prompts,
                                                          max_new)
    steps = engine.runner.n_steps
    print_serve("serve", len(prompts), summary, wall, steps, launches)
    for key in ("paged_attention", "sparse_gather_matvec"):
        check(launches[key] == cfg.n_layers * steps > 0,
              f"serve: {key} launched {launches[key]} times in {steps} "
              f"steps, expected one per layer per step")
    check_tokens("serve", gpu_tokens, cfg, max_new, gpu_ticks)
    details["serve"] = dict(summary, wall_s=wall, steps=steps,
                            launches=launches)

    lap(clock, "5) paged serve")

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

    lap(clock, "6) paged serve on the CPU")

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

    lap(clock, "7) slot serve")

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

    lap(clock, "8) slot serve on the CPU")

    # ---- 9) shared system prompt through the prefix cache --------------------
    prng_ = np.random.default_rng(SEED)
    system = prng_.integers(0, cfg.vocab, 128, dtype=np.int32)
    prefix_prompts = [
        np.concatenate([system, prng_.integers(0, cfg.vocab, int(n),
                                               dtype=np.int32)])
        for n in prng_.integers(8, 65, 16)]
    prefix_scfg = dataclasses.replace(scfg, prefix_cache=True)
    pre = Engine(cfg, params, prefix_scfg, device=dev)
    hit_rows = []          # first prefill rows of hits: their lens > 0
    step = pre.runner.step

    def recording_step(batch):
        from repro_torch.serve.runner import PREFILL
        hit_rows.extend(int(batch.row_start[e.slot])
                        for e in pre.sched.active.values()
                        if e.cached_len > 0 and e.pos == e.cached_len
                        and batch.phase[e.slot] == PREFILL
                        and batch.tokens.shape[1] > 1)
        return step(batch)
    pre.runner.step = recording_step
    pre_ticks, _, pre_margins_card = recording_engine(pre)
    pre_tokens, pre_rids, pre_wall, pre_summary, pre_launches = serve(
        pre, prefix_prompts, max_new)
    pre_steps = pre.runner.n_steps
    print_serve("prefix", len(prefix_prompts), pre_summary, pre_wall,
                pre_steps, pre_launches)
    for key in ("paged_attention", "sparse_gather_matvec"):
        check(pre_launches[key] == cfg.n_layers * pre_steps > 0,
              f"prefix: {key} launched {pre_launches[key]} times in "
              f"{pre_steps} steps, expected one per layer per step")
    check_tokens("prefix", pre_tokens, cfg, max_new, pre_ticks)
    check(pre_summary["prefix_hits"] > 0, "prefix: no prefix hit")
    check(len(hit_rows) == pre_summary["prefix_hits"]
          and set(hit_rows) == {128},
          f"prefix: the hits' first prefill rows start at {hit_rows}, "
          f"not at their cached length of 128 tokens")
    nopre = Engine(cfg, params, scfg, device=dev)
    nopre_tokens, _, nopre_wall, nopre_summary, _ = serve(
        nopre, prefix_prompts, max_new)
    print_serve("prefix off", len(prefix_prompts), nopre_summary, nopre_wall,
                nopre.runner.n_steps, "-")
    check(pre_tokens == nopre_tokens,
          "prefix: the cache-on serve's tokens differ from the cache-off "
          "serve's")
    # the host's spread: off and on once more, in turns (on, off, off, on)
    pre_runs = [("on 1", pre_summary, pre_wall),
                ("off 1", nopre_summary, nopre_wall)]
    for label, sc in (("off 2", scfg), ("on 2", prefix_scfg)):
        again, _, w, summ, _ = serve(Engine(cfg, params, sc, device=dev),
                                     prefix_prompts, max_new)
        check(again == pre_tokens,
              f"prefix {label}: tokens differ from the first serve's")
        print_serve(f"prefix {label}", len(prefix_prompts), summ, w, "-",
                    "-")
        pre_runs.append((label, summ, w))
    check(pre.metrics.prefill_tokens < nopre.metrics.prefill_tokens,
          f"prefix: {pre.metrics.prefill_tokens} prompt tokens through the "
          f"model with the cache, {nopre.metrics.prefill_tokens} without")
    pre_cpu = Engine(cfg, params, prefix_scfg, device="cpu")
    _, _, pre_margins = recording_engine(pre_cpu)
    pre_cpu_tokens, pre_cpu_rids, _, pre_cpu_summary, _ = serve(
        pre_cpu, prefix_prompts, max_new)
    check(pre_cpu_summary["prefix_hits"] == pre_summary["prefix_hits"],
          "prefix-cpu: the CPU serve's prefix hits differ from the card's")
    pre_flips = compare_cpu("prefix-cpu", pre_tokens, pre_cpu_tokens,
                            pre_margins, pre_cpu_rids)
    print(f"prefix: {pre_summary['prefix_hits']} hits of "
          f"{pre_summary['prefix_lookups']} lookups, "
          f"{pre_summary['prefix_cached_tokens']} cached tokens; prompt "
          f"tokens through the model {pre.metrics.prefill_tokens} (cache "
          f"off {nopre.metrics.prefill_tokens}); {len(hit_rows)} hits' "
          f"first prefill rows at lens 128; tokens identical cache on and "
          f"off; CPU: "
          f"{len(prefix_prompts) - len(pre_flips)}/{len(prefix_prompts)} "
          f"requests token-identical, near-tie flips: {pre_flips}")
    details["prefix"] = dict(pre_summary, wall_s=pre_wall, steps=pre_steps,
                             launches=pre_launches,
                             prefill_tokens=pre.metrics.prefill_tokens,
                             off=dict(nopre_summary, wall_s=nopre_wall,
                                      prefill_tokens=(
                                          nopre.metrics.prefill_tokens)),
                             runs={label: dict(summ, wall_s=w)
                                   for label, summ, w in pre_runs},
                             cpu_flips=pre_flips)

    lap(clock, "9) prefix cache")

    # ---- 10) seeded sampled rows, card against CPU ----------------------------
    from repro_torch.serve.sampling import SamplingParams
    sps = [SamplingParams(temperature=(0.7, 1.0)[i % 2],
                          top_k=(0, 40)[(i // 2) % 2],
                          top_p=(1.0, 0.9)[(i // 4) % 2],
                          repetition_penalty=(1.0, 1.2)[(i // 8) % 2],
                          seed=i) for i in range(len(prompts))]
    smp = Engine(cfg, params, scfg, device=dev)
    smp_ticks, _, _ = recording_engine(smp)
    smp_tokens, _, smp_wall, smp_summary, smp_launches = serve(
        smp, prompts, max_new, sps)
    print_serve("sampled", len(prompts), smp_summary, smp_wall,
                smp.runner.n_steps, smp_launches)
    check_tokens("sampled", smp_tokens, cfg, max_new, [
        np.where(np.isneginf(z), 0.0, z) for z in smp_ticks])
    smp_cpu = Engine(cfg, params, scfg, device="cpu")
    _, _, smp_margins = recording_engine(smp_cpu)
    smp_cpu_tokens, smp_cpu_rids, _, _, _ = serve(smp_cpu, prompts, max_new,
                                                  sps)
    smp_flips = compare_cpu("sampled-cpu", smp_tokens, smp_cpu_tokens,
                            smp_margins, smp_cpu_rids)
    print(f"sampled: {len(prompts) - len(smp_flips)}/{len(prompts)} "
          f"requests token-identical card against CPU; {len(smp_flips)} "
          f"near-tie flips (perturbed-score margin <= {NEAR_TIE}): "
          f"{smp_flips}")
    details["sampled"] = dict(smp_summary, wall_s=smp_wall,
                              launches=smp_launches, flips=smp_flips)

    lap(clock, "10) sampled rows")

    # ---- 11) int8 KV pools (naive read), card against CPU ---------------------
    q8_scfg = dataclasses.replace(scfg, attn_backend="naive", kv_quant=True)
    q8 = Engine(cfg, params, q8_scfg, device=dev)
    q8_ticks, _, q8_card_margins = recording_engine(q8)
    q8_tokens, q8_rids, q8_wall, q8_summary, q8_launches = serve(
        q8, prompts, max_new)
    q8_steps = q8.runner.n_steps
    print_serve("int8kv", len(prompts), q8_summary, q8_wall, q8_steps,
                q8_launches)
    check(q8.runner.cache["units"]["b0"]["k"].dtype == torch.int8,
          "int8kv: the pools are not int8")
    check(q8_launches["paged_attention"] == 0
          and q8_launches["sparse_gather_matvec"]
          == cfg.n_layers * q8_steps > 0,
          f"int8kv: launches {q8_launches} in {q8_steps} steps")
    check_tokens("int8kv", q8_tokens, cfg, max_new, q8_ticks)
    q8_cpu = Engine(cfg, params, q8_scfg, device="cpu")
    _, _, q8_margins = recording_engine(q8_cpu)
    q8_cpu_tokens, q8_cpu_rids, _, _, _ = serve(q8_cpu, prompts, max_new)
    q8_flips = compare_cpu("int8kv-cpu", q8_tokens, q8_cpu_tokens,
                           q8_margins, q8_cpu_rids)
    print(f"int8kv: {len(prompts) - len(q8_flips)}/{len(prompts)} requests "
          f"token-identical card against CPU; near-tie flips: {q8_flips}")
    details["int8kv"] = dict(q8_summary, wall_s=q8_wall, steps=q8_steps,
                             launches=q8_launches, flips=q8_flips)

    lap(clock, "11) int8 KV")

    # ---- 12) llama3.2-1b-smoke (d_head 16) through both engines ---------------
    scfg_smoke = get_config("llama3.2-1b-smoke")
    sgen = torch.Generator(device=dev).manual_seed(SEED)
    sparams = Model(scfg_smoke).init(sgen, device=dev)
    srng = np.random.default_rng(SEED + 4)
    sprompts = [srng.integers(0, scfg_smoke.vocab, int(n), dtype=np.int32)
                for n in srng.integers(8, 65, 8)]
    details["smoke"] = {}
    for label, sc in (("paged", scfg), ("slot", slot_scfg)):
        eng = Engine(scfg_smoke, sparams, sc, device=dev)
        sm_ticks, sm_prefills, _ = recording_engine(eng)
        sm_tokens, _, sm_wall, sm_summary, sm_launches = serve(
            eng, sprompts, 16)
        steps = eng.runner.n_steps if sc.paged else eng.metrics.decode_steps
        key = "paged_attention" if sc.paged else "decode_attention"
        check(sm_launches[key] == scfg_smoke.n_layers * steps > 0,
              f"smoke {label}: {key} launched {sm_launches[key]} times in "
              f"{steps} steps")
        check_tokens(f"smoke {label}", sm_tokens, scfg_smoke, 16,
                     sm_ticks + sm_prefills)
        cpu = Engine(scfg_smoke, sparams, sc, device="cpu")
        _, _, sm_margins = recording_engine(cpu)
        sm_cpu_tokens, sm_cpu_rids, _, _, _ = serve(cpu, sprompts, 16)
        sm_flips = compare_cpu(f"smoke {label}-cpu", sm_tokens,
                               sm_cpu_tokens, sm_margins, sm_cpu_rids)
        print_serve(f"smoke {label}", len(sprompts), sm_summary, sm_wall,
                    steps, sm_launches)
        print(f"smoke {label}: {len(sprompts) - len(sm_flips)}/"
              f"{len(sprompts)} requests token-identical card against "
              f"CPU; near-tie flips: {sm_flips}")
        details["smoke"][label] = dict(sm_summary, wall_s=sm_wall,
                                       launches=sm_launches, flips=sm_flips)

    lap(clock, "12) llama3.2-1b-smoke")

    # ---- 18) the recurrent families (runs after phase 12) --------------------
    details["recurrent"], recurrent_launches = recurrent_phase(
        dev, cfg, params, scfg, prompts, max_new,
        (gpu_tokens, gpu_margins, gpu_rids))
    lap(clock, "18) recurrent families")

    # ---- 19) the paper's C4 dispatch and the model families (runs after
    # phase 18; its kernel-1 rows (b) are in phase 3) ----------------------
    details["families"], families_launches = families_phase(
        dev, scfg, prompts, max_new)
    lap(clock, "19) dispatch and model families")

    # ---- 20) the frontends (runs after phase 19; its kernel rows (d) are
    # in phase 3) ----------------------------------------------------------
    details["frontends"], frontends_launches = frontends_phase(
        dev, scfg, slot_scfg, prompts, max_new)
    lap(clock, "20) frontends")

    # ---- 14) speculative decoding (runs before phase 13, which profiles
    # two of its serves) ---------------------------------------------------------
    from repro_torch.configs.base import SpecConfig
    from repro_torch.core.sparsity import SparsityPredictor
    from repro_torch.spec import SelfSpecDrafter
    verify_err = {n: verify_against_sequential(cfg, params, dev, n)
                  for n in (5, 9)}
    check(max(verify_err.values()) <= KERNEL_ATOL,
          f"spec: a verify row's logits differ from sequential decode by "
          f"{verify_err}")
    print(f"spec: verify rows of 5 and 9 tokens against the same tokens "
          f"decoded one row at a time: max_abs_err {verify_err[5]:.3g} / "
          f"{verify_err[9]:.3g}")
    dparams = Model(dcfg).init(
        torch.Generator(device=dev).manual_seed(SEED + 7), device=dev)
    spec_cfgs = {
        "ngram": SpecConfig(drafter="ngram", k=4, k_max=8),
        "model": SpecConfig(drafter="model", k=4, k_max=8,
                            draft_name=DRAFT_NAME),
        "selfspec": SpecConfig(drafter="selfspec", k=4, k_max=8)}
    draft_layers = {"ngram": 0, "model": dcfg.n_layers,
                    "selfspec": cfg.n_layers}

    def spec_engine(sc, device, like=None):
        """A spec engine on ``device``; ``like``'s self-spec predictors,
        where given, replace the ones it calibrated (the CPU serve then
        drafts as the card's does)."""
        eng = Engine(cfg, params, sc, device=device, draft_params=dparams)
        if like is not None and isinstance(like.drafter, SelfSpecDrafter):
            preds = like.drafter.preds
            eng.drafter = SelfSpecDrafter(
                cfg, eng.params, sc.max_seq, frac=sc.spec.draft_frac,
                max_batch=sc.max_batch, device=device,
                preds=SparsityPredictor(preds.w_in.to(device),
                                        preds.w_out.to(device)))
        return eng

    spec_runs = {}
    details["spec"] = {"verify_vs_sequential_err": verify_err}
    for label, sp_cfg in spec_cfgs.items():
        sc = dataclasses.replace(scfg, spec=sp_cfg)
        eng = spec_engine(sc, dev)
        sp_ticks, _, sp_rows = recording_spec_engine(eng)
        drafting = timed_drafting(eng)
        sp_tokens, sp_rids, sp_wall, sp_summary, sp_launches = serve(
            eng, prompts, max_new)
        steps = eng.runner.n_steps
        dsteps = getattr(eng.drafter, "steps", 0)
        nd = draft_layers[label]
        for key, want in (
                ("paged_attention", cfg.n_layers * steps),
                ("sparse_gather_matvec", cfg.n_layers * steps + nd * dsteps),
                ("decode_attention", nd * dsteps),
                ("relu_ffn", 0), ("nmce_matmul", 0)):
            check(sp_launches[key] == want,
                  f"spec {label}: {key} launched {sp_launches[key]} times, "
                  f"expected {want} ({steps} steps, {dsteps} draft steps "
                  f"of {nd} layers)")
        check(sp_summary["spec_steps"] > 0 and (dsteps > 0) == (nd > 0),
              f"spec {label}: {sp_summary['spec_steps']} verify steps, "
              f"{dsteps} draft steps")
        check_tokens(f"spec {label}", sp_tokens, cfg, max_new, sp_ticks)
        paged_flips = compare_cpu(f"spec {label} vs paged", sp_tokens,
                                  gpu_tokens, gpu_margins, gpu_rids)
        cpu_eng = spec_engine(sc, "cpu", like=eng)
        _, sp_margins, sp_cpu_rows = recording_spec_engine(cpu_eng)
        sp_cpu_tokens, sp_cpu_rids, _, sp_cpu_summary, _ = serve(
            cpu_eng, prompts, max_new)
        cpu_flips = flip_gaps(
            compare_cpu(f"spec {label}-cpu", sp_tokens, sp_cpu_tokens,
                        sp_margins, sp_cpu_rids),
            sp_cpu_rids, sp_rows, sp_cpu_rows)
        print_serve(f"spec {label}", len(prompts), sp_summary, sp_wall,
                    steps, sp_launches)
        print(f"spec {label}: {sp_summary['spec_steps']} verify steps, "
              f"acceptance {sp_summary['spec_acceptance_rate']:.4f}, "
              f"{sp_summary['spec_tokens_per_verify']:.4f} tokens per "
              f"verify, K at the end {eng.kctl.k}; {dsteps} draft steps "
              f"({nd} layers each) in {drafting['s']:.3f} s = "
              f"{100 * drafting['s'] / sp_wall:.2f}% of the serve's wall; "
              f"launches as the counters say (kernel 1 {cfg.n_layers} a "
              f"step, kernel 2 {cfg.n_layers} a step + {nd} a draft step, "
              f"kernel 5 {nd} a draft step)")
        print(f"spec {label}: against the paged serve "
              f"{len(prompts) - len(paged_flips)}/{len(prompts)} requests "
              f"token-identical, near-tie flips {paged_flips}; against the "
              f"CPU {len(prompts) - len(cpu_flips)}/{len(prompts)}, "
              f"near-tie flips {cpu_flips} (CPU: "
              f"{sp_cpu_summary['spec_steps']} verify steps, acceptance "
              f"{sp_cpu_summary['spec_acceptance_rate']:.4f})")
        spec_runs[label] = (sc, sp_tokens, sp_launches, sp_wall)
        details["spec"][label] = dict(
            sp_summary, wall_s=sp_wall, steps=steps, draft_steps=dsteps,
            drafting_s=drafting["s"], launches=sp_launches,
            paged_flips=paged_flips, cpu_flips=cpu_flips,
            cpu_spec_steps=sp_cpu_summary["spec_steps"])
    # seeded sampled rows through the n-gram drafter: rejection sampling
    ssc = dataclasses.replace(scfg, spec=spec_cfgs["ngram"])
    ssps = [SamplingParams(temperature=0.7, seed=i)
            for i in range(len(prompts))]
    seng = spec_engine(ssc, dev)
    ss_ticks, _, ss_rows = recording_spec_engine(seng)
    ss_tokens, _, ss_wall, ss_summary, ss_launches = serve(
        seng, prompts, max_new, ssps)
    check_tokens("spec sampled", ss_tokens, cfg, max_new, ss_ticks)
    ss_cpu = spec_engine(ssc, "cpu")
    _, ss_margins, ss_cpu_rows = recording_spec_engine(ss_cpu)
    ss_cpu_tokens, ss_cpu_rids, _, _, _ = serve(ss_cpu, prompts, max_new,
                                                ssps)
    ss_flips = flip_gaps(
        compare_cpu("spec sampled-cpu", ss_tokens, ss_cpu_tokens,
                    ss_margins, ss_cpu_rids),
        ss_cpu_rids, ss_rows, ss_cpu_rows)
    print_serve("spec sampled", len(prompts), ss_summary, ss_wall,
                seng.runner.n_steps, ss_launches)
    print(f"spec sampled: {ss_summary['spec_steps']} verify steps, "
          f"acceptance {ss_summary['spec_acceptance_rate']:.4f}; "
          f"{len(prompts) - len(ss_flips)}/{len(prompts)} requests "
          f"token-identical card against CPU; near-tie flips (perturbed "
          f"score, or a uniform within {NEAR_TIE} of its accept threshold "
          f"or draw boundary; logit_gap = the largest card-against-CPU "
          f"difference of the logits that decided the token): {ss_flips}")
    details["spec"]["sampled"] = dict(ss_summary, wall_s=ss_wall,
                                      launches=ss_launches, flips=ss_flips)

    lap(clock, "14) speculative decoding")

    # ---- 15) the async engine (runs before phase 13, which profiles its
    # K = 8 decode-heavy serve) -----------------------------------------------
    from repro_torch.configs.base import AsyncConfig
    async_cfgs = {"K1": AsyncConfig(enabled=True, max_device_ticks=1),
                  "K8": AsyncConfig(enabled=True, max_device_ticks=8)}
    details["async"] = {"phase5": {}, "heavy": {}}
    async_launches = dict.fromkeys(KERNELS, 0)
    # the sync paged serve once more, as this phase's baseline: phase 5's
    # serve was the card's first and pays one-time costs in its TTFT
    again = Engine(cfg, params, scfg, device=dev)
    again_tokens, _, again_wall, again_summary, again_launches = serve(
        again, prompts, max_new)
    check(again_tokens == gpu_tokens,
          "async: the second sync paged serve's tokens differ from phase 5's")
    details["async"]["phase5"]["sync"] = async_record(
        "async sync", cfg, again, len(prompts), again_summary, again_wall,
        again_launches)
    for key in KERNELS:
        async_launches[key] += again_launches[key]
    for label, acfg in async_cfgs.items():
        asc = dataclasses.replace(scfg, async_cfg=acfg)
        eng = Engine(cfg, params, asc, device=dev)
        a_tokens, _, a_wall, a_summary, a_launches = serve(eng, prompts,
                                                           max_new)
        check_tokens(f"async {label}", a_tokens, cfg, max_new, [])
        rec = async_record(f"async {label}", cfg, eng, len(prompts),
                           a_summary, a_wall, a_launches)
        paged_flips = compare_cpu(f"async {label} vs paged", a_tokens,
                                  gpu_tokens, gpu_margins, gpu_rids)
        a_cpu = Engine(cfg, params, asc, device="cpu")
        a_cpu_tokens, _, _, _, _ = serve(a_cpu, prompts, max_new)
        # the async CPU serve against the sync one (phase 6), whose
        # margins also judge the card's flips against the async CPU serve
        cpu_sync_flips = compare_cpu(f"async {label}-cpu vs cpu",
                                     a_cpu_tokens, cpu_tokens, margins,
                                     cpu_rids)
        cpu_flips = compare_cpu(f"async {label}-cpu", a_tokens,
                                a_cpu_tokens, margins, cpu_rids)
        ratio = a_summary["tokens_per_s"] / again_summary["tokens_per_s"]
        print(f"async {label}: {ratio:.3f}x the second sync serve's "
              f"tokens/s; against the paged serve "
              f"{len(prompts) - len(paged_flips)}/{len(prompts)} requests "
              f"token-identical, near-tie flips {paged_flips}; against its "
              f"CPU run {len(prompts) - len(cpu_flips)}/{len(prompts)}, "
              f"near-tie flips {cpu_flips}; the CPU run against the sync "
              f"CPU run: flips {cpu_sync_flips} (CPU: "
              f"{a_cpu.async_stats()})")
        details["async"]["phase5"][label] = dict(
            rec, tokens_per_s_ratio=ratio, paged_flips=paged_flips,
            cpu_flips=cpu_flips,
            cpu_sync_flips=cpu_sync_flips, cpu_async=a_cpu.async_stats())
        for key in KERNELS:
            async_launches[key] += a_launches[key]
    # the decode-heavy traffic: sync, then K = 1 and K = 8, on the card
    heavy = heavy_prompts(cfg)
    heavy_new = 256
    h_sync = Engine(cfg, params, scfg, device=dev)
    h_ticks, _, h_margins = recording_engine(h_sync)
    h_tokens, h_rids, h_wall, h_summary, h_launches = serve(h_sync, heavy,
                                                            heavy_new)
    check_tokens("heavy sync", h_tokens, cfg, heavy_new, h_ticks)
    details["async"]["heavy"]["sync"] = async_record(
        "heavy sync", cfg, h_sync, len(heavy), h_summary, h_wall,
        h_launches)
    heavy_runs = {}
    for key in KERNELS:
        async_launches[key] += h_launches[key]
    for label, acfg in async_cfgs.items():
        asc = dataclasses.replace(scfg, async_cfg=acfg)
        eng = Engine(cfg, params, asc, device=dev)
        a_tokens, _, a_wall, a_summary, a_launches = serve(eng, heavy,
                                                           heavy_new)
        check_tokens(f"heavy {label}", a_tokens, cfg, heavy_new, [])
        rec = async_record(f"heavy {label}", cfg, eng, len(heavy),
                           a_summary, a_wall, a_launches)
        flips = compare_cpu(f"heavy {label} vs sync", a_tokens, h_tokens,
                            h_margins, h_rids)
        ratio = a_summary["tokens_per_s"] / h_summary["tokens_per_s"]
        print(f"heavy {label}: {ratio:.3f}x the sync serve's tokens/s; "
              f"against the sync serve {len(heavy) - len(flips)}/"
              f"{len(heavy)} requests token-identical, near-tie flips "
              f"(the eager serve's margin) {flips}")
        details["async"]["heavy"][label] = dict(rec, flips=flips,
                                                tokens_per_s_ratio=ratio)
        heavy_runs[label] = (asc, a_tokens, a_launches, a_wall)
        for key in KERNELS:
            async_launches[key] += a_launches[key]
    for label, acfg in async_cfgs.items():
        ticks, stats = sync_free_ticks(
            cfg, params, dataclasses.replace(scfg, async_cfg=acfg), dev,
            heavy, 24)
        print(f"async {label}: {ticks} ticks after the prefills ran under "
              f"set_sync_debug_mode(\"error\") without a sync ({stats})")
        details["async"][f"sync_free_{label}"] = {"ticks": ticks,
                                                   "async": stats}
    lap(clock, "15) async engine")

    # ---- 16) observability (runs before phase 13) ------------------------------
    details["obs"], obs_launches = obs_phase(
        cfg, params, scfg, dev, prompts, max_new, again_tokens, gpu_margins,
        gpu_rids, heavy, heavy_new, h_tokens, h_margins, h_rids,
        details["async"]["heavy"]["K8"]["wall_per_device_tick_ms"])
    lap(clock, "16) observability")

    # ---- 17) disagg and the fleet (runs before phase 13) ------------------------
    details["disagg"], disagg_launches, disagg_run = disagg_phase(
        cfg, params, scfg, q8_scfg, dev, prompts, max_new,
        (gpu_tokens, gpu_margins, gpu_rids), q8_tokens, again_summary,
        prefix_prompts, (pre_tokens, pre_margins_card, pre_rids))
    lap(clock, "17) disagg and fleet")

    # ---- 13) the serves again, under torch.profiler ---------------------------
    from repro_torch.configs.base import MeshConfig
    from repro_torch.serve.disagg import DisaggCoordinator
    profiles = {}
    # phase 22's busy shares: the unsharded naive serve's and the model-4
    # mesh serve's windows run here, where the profiler has its slack
    naive_scfg = dataclasses.replace(scfg, attn_backend="naive")
    mesh4_scfg = dataclasses.replace(naive_scfg, mesh=MeshConfig(model=4))
    mesh_first = {}
    for label, sc in (("mesh naive", naive_scfg),
                      ("mesh model 4", mesh4_scfg)):
        m_toks, _, m_wall, _, m_lnch = serve(
            Engine(cfg, params, sc, device=shard_devices(sc, dev)),
            prompts, max_new)
        mesh_first[label] = (sc, m_toks, m_lnch, m_wall)
    for label, sc, pr_prompts, pr_sps, toks, lnch, w, pr_new in (
            ("paged", scfg, prompts, None, gpu_tokens, launches, wall,
             max_new),
            ("slot", slot_scfg, prompts, None, slot_tokens, slot_launches,
             slot_wall, max_new),
            ("prefix", prefix_scfg, prefix_prompts, None, pre_tokens,
             pre_launches, pre_wall, max_new),
            ("sampled", scfg, prompts, sps, smp_tokens, smp_launches,
             smp_wall, max_new),
            ("int8kv", q8_scfg, prompts, None, q8_tokens, q8_launches,
             q8_wall, max_new)) + tuple(
                (f"spec {d}", spec_runs[d][0], prompts, None,
                 *spec_runs[d][1:], max_new) for d in ("ngram", "model")) \
            + (("async K8 heavy", heavy_runs["K8"][0], heavy, None,
                *heavy_runs["K8"][1:], heavy_new),
               ("disagg", None, prompts, None, *disagg_run, max_new)) \
            + tuple((label, m_sc, prompts, None, *rest, max_new)
                    for label, (m_sc, *rest) in mesh_first.items()):
        pr = profile_serve(f"profile {label}",
                           lambda sc=sc: Engine(
                               cfg, params, sc,
                               device=shard_devices(sc, dev),
                               draft_params=dparams)
                           if sc is not None else
                           DisaggCoordinator(cfg, params, scfg, device=dev),
                           pr_prompts, pr_new, toks, lnch, w, pr_sps)
        profiles[label] = pr
        per = ", ".join(f"{k} {v:.5f}"
                        for k, v in pr["kernel_device_ms"].items())
        busy = ("not measured" if pr["device_ms"] is None else
                f"{pr['device_ms']:.3f} ms = {100 * pr['busy_share']:.2f}%")
        print(f"profile {label}: same tokens and launches; device ms per "
              f"launch: {per or 'not measured'}; serve device time {busy}"
              f" of the unprofiled wall "
              f"{w:.3f} s (profiled wall {pr['profiled_wall_s']:.3f} s)"
              + (f"; kv_len {pr['kv_len_range'][0]}-"
                 f"{pr['kv_len_range'][1]}" if "kv_len_range" in pr else ""))
        print(f"profile {label}: most device time (name, count, ms): "
              + "; ".join(f"{n} x{c} {t:.3f}" for n, c, t in pr["top_device"]))
    details["profile"] = profiles
    # which projection runs the slow f32 GEMM: one window with shapes and
    # Python lines over the paged serve
    gemms = gemm_shapes(Engine(cfg, params, scfg, device=dev), prompts,
                        max_new)
    check(gemms, "gemm: the record_shapes window attributes no GEMM kernel "
          "to an op")
    for kernel, op, shapes, site, calls, call_ms in gemms[:8]:
        print(f"gemm: {kernel[:72]} x{calls} {call_ms:.5f} ms a call: {op} "
              f"{shapes} from {site}")
    details["gemm_shapes"] = gemms

    lap(clock, "13) profiled serves")

    # ---- 21) training (runs after phase 13, whose profiler windows keep
    # their deadline; its kernel-3 row (a) is in phase 3) -------------------
    details["training"], training_launches = training_phase(
        dev, cfg, scfg, prompts, max_new,
        (summary["tokens_per_s"], params, gpu_tokens), train_ffn)
    lap(clock, "21) training")

    # ---- 22) multi-device: meshes of shards on the card (runs after phase
    # 21; its kernel-2 rows at the shards' shapes join phase 3's table) ------
    details["mesh"], mesh_launches = mesh_phase(
        dev, smi, cfg, params, scfg, prompts, max_new, prefix_prompts,
        (q8_scfg, q8_tokens, q8_rids, q8_card_margins, q8_launches),
        {"naive": (cpu_tokens, margins, cpu_rids),
         "int8": (q8_cpu_tokens, q8_margins, q8_cpu_rids),
         "spec": (pre_cpu_tokens, pre_margins, pre_cpu_rids)}, rows,
        {"naive": profiles["mesh naive"], 4: profiles["mesh model 4"]})
    lap(clock, "22) multi-device")

    # ---- report --------------------------------------------------------------
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(details, indent=1))
    # each kernel's launches on the paths that run it (paged attention:
    # the paged, prefix, greedy spec, async, obs, disagg, phase-18 bf16
    # and drafter serves, the phase-19 and phase-20 paged serves and the
    # phase-21 serve of the trained checkpoint; the gather: those, the
    # slot serve and the phase-19 dispatcher; kernel 3: the slot serve's
    # prefills and phase 21's training runs; decode
    # attention: the slot serve, the model and self-spec drafters, the
    # phase-18 zamba2 serves and recurrent drafter and the phase-20 slot
    # serves; nmce_matmul: the ops phase and the
    # phase-19 dispatcher), and its row at the shape the main path gives
    # it
    spec_launches = {key: sum(run[2][key] for run in spec_runs.values())
                     for key in KERNELS}
    path_launches = {
        "paged_attention": launches["paged_attention"]
        + pre_launches["paged_attention"]
        + spec_launches["paged_attention"]
        + async_launches["paged_attention"]
        + obs_launches["paged_attention"]
        + disagg_launches["paged_attention"]
        + recurrent_launches["paged_attention"]
        + families_launches["paged_attention"]
        + frontends_launches["paged_attention"]
        + training_launches["paged_attention"],
        "sparse_gather_matvec": launches["sparse_gather_matvec"]
        + slot_launches["sparse_gather_matvec"]
        + pre_launches["sparse_gather_matvec"]
        + spec_launches["sparse_gather_matvec"]
        + async_launches["sparse_gather_matvec"]
        + obs_launches["sparse_gather_matvec"]
        + disagg_launches["sparse_gather_matvec"]
        + recurrent_launches["sparse_gather_matvec"]
        + families_launches["sparse_gather_matvec"]
        + training_launches["sparse_gather_matvec"]
        + mesh_launches["sparse_gather_matvec"],
        "decode_attention": slot_launches["decode_attention"]
        + spec_launches["decode_attention"]
        + recurrent_launches["decode_attention"]
        + frontends_launches["decode_attention"],
        "relu_ffn": slot_launches["relu_ffn"]
        + training_launches["relu_ffn"] + mesh_launches["relu_ffn"],
        "nmce_matmul": ops_launches["nmce_matmul"]
        + families_launches["nmce_matmul"]}
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
            "library_device_ms": r["library_device_ms"],
            "mesh_launches": mesh_launches[key]})
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
