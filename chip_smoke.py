#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU and
check it end to end. Run from the repository root:

    python3 chip_smoke.py

Phases, each reporting on lines of its own:
  1. device  — a CUDA device must be present; prints the card's name and
               power limit as nvidia-smi gives them; TF32 stays off.
  2. build   — nvcc builds both CUDA kernels from src/repro_torch/csrc.
  3. kernels — each kernel against its plain PyTorch version on the card,
               at nectar-relu-llama-1.7m's shapes and at llama3.2-1b's
               widths, with sentinel table entries and sentinel indices;
               times of kernel, plain version and a library yardstick.
  4. serve   — the paged engine serves 16 requests of nectar-relu-llama-
               1.7m (random weights from a seeded generator) through
               StreamingServer; both kernels must launch on that path.
  5. cpu     — the same prompts and weights through Engine(device="cpu")
               (plain versions); greedy tokens must agree, except at a
               near-tie whose CPU top-2 logit margin is <= NEAR_TIE.
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
KERNEL_ATOL = 1e-4   # f32 kernel vs plain version: same terms summed in
#                      another order; errors seen are ~1e-6
LOGIT_ATOL = 1e-3    # card vs CPU logits of one whole forward step
NEAR_TIE = 1e-3      # a token flip with a CPU top-2 margin at most this
#                      is a summation-order near-tie, not a fault
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
F32_FLOPS_PER_S = 67e12       # H100 SXM f32 rate outside the tensor cores


class Failure(Exception):
    pass


def check(ok, msg):
    if not ok:
        raise Failure(msg)


def time_ms(fn, iters=100, warmup=5):
    """Mean device time of one call, from CUDA events around ``iters``
    back-to-back calls after a warm-up."""
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


def bound(n_bytes, flops):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / F32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions


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
    got = decode_attn.paged_attention(q, kp, vp, tables, lens)
    want = ref.paged_attention_plain(q, kp, vp, tables, lens)
    torch.cuda.synchronize()
    check(torch.isfinite(got).all().item(), f"{label}: non-finite output")
    err = (got - want).abs().max().item()
    check(err <= KERNEL_ATOL, f"{label}: paged_attention max_abs_err {err}")
    # the library yardstick: SDPA over the gathered, masked sequence
    kg = ref._gather_paged(kp, tables).transpose(1, 2)
    vg = ref._gather_paged(vp, tables).transpose(1, 2)
    S, Skv = q.shape[1], kg.shape[2]
    vis = (torch.arange(Skv, device=dev)[None, None, :]
           <= (lens[:, None].long()
               + torch.arange(S, device=dev)[None, :])[:, :, None])
    qt, mask = q.transpose(1, 2), vis[:, None]

    def library():
        return F.scaled_dot_product_attention(qt, kg, vg, attn_mask=mask,
                                              enable_gqa=True)
    n_bytes, flops = attention_work(q, kp, tables, lens)
    bound_ms, bound_by = bound(n_bytes, flops)
    return {"case": label, "max_abs_err": err,
            "ms": time_ms(lambda: decode_attn.paged_attention(
                q, kp, vp, tables, lens)),
            "plain_ms": time_ms(lambda: ref.paged_attention_plain(
                q, kp, vp, tables, lens)),
            "library_ms": time_ms(library),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": n_bytes, "flops": flops}


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
    got = sparse_ffn.sparse_gather_matvec(h, i, w)
    want = ref.sparse_gather_matvec_plain(h, i, w)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    check(err <= KERNEL_ATOL,
          f"{label}: sparse_gather_matvec max_abs_err {err}")
    wpad = torch.cat([w, w.new_zeros(1, d)])
    il = i.long()
    valid = idx < d_ff
    n_bytes = (h.numel() + i.numel() + B * d) * 4 \
        + len(np.unique(idx[valid])) * d * 4
    bound_ms, bound_by = bound(n_bytes, 2 * d * int(valid.sum()))
    return {"case": label, "max_abs_err": err,
            "ms": time_ms(lambda: sparse_ffn.sparse_gather_matvec(h, i, w)),
            "plain_ms": time_ms(lambda: ref.sparse_gather_matvec_plain(
                h, i, w)),
            "library_ms": time_ms(lambda: F.embedding_bag(
                il, wpad, per_sample_weights=h, mode="sum",
                padding_idx=d_ff)),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": n_bytes, "flops": 2 * d * int(valid.sum())}


# ---------------------------------------------------------------------------
# phases 4 and 5: serving


def recording_engine(engine):
    """Record every tick's last-position logits and the top-2 logit
    margin behind each committed token, {(rid, index): margin}."""
    ticks, margins = [], {}
    sample, append = engine._sample_rows, engine._append_token

    def recording_sample(last_logits):
        ticks.append(last_logits.float().cpu().numpy())
        return sample(last_logits)

    def recording_append(req, tok, lp):
        z = np.sort(ticks[-1][engine.sched.active[req.rid].slot])
        margins[(req.rid, len(req.tokens_out))] = float(z[-1] - z[-2])
        return append(req, tok, lp)

    engine._sample_rows = recording_sample
    engine._append_token = recording_append
    return ticks, margins


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
    from repro_torch.kernels import build, ops
    from repro_torch.models import Model
    from repro_torch.serve import api
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
    rng = np.random.default_rng(SEED)
    nectar_attn = dict(B=scfg.max_batch, Hq=cfg.n_heads, Kv=cfg.n_kv_heads,
                       Dh=cfg.d_head, bs=scfg.block_size,
                       MB=scfg.blocks_per_seq, max_ctx=232)
    llama_attn = dict(B=8, Hq=32, Kv=8, Dh=64, bs=16, MB=128, max_ctx=2048)
    attn = [run_attention(dev, rng, f"nectar S={S}", S=S, **nectar_attn)
            for S in (1, scfg.prefill_chunk)]
    attn += [run_attention(dev, rng, f"llama3.2-1b S={S}", S=S, **llama_attn)
             for S in (1, 5, 32)]
    k_nectar = 128          # active_fraction_to_k(640, 0.25)
    sparse = [run_sparse(dev, rng, f"nectar rows={B}", B=B, k=k_nectar,
                         d_ff=cfg.d_ff, d=cfg.d_model, empty_frac=0.1)
              for B in (scfg.max_batch, scfg.max_batch * scfg.prefill_chunk)]
    sparse += [run_sparse(dev, rng, "llama3.2-1b rows=8", B=8, k=1024,
                          d_ff=8192, d=2048, empty_frac=0.1)]
    for name_, rows in (("paged_attention", attn),
                        ("sparse_gather_matvec", sparse)):
        for r in rows:
            print(f"kernel {name_} [{r['case']}]: max_abs_err="
                  f"{r['max_abs_err']:.3g} ms={r['ms']:.5f} "
                  f"plain_ms={r['plain_ms']:.5f} library_ms="
                  f"{r['library_ms']:.5f} bound_ms={r['bound_ms']:.6f} "
                  f"({r['bound_by']})")
    details["kernels"] = {"paged_attention": attn,
                          "sparse_gather_matvec": sparse}

    # ---- 4) serve on the card ----------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = Model(cfg).init(gen, device=dev)
    prompts = [rng.integers(0, cfg.vocab, int(n), dtype=np.int32)
               for n in rng.integers(8, 201, 16)]
    max_new = 32
    engine = Engine(cfg, params, scfg, device=dev)
    gpu_ticks, _ = recording_engine(engine)
    server = api.StreamingServer(engine)
    for key in ops.LAUNCHES:
        ops.LAUNCHES[key] = 0
    t0 = time.perf_counter()
    rids = [server.submit(p, max_new=max_new) for p in prompts]
    finished = server.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    steps = engine.runner.n_steps
    summary = engine.metrics.summary()
    gpu_tokens = {rid: list(finished[rid].tokens_out) for rid in rids}
    print(f"serve: {len(rids)} requests, {summary['generated_tokens']} "
          f"tokens in {wall:.3f} s ({summary['tokens_per_s']:.1f} tok/s), "
          f"TTFT p50 {summary['ttft_p50_ms']:.2f} ms p99 "
          f"{summary['ttft_p99_ms']:.2f} ms, TPOT p50 "
          f"{summary['tpot_p50_ms']:.3f} ms p99 {summary['tpot_p99_ms']:.3f}"
          f" ms, {steps} steps, launches {launches}")
    for key, n in launches.items():
        check(n > 0, f"serve: kernel {key} never launched on the main path")
        check(n == cfg.n_layers * steps,
              f"serve: {key} launched {n} times in {steps} steps, "
              f"expected one per layer per step")
    check(all(len(t) == max_new and all(0 <= x < cfg.vocab for x in t)
              for t in gpu_tokens.values()),
          "serve: every request must return max_new valid token ids")
    check(all(np.isfinite(z).all() for z in gpu_ticks),
          "serve: non-finite logits")
    details["serve"] = dict(summary, wall_s=wall, steps=steps,
                            launches=launches)

    # ---- 5) the same on the CPU (plain versions) -----------------------------
    cpu_engine = Engine(cfg, params, scfg, device="cpu")
    cpu_ticks, margins = recording_engine(cpu_engine)
    cpu_server = api.StreamingServer(cpu_engine)
    cpu_rids = [cpu_server.submit(p, max_new=max_new) for p in prompts]
    cpu_done = cpu_server.drain()
    logit_err = float(np.abs(gpu_ticks[0] - cpu_ticks[0]).max())
    check(logit_err <= LOGIT_ATOL,
          f"cpu: first-step logits differ by {logit_err} from the card's")
    flips = []
    for rid, cpu_rid in zip(rids, cpu_rids):
        a, b = gpu_tokens[rid], list(cpu_done[cpu_rid].tokens_out)
        if a == b:
            continue
        step = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        margin = margins[(cpu_rid, step)]
        check(margin <= NEAR_TIE,
              f"cpu: request {rid} diverges at token {step} with a CPU "
              f"top-2 margin {margin} > {NEAR_TIE}")
        flips.append({"rid": rid, "step": step, "margin": margin})
    print(f"cpu: first-step logits max_abs_err {logit_err:.3g}; "
          f"{len(rids) - len(flips)}/{len(rids)} requests token-identical; "
          f"near-tie flips: {flips}")
    details["cpu"] = {"first_step_logit_err": logit_err, "flips": flips}

    # ---- report --------------------------------------------------------------
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(details, indent=1))
    sources = {"paged_attention": ("src/repro_torch/csrc/paged_attention.cu",
                                   "src/repro/kernels/decode_attn.py:75",
                                   attn[0]),
               "sparse_gather_matvec": ("src/repro_torch/csrc/sparse_gather.cu",
                                        "src/repro/kernels/sparse_ffn.py:31",
                                        sparse[0])}
    kernels = [{"name": key, "route": "cuda", "source": src,
                "replaces": replaces, "launches": launches[key],
                "max_abs_err": max(r["max_abs_err"] for r in
                                   details["kernels"][key]),
                "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
                "bound_ms": main_case["bound_ms"],
                "bound_by": main_case["bound_by"],
                "library_ms": main_case["library_ms"]}
               for key, (src, replaces, main_case) in sources.items()]
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
