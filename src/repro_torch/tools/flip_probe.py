"""Where do two devices' greedy serves part, and does a top-k boundary tie
of the sparse FFN set it off?

Serves one prompt set through the same engine on two devices (the card
and the CPU by default) with the weights ``chip_smoke.py`` uses, and
records every decode row's FFN hidden activation h and the top-k units
the device picked from it at every layer, and the logits behind every
token. For each request whose tokens differ it reports,
at the first differing token, both devices' top-2 logit margins and their
largest logit difference. For every earlier token of every request (where
the two histories still agree) and every layer it checks whether the two
devices picked the same top-k units of |h| (each device's own
``topk_indices``), the rows of W_down the sparse gather reads; where they
did not, it gives the gap between the k-th and the
(k+1)-th |h| on each device and the largest |h| difference of the row.

    PYTHONPATH=src python -m repro_torch.tools.flip_probe [--extra-seeds N]
    PYTHONPATH=src python -m repro_torch.tools.flip_probe --spec-sampled

``--spec-sampled`` replays verify rows instead: it serves the prompts of
``chip_smoke.py``'s phase 5 as phase 14's seeded sampled rows through the
n-gram drafter, on both devices, matches the verify and prefill rows the
two serves ran by (request, first position, fed tokens) and compares the
top-k sets of every matched row at every position and layer; for each
flip it reports where each side decided the token, the first row of that
request only one side ran, and the first step at which the adaptive K
of the two sides differ.

Prompt sets: ``shared-stream`` are the 16 prompts ``chip_smoke.py`` drew
when its kernel cases 3-5 and its ops phase shared the serve prompts'
seed-0 generator (``shared_stream_prompts`` replays that draw order);
``seed-<s>`` are 16 prompts drawn first from generator ``s``. The report
goes to ``build/flip_probe.json``; a summary line per set and engine goes
to stdout.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ServeConfig, SpecConfig
from repro_torch.core import sparsity
from repro_torch.models import Model
from repro_torch.serve import api
from repro_torch.serve.engine import Engine
from repro_torch.serve.runner import PREFILL
from repro_torch.serve.sampling import SamplingParams

N_PROMPTS, MAX_NEW = 16, 32


def _kernel_1_2_draws(rng: np.random.Generator) -> None:
    """Replay the draws of ``chip_smoke.py``'s phase-3 cases of kernels 1
    and 2 (paged attention nectar S=1, 32 and llama S=1, 5, 32; the
    gather at 8, 256 and llama rows) on ``rng``."""
    for S, Hq, Kv, Dh, max_ctx in ((1, 4, 4, 32, 232), (32, 4, 4, 32, 232),
                                   (1, 32, 8, 64, 2048),
                                   (5, 32, 8, 64, 2048),
                                   (32, 32, 8, 64, 2048)):
        B, bs, MB = 8, 16, 128
        rng.integers(1, max_ctx - S + 1, B)
        rng.permutation(B * MB)
        rng.standard_normal((B, S, Hq, Dh))
        for _ in range(2):
            rng.standard_normal((B * MB, bs, Kv, Dh))
    for B, k, d_ff, d in ((8, 128, 640, 128), (256, 128, 640, 128),
                          (8, 1024, 8192, 2048)):
        for _ in range(B):
            rng.permutation(d_ff)
        rng.random((B, k))
        rng.standard_normal((B, k))
        rng.standard_normal((d_ff, d))


def chip_smoke_prompts(vocab: int, seed: int = 0) -> List[np.ndarray]:
    """The 16 prompts of ``chip_smoke.py``'s phase 5 (and of phases 6, 7,
    10, 11, 14 and 15): drawn from the seed-``seed`` generator after its
    phase-3 cases of kernels 1 and 2 (kernels 3-5 draw from streams of
    their own)."""
    rng = np.random.default_rng(seed)
    _kernel_1_2_draws(rng)
    return [rng.integers(0, vocab, int(n), dtype=np.int32)
            for n in rng.integers(8, 201, N_PROMPTS)]


def shared_stream_prompts(vocab: int, seed: int = 0) -> List[np.ndarray]:
    """The serve prompts of the draw order in which every kernel case and
    the ops phase of ``chip_smoke.py`` came from one seed-``seed``
    generator: each case's draws are replayed in turn (kernels 1 and 2 as
    ``_kernel_1_2_draws``; decode attention's kv_len, then its nectar f32,
    bf16 and llama f32, bf16 cases; the fused FFN at M 200, 8 and llama;
    W8A8 at five sites in two modes; the ops phase), then the prompts are
    drawn."""
    rng = np.random.default_rng(seed)
    _kernel_1_2_draws(rng)
    S = 2048
    rng.integers(1, 233, 7)
    rng.integers(1, S + 1, 8)
    for Hq, Kv, Dh in ((4, 4, 32), (4, 4, 32), (32, 8, 64), (32, 8, 64)):
        rng.standard_normal((8, Hq, Dh))
        for _ in range(2):
            rng.standard_normal((8, S, Kv, Dh))
    for M, d, f in ((200, 128, 640), (8, 128, 640), (32, 2048, 8192)):
        for shape in ((d, f), (M, d), (f, d)):
            rng.standard_normal(shape)
    for M, K, N in ((8, 128, 640), (8, 640, 128), (8, 128, 2048),
                    (8, 2048, 8192), (32, 2048, 8192)):
        for _ in range(2):
            rng.standard_normal((M, K))
            rng.standard_normal((K, N))
    rng.standard_normal((128, 640))
    rng.standard_normal((8, 128))
    return [rng.integers(0, vocab, int(n), dtype=np.int32)
            for n in rng.integers(8, 201, N_PROMPTS)]


def seeded_prompts(vocab: int, seed: int) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(n), dtype=np.int32)
            for n in rng.integers(8, 201, N_PROMPTS)]


class Recorder:
    """Hooks one engine. Per model step and layer of the sparse FFN: the
    position-0 hidden activation f32[rows, d_ff] and the units the device's
    top-k selected there (the nonzero ones the gather reads), one set per
    row. Per committed token
    (rid, i): the logits behind it and, for i >= 1 (a decode row), the
    step and row that produced it."""

    def __init__(self, engine: Engine):
        self.engine = engine
        self.paged = engine.scfg.paged
        self.h: List[List[Tuple[torch.Tensor, List[set]]]] = []
        self.logits: Dict[Tuple[int, int], np.ndarray] = {}
        self.where: Dict[Tuple[int, int], Tuple[int, int]] = {}
        self._z = self._z_prefill = None
        if self.paged:
            engine.runner.step = self._new_step(engine.runner.step)
        else:
            engine.model.decode_step = self._new_step(
                engine.model.decode_step)
            prefill = engine.model.prefill

            def recording_prefill(*args):
                logits, cache = prefill(*args)
                self._z_prefill = logits[0, 0].float().cpu().numpy()
                return logits, cache
            engine.model.prefill = recording_prefill
        sample, append = engine._sample_rows, engine._append_token

        def recording_sample(pairs, last_logits):
            self._z = last_logits.float().cpu().numpy()
            return sample(pairs, last_logits)

        def recording_append(req, slot, tok, lp):
            i = len(req.tokens_out)
            if self.paged:
                row = engine.sched.active[req.rid].slot
            else:
                row = None if i == 0 else engine.alloc.active[req.rid]
            self.logits[(req.rid, i)] = (self._z_prefill if row is None
                                         else self._z[row])
            if i > 0:
                self.where[(req.rid, i)] = (len(self.h) - 1, row)
            return append(req, slot, tok, lp)
        engine._sample_rows = recording_sample
        engine._append_token = recording_append

    def _new_step(self, step):
        def recording_step(*args, **kwargs):
            self.h.append([])
            return step(*args, **kwargs)
        return recording_step

    def topk_hook(self, topk):
        def recording_topk(h, k):
            idx, valid = topk(h, k)
            if h.dim() == 3 and self.h:
                i, v = idx[:, 0].cpu(), valid[:, 0].cpu()
                self.h[-1].append((h[:, 0].float().cpu(),
                                   [set(i[r][v[r]].tolist())
                                    for r in range(len(i))]))
            return idx, valid
        return recording_topk


def serve_recorded(cfg, params, scfg: ServeConfig, prompts, device,
                   max_new: int = MAX_NEW
                   ) -> Tuple[List[List[int]], List[int], Recorder]:
    """Serve ``prompts`` through StreamingServer on ``device``, recording."""
    engine = Engine(cfg, params, scfg, device=device)
    rec = Recorder(engine)
    topk = sparsity.topk_indices
    sparsity.topk_indices = rec.topk_hook(topk)
    try:
        server = api.StreamingServer(engine)
        rids = [server.submit(p, max_new=max_new) for p in prompts]
        finished = server.drain()
    finally:
        sparsity.topk_indices = topk
    return [list(finished[r].tokens_out) for r in rids], rids, rec


def boundary(ha: torch.Tensor, hb: torch.Tensor, sa: set, sb: set,
             k: int) -> Optional[dict]:
    """None when both rows selected the same units (``sa``, ``sb``); else
    how many differ, the gap between the k-th and (k+1)-th |h| on each
    side, the k-th |h| of ``hb``, the largest |ha - hb| and both sides' h
    at the units only one side selected."""
    if sa == sb:
        return None
    ma, mb = ha.abs(), hb.abs()
    va = torch.sort(ma, descending=True).values
    vb = torch.sort(mb, descending=True).values
    only = sorted(sa - sb) + sorted(sb - sa)
    return {"swapped": len(sa - sb),
            "gap_a": float(va[k - 1] - va[k]),
            "gap_b": float(vb[k - 1] - vb[k]),
            "kth_b": float(vb[k - 1]),
            "max_h_diff": float((ha - hb).abs().max()),
            "h_at_swapped": [[int(j), float(ha[j]), float(hb[j])]
                             for j in only]}


def _margin(z: np.ndarray) -> float:
    z = np.sort(z)
    return float(z[-1] - z[-2])


def compare(a: Recorder, b: Recorder, tokens_a, tokens_b, rids,
            k: int) -> dict:
    """Side ``b`` is the reference (the CPU). Returns the flips, every
    top-k set difference over the tokens both histories share (up to and
    including each request's first differing token), and how many
    (token, layer) pairs were checked."""
    flips, diffs, checked = [], [], 0
    for n, (ta, tb, rid) in enumerate(zip(tokens_a, tokens_b, rids)):
        first = next((i for i, (x, y) in enumerate(zip(ta, tb)) if x != y),
                     None)
        for i in range(1, (len(tb) - 1 if first is None else first) + 1):
            (sa, ra), (sb, rb) = a.where[(rid, i)], b.where[(rid, i)]
            for layer, ((ha, sel_a), (hb, sel_b)) in enumerate(
                    zip(a.h[sa], b.h[sb])):
                checked += 1
                d = boundary(ha[ra], hb[rb], sel_a[ra], sel_b[rb], k)
                if d is not None:
                    diffs.append(dict(request=n, token=i, layer=layer, **d))
        if first is not None:
            za, zb = a.logits[(rid, first)], b.logits[(rid, first)]
            flips.append({"request": n, "token": first,
                          "tokens": [int(ta[first]), int(tb[first])],
                          "margin_a": _margin(za), "margin_b": _margin(zb),
                          "max_logit_diff": float(np.abs(za - zb).max())})
    return {"flips": flips, "set_diffs": diffs, "checked": checked}


def probe(cfg, params, prompts, scfg: ServeConfig, devices=("cuda", "cpu"),
          max_new: int = MAX_NEW) -> dict:
    k = sparsity.active_fraction_to_k(cfg.d_ff, cfg.sparse_k_frac)
    ta, rids, a = serve_recorded(cfg, params, scfg, prompts, devices[0],
                                 max_new)
    tb, rids_b, b = serve_recorded(cfg, params, scfg, prompts, devices[1],
                                   max_new)
    assert rids == rids_b
    return compare(a, b, ta, tb, rids, k)


# ---------------------------------------------------------------------------
# verify rows (speculative decoding)


class VerifyRecorder:
    """Hooks a speculative engine. Per runner step: each row's request,
    first position and fed tokens, and per layer the sparse FFN's hidden
    activation at every position of the row with the units the device's
    top-k selected there; the adaptive K each step drafted with. Per
    committed token (rid, i): the logits behind it and, for a token a
    verify row decided, the step, row and position that decided it."""

    def __init__(self, engine: Engine):
        self.engine = engine
        self.rows: List[Dict[int, tuple]] = []   # step -> slot -> row
        self.h: List[List[Tuple[torch.Tensor, List[List[set]]]]] = []
        self.k: List[int] = []
        self.logits: Dict[Tuple[int, int], np.ndarray] = {}
        self.where: Dict[Tuple[int, int], Tuple[int, int, int]] = {}
        self._verify: Optional[dict] = None
        self._z = None
        step = engine.runner.step

        def recording_step(batch, *args, **kwargs):
            rid_of = {e.slot: e.req.rid
                      for e in engine.sched.active.values()}
            self.rows.append({
                int(s): (rid_of[int(s)], int(batch.phase[s]),
                         int(batch.row_start[s]),
                         tuple(int(t) for t in
                               batch.tokens[s, :batch.n_valid[s]]))
                for s in np.flatnonzero(batch.n_valid)})
            self.h.append([])
            self.k.append(engine.kctl.k)
            out = step(batch, *args, **kwargs)
            self._out = out
            return out
        engine.runner.step = recording_step
        sample, append = engine._sample_rows, engine._append_token
        commit = engine._commit_verify

        def recording_sample(pairs, last_logits):
            self._z = last_logits.float().cpu().numpy()
            return sample(pairs, last_logits)

        def recording_commit(rows, proposals, out, finished):
            self._verify = {e.req.rid: [e.slot, 0] for e in rows}
            try:
                return commit(rows, proposals, out, finished)
            finally:
                self._verify = None

        def recording_append(req, slot, tok, lp):
            i = len(req.tokens_out)
            v = self._verify.get(req.rid) if self._verify else None
            if v is None:                      # a first token: sampled
                self.logits[(req.rid, i)] = self._z[slot]
            else:
                j = v[1]
                v[1] += 1
                self.where[(req.rid, i)] = (len(self.rows) - 1, v[0], j)
                self.logits[(req.rid, i)] = \
                    self._out.logits[v[0], j].float().cpu().numpy()
            return append(req, slot, tok, lp)
        engine._sample_rows = recording_sample
        engine._commit_verify = recording_commit
        engine._append_token = recording_append

    def topk_hook(self, topk):
        def recording_topk(h, k):
            idx, valid = topk(h, k)
            if h.dim() == 3 and self.h:
                i, v = idx.cpu(), valid.cpu()
                self.h[-1].append((h.float().cpu(), [
                    [set(i[r, j][v[r, j]].tolist())
                     for j in range(i.shape[1])] for r in range(i.shape[0])]))
            return idx, valid
        return recording_topk


def serve_verify(cfg, params, scfg: ServeConfig, prompts, device,
                 sps=None, max_new: int = MAX_NEW
                 ) -> Tuple[List[List[int]], List[int], VerifyRecorder]:
    """Serve ``prompts`` (with SamplingParams ``sps``, where given) through
    StreamingServer on ``device`` with a speculative engine, recording."""
    engine = Engine(cfg, params, scfg, device=device)
    rec = VerifyRecorder(engine)
    topk = sparsity.topk_indices
    sparsity.topk_indices = rec.topk_hook(topk)
    try:
        server = api.StreamingServer(engine)
        rids = [server.submit(p, max_new=max_new,
                              sampling=None if sps is None else sps[i])
                for i, p in enumerate(prompts)]
        finished = server.drain()
    finally:
        sparsity.topk_indices = topk
    return [list(finished[r].tokens_out) for r in rids], rids, rec


def compare_verify(a: VerifyRecorder, b: VerifyRecorder, tokens_a,
                   tokens_b, rids, k: int) -> dict:
    """Side ``b`` is the reference (the CPU). Rows of the two serves are
    matched by (request, first position, fed tokens): every matched row's
    top-k sets are compared at every position and layer, in the order
    ``b`` ran them (prefill rows take the dense FFN and are skipped).
    For each request whose tokens differ: the first
    differing token, the largest difference of the logits that decided
    it, where each side decided it, the first row of that request that
    only one side ran (its drafts, or its start, differ), and the first
    step at which the two sides' adaptive K differ."""
    index_a = {}
    for n, rows in enumerate(a.rows):
        for slot, row in rows.items():
            index_a.setdefault(row, (n, slot))
    diffs, checked = [], 0
    for n, rows in enumerate(b.rows):
        for slot, row in sorted(rows.items()):
            hit = index_a.get(row)
            if row[1] == PREFILL or hit is None or not a.h[hit[0]] \
                    or not b.h[n]:
                continue
            for layer, ((ha, sel_a), (hb, sel_b)) in enumerate(
                    zip(a.h[hit[0]], b.h[n])):
                for j in range(len(row[3])):
                    checked += 1
                    d = boundary(ha[hit[1], j], hb[slot, j],
                                 sel_a[hit[1]][j], sel_b[slot][j], k)
                    if d is not None:
                        diffs.append(dict(request=rids.index(row[0]),
                                          step_b=n, start=row[2],
                                          position=j, layer=layer, **d))
    k_diff = next(({"step": n, "k": [int(x), int(y)]}
                   for n, (x, y) in enumerate(zip(a.k, b.k)) if x != y),
                  None)
    flips = []
    for n, (ta, tb, rid) in enumerate(zip(tokens_a, tokens_b, rids)):
        first = next((i for i, (x, y) in enumerate(zip(ta, tb)) if x != y),
                     None)
        if first is None:
            continue
        za, zb = a.logits[(rid, first)], b.logits[(rid, first)]
        only = None
        for side, rec, other in (("a", a, b), ("b", b, a)):
            keys = {row for rows in other.rows for row in rows.values()}
            for s, rows in enumerate(rec.rows):
                row = next((r for r in rows.values() if r[0] == rid), None)
                if row is not None and row not in keys \
                        and row[2] < len(rec.engine._requests[rid].prompt) \
                        + first:
                    if only is None or s < only["step"]:
                        only = {"side": side, "step": s, "start": row[2],
                                "tokens": list(row[3])}
                    break
        flips.append({
            "request": n, "token": first,
            "tokens": [int(ta[first]), int(tb[first])],
            "margin_a": _margin(za), "margin_b": _margin(zb),
            "max_logit_diff": float(np.abs(za - zb).max()),
            "decided_a": a.where.get((rid, first)),
            "decided_b": b.where.get((rid, first)),
            "first_unmatched_row": only})
    return {"flips": flips, "set_diffs": diffs, "checked": checked,
            "k_diff": k_diff}


def probe_verify(cfg, params, prompts, scfg: ServeConfig, sps=None,
                 devices=("cuda", "cpu"), max_new: int = MAX_NEW) -> dict:
    k = sparsity.active_fraction_to_k(cfg.d_ff, cfg.sparse_k_frac)
    ta, rids, a = serve_verify(cfg, params, scfg, prompts, devices[0], sps,
                               max_new)
    tb, rids_b, b = serve_verify(cfg, params, scfg, prompts, devices[1],
                                 sps, max_new)
    assert rids == rids_b
    return compare_verify(a, b, ta, tb, rids, k)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--extra-seeds", type=int, default=0,
                    help="also probe the prompt sets of seeds 1..N")
    ap.add_argument("--spec-sampled", action="store_true",
                    help="instead: chip_smoke.py phase 14's seeded sampled "
                         "n-gram spec serve, verify rows replayed")
    ap.add_argument("--out", default="build/flip_probe.json")
    args = ap.parse_args(argv)
    cfg = get_config("nectar-relu-llama-1.7m")
    dev = torch.device("cuda", 0)
    params = Model(cfg).init(torch.Generator(device=dev).manual_seed(0),
                             device=dev)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    if args.spec_sampled:
        prompts = chip_smoke_prompts(cfg.vocab)
        scfg = ServeConfig(paged=True, attn_backend="flash", max_batch=8,
                           spec=SpecConfig(drafter="ngram", k=4, k_max=8))
        sps = [SamplingParams(temperature=0.7, seed=i)
               for i in range(len(prompts))]
        r = probe_verify(cfg, params, prompts, scfg, sps)
        first = r["set_diffs"][:8]
        print(f"spec sampled: flips {r['flips']}; adaptive K first differs "
              f"at {r['k_diff']}; top-k set differences "
              f"{len(r['set_diffs'])} of {r['checked']} (position, layer) "
              f"pairs of matched rows; the first (CPU order): {first}")
        out.write_text(json.dumps({"spec sampled": r}, indent=1))
        return
    sets = {"shared-stream": shared_stream_prompts(cfg.vocab)}
    sets.update({f"seed-{s}": seeded_prompts(cfg.vocab, s)
                 for s in range(1, args.extra_seeds + 1)})
    engines = {"paged": ServeConfig(paged=True, attn_backend="flash",
                                    max_batch=8),
               "slot": ServeConfig(paged=False, max_batch=8)}
    report = {}
    for name, prompts in sets.items():
        for ename, scfg in engines.items():
            r = probe(cfg, params, prompts, scfg)
            report[f"{name} {ename}"] = r
            gaps = [d["gap_b"] for d in r["set_diffs"]]
            print(f"{name} {ename}: flips {r['flips']}; top-k set "
                  f"differences {len(r['set_diffs'])} of {r['checked']} "
                  f"(token, layer) pairs"
                  + (f", CPU k-th gap max {max(gaps):.3g}" if gaps else ""))
    out.write_text(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
