"""Roofline attainment of the serving step, per width bucket.

Per width bucket of ``ModelRunner.step`` (decode = 1, the prefill chunk,
k_max+1 verify) it joins

  * the STATIC cost of one tick, from shapes (obs.costmodel): the step's
    FLOPs and bytes at the tick's live attention keys, in total and per
    scope, plus the greedy sampler as the "sample" scope; with
  * the MEASURED device time of the tracer's ticks (``tick_stats``
    grouped by width and by whether a prefill row ran, the runner's
    bucket key)

and reports per bucket the achieved GFLOP/s and GB/s, the arithmetic
intensity and the roofline ATTAINMENT: the least time the chip could
take for the bucket's work (the larger of FLOPs over the peak for the
weights' dtype and bytes over the memory rate, ``roofline.hw``) over the
measured device time. ``attain`` is clamped to (0, 1] as in the
reference; ``attain_raw`` is the unclamped ratio, so a reading over 1
shows.

Two caveats on the card (``hw.H100_SXM``):

  * the measured time is the tick's ``device_ms`` (obs.trace): CUDA
    events around the step, which include the gaps where the device waits
    for the host issuing the eager step. It is an upper bound on busy
    time, so attainment is a LOWER bound;
  * nectar's f32 weights (about 7 MB) fit in the H100's 50 MB L2 cache, so
    the HBM term is not a hard floor for this model: an ``attain_raw``
    above 1 would mean the weights stayed in L2, not a fault.

Surfaces: ``metrics.summary()["bucket_attainment"]``, the Prometheus
endpoint (``bucket_attainment_*{bucket="..."}`` labeled gauges), counter
tracks in the Perfetto export and ``launch.serve --profile`` (prints
``attainment_table``). Off by default (``ObsConfig.profile``).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

from repro_torch.obs import costmodel
from repro_torch.roofline import hw

# table columns: (header, width, format) over report() row keys
_COLS = (
    ("bucket", 10, "{:<10}"),
    ("ticks", 6, "{:>6d}"),
    ("dev_ms", 8, "{:>8.3f}"),
    ("GFLOP/s", 9, "{:>9.2f}"),
    ("GB/s", 8, "{:>8.2f}"),
    ("AI", 7, "{:>7.2f}"),
    ("attain", 7, "{:>7.4f}"),
    ("attain_raw", 10, "{:>10.6f}"),
    ("bound", 8, "{:<8}"),
)


def bucket_label(width: int, has_prefill: bool) -> str:
    """Name of a (width, has_prefill) bucket: "decode", "prefill<W>",
    "verify<K+1>"."""
    if has_prefill:
        return f"prefill{width}"
    return "decode" if width == 1 else f"verify{width}"


class ServingProfiler:
    """Per-bucket attainment over a live runner, judged against ``chip``
    (default: ``hw.active_chip`` of the runner's device) at the peak of
    the weights' dtype."""

    def __init__(self, runner, chip: Optional[hw.Chip] = None,
                 n_chips: int = 1):
        self.runner = runner
        self.chip = chip if chip is not None \
            else hw.active_chip(runner.device)
        self.n_chips = n_chips
        self.peak = hw.peak_for(self.chip, runner.params["embed"].dtype)

    # --- static side -----------------------------------------------------
    def static_cost(self, width: int, has_prefill: bool,
                    n_keys: Optional[float] = None) -> costmodel.StepCost:
        return costmodel.step_cost(self.runner, width, has_prefill, n_keys)

    def sample_cost(self) -> Dict[str, float]:
        cfg = self.runner.cfg
        return costmodel.sampler_cost(self.runner.scfg.max_batch,
                                      cfg.vocab, cfg.n_codebooks)

    def _tick_totals(self, width: int, has_prefill: bool,
                     n_keys: Optional[float]):
        """(flops, bytes, by_scope, the keys counted) of one tick: the step
        plus the sampler call."""
        cost = self.static_cost(width, has_prefill, n_keys)
        samp = self.sample_cost()
        by_scope = {k: dict(v) for k, v in cost.by_scope.items()}
        by_scope["sample"] = dict(samp)
        return (cost.flops + samp["flops"], cost.hbm_bytes + samp["bytes"],
                by_scope, cost.n_keys)

    def _terms(self, flops: float, byts: float) -> dict:
        return hw.roofline_terms(flops, byts, 0.0, self.n_chips,
                                 chip=self.chip, peak=self.peak)

    # --- measured join ---------------------------------------------------
    @staticmethod
    def _grouped(tick_stats: Iterable[dict]) -> Dict[tuple, List[dict]]:
        """The ticks of each (width, has_prefill) bucket, from each tick's
        recorded attrs. Ticks that ran no device step (no width, or no
        device time) belong to no bucket."""
        groups: Dict[tuple, List[dict]] = {}
        for t in tick_stats:
            w = t.get("width")
            if not w or t.get("device_ms", 0.0) <= 0.0:
                continue
            key = (int(w), bool(t.get("rows_prefill", 0)))
            groups.setdefault(key, []).append(t)
        return groups

    def report(self, tick_stats: Iterable[dict]) -> List[dict]:
        """One row per observed bucket, at the mean tick: the cost at the
        bucket's mean live keys (the cost is linear in them; ``n_keys`` is
        the count the cost model used) over the mean device time."""
        rows = []
        for (w, hp), ticks in sorted(self._grouped(tick_stats).items()):
            keys = [t.get("n_keys") for t in ticks]
            n_keys = None if None in keys else sum(keys) / len(keys)
            flops, byts, by_scope, n_keys = self._tick_totals(w, hp, n_keys)
            dev_ms = sum(t["device_ms"] for t in ticks) / len(ticks)
            dev_s = dev_ms / 1e3
            terms = self._terms(flops, byts)
            lb = terms["step_s_lower_bound"]
            raw = lb / dev_s if dev_s > 0 and lb > 0 else None
            scoped = sum(v["flops"] for k, v in by_scope.items()
                         if k != "other")
            rows.append({
                "bucket": bucket_label(w, hp),
                "width": w,
                "has_prefill": hp,
                "ticks": len(ticks),
                "n_keys": n_keys,
                "dev_ms": dev_ms,
                "flops": flops,
                "hbm_bytes": byts,
                "GFLOP/s": flops / dev_s / 1e9,
                "GB/s": byts / dev_s / 1e9,
                "AI": flops / byts if byts else 0.0,
                "attain": None if raw is None else min(1.0, raw),
                "attain_raw": raw,
                "bound": terms["bound"],
                "chip": self.chip.name,
                "n_chips": self.n_chips,
                "scopes": {k: {"flops": v["flops"], "bytes": v["bytes"],
                               "flops_frac": (v["flops"] / flops
                                              if flops else 0.0)}
                           for k, v in sorted(by_scope.items())},
                "scope_attributed_frac": (scoped / flops
                                          if flops else 0.0),
            })
        return rows

    # --- export adapters -------------------------------------------------
    def gauges(self) -> Dict[str, Dict[str, float]]:
        """{bucket label: {metric: value}} for the registry's labeled
        gauge group (``bucket_attainment_<metric>{bucket="..."}``),
        re-pulled from the live tracer at every scrape."""
        out: Dict[str, Dict[str, float]] = {}
        for r in self.report(self.runner.tracer.tick_stats):
            out[r["bucket"]] = {
                "achieved_gflops": r["GFLOP/s"],
                "achieved_gbs": r["GB/s"],
                "arith_intensity": r["AI"],
                "attainment": r["attain"] if r["attain"] is not None
                else 0.0,
                "device_ms_mean": r["dev_ms"],
                "ticks": r["ticks"],
            }
        return out

    def tick_counters(self, tick_stats: Iterable[dict]):
        """Per-tick Perfetto counter samples: (series name, tick start
        seconds, value) for achieved GFLOP/s, GB/s and attainment."""
        out = []
        for t in tick_stats:
            w = t.get("width")
            dev_ms = t.get("device_ms", 0.0)
            if not w or dev_ms <= 0.0:
                continue
            flops, byts, _, _ = self._tick_totals(
                int(w), bool(t.get("rows_prefill", 0)), t.get("n_keys"))
            dev_s = dev_ms / 1e3
            terms = self._terms(flops, byts)
            t0 = float(t.get("t0_s", 0.0))
            out.append(("achieved_gflops", t0, flops / dev_s / 1e9))
            out.append(("achieved_gbs", t0, byts / dev_s / 1e9))
            out.append(("roofline_attainment", t0,
                        min(1.0, terms["step_s_lower_bound"] / dev_s)))
        return out


def attainment_table(rows: List[dict]) -> str:
    """The per-bucket attainment report as a fixed-width table, with a
    per-scope FLOP split line under each bucket row."""
    if not rows:
        return "(no profiled ticks — run with tracing+profiling on)"
    head = " ".join(f"{name:>{w}}" if fmt.startswith("{:>") else
                    f"{name:<{w}}" for name, w, fmt in _COLS)
    lines = [f"roofline attainment vs {rows[0]['chip']} "
             f"(n_chips={rows[0]['n_chips']})", head, "-" * len(head)]
    for r in rows:
        vals = []
        for name, _w, fmt in _COLS:
            v = r[name]
            vals.append(fmt.format(v if v is not None else float("nan")))
        lines.append(" ".join(vals))
        split = "  ".join(
            f"{k}={v['flops_frac'] * 100:.1f}%"
            for k, v in r["scopes"].items() if v["flops"] > 0)
        lines.append(f"           flops: {split}")
    return "\n".join(lines)


__all__ = ["ServingProfiler", "attainment_table", "bucket_label"]
