"""Perf variants of a dry-run cell: apply a named variant, count the cell
again, and record before -> after at a chip (the H100 SXM by default).

Two variant classes:
  * LOWERED — a config or sharding-policy change (block_causal, no_remat,
    serve_replicated, moe_ws): the variant registers ``arch@variant``,
    reruns ``launch.dryrun.run_cell`` on it and reads its row from
    ``roofline.analysis.cell_roofline``. The port's rows are analytic
    (counted from shapes, no compiled program), so such a variant moves
    only what the count reads: ``no_remat`` a train cell's FLOPs (through
    ``cfg.remat``), ``serve_replicated`` the memory per device, and
    ``block_causal`` none of the three terms.
  * MODELED — a byte or link-byte transformation applied to the analytic
    terms (int8 weight streaming -> kernel 4, csrc/nmce_matmul.cu; the
    ReLU-sparse W_down gather -> kernel 2, csrc/sparse_gather.cu; int8 KV
    -> serve/kv_cache.quantize_kv; fused flash attention -> kernels 1 and
    5; compressed cross-pod gradients -> dist/compression.py), labelled as
    modeled.

``a+b`` composes variants: modeled byte knobs merge and apply once.

Records: build/perf/<arch>__<shape>__<variant>.json (cached per chip
unless ``force``). The baseline cell needs its dry-run record first
(``python -m repro_torch.launch.dryrun``).

Usage:
  python -m repro_torch.launch.perf --arch llama3.2-1b --shape decode_32k \\
      --variant int8_stream
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Optional

from repro_torch.configs import get_config, registry
from repro_torch.roofline import analysis, hw

PERF_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                        "build", "perf")

TERMS = ("compute_s", "memory_s", "collective_s", "bound",
         "step_s_lower_bound", "roofline_fraction")


# ---------------------------------------------------------------------------
# Variants


def _lowered_variant(arch: str, shape_name: str, cfg_patch: dict,
                     variant_name: str, policy_patch: Optional[dict] = None,
                     chip: hw.Chip = hw.H100_SXM) -> dict:
    """Count the cell again with a patched config (registered as
    ``arch@variant``) and policy; its row at ``chip``. A failed dry run
    raises with the record's error."""
    from repro_torch.launch import dryrun

    cfg = dataclasses.replace(get_config(arch), **cfg_patch)
    vname = f"{arch}@{variant_name}"
    registry.REGISTRY[vname] = dataclasses.replace(cfg, name=vname)
    if policy_patch:
        dryrun.POLICY_OVERRIDES[vname] = policy_patch
    dryrun.run_cell(vname, shape_name, "pod", force=True)
    row = analysis.cell_roofline(vname, shape_name, chip=chip)
    if not row.get("ok"):
        raise RuntimeError(f"perf: {vname} x {shape_name}: the dry run "
                           f"failed: {row.get('error')}")
    return row


def _modeled_transform(row: dict, *, bytes_scale=1.0, flops_scale=1.0,
                       collective_scale=1.0, chips=256,
                       chip: hw.Chip = hw.H100_SXM, note=""):
    flops = row["hlo_flops_global"] * flops_scale
    byts = row["hlo_bytes_global"] * bytes_scale
    coll = row["collective_bytes_global"] * collective_scale
    terms = hw.roofline_terms(flops, byts, coll, chips, chip)
    out = dict(row)
    out.update(
        compute_s=terms["compute_s"], memory_s=terms["memory_s"],
        collective_s=terms["collective_s"],
        bound=terms["bound"].replace("_s", ""),
        step_s_lower_bound=terms["step_s_lower_bound"],
        hlo_flops_global=flops, hlo_bytes_global=byts,
        collective_bytes_global=coll, modeled=True, model_note=note)
    mf, mb = row["model_flops"], row["model_bytes"]
    lb = terms["step_s_lower_bound"]
    out["roofline_fraction"] = max(
        (mf / lb) / (chips * chip.peak_flops),
        (mb * min(bytes_scale, 1.0) / lb) / (chips * chip.hbm_bw)) \
        if lb > 0 else 0.0
    return out


def _bytes_ratio(cfg, shape_name, **kwargs):
    """Achieved-bytes ratio from the analytic model with the variant's
    dtype/fraction knobs applied (keeps weight-replication amplification
    and every other term consistent with the baseline accounting)."""
    base = analysis.analytic_hlo_bytes(cfg, shape_name)
    new = analysis.analytic_hlo_bytes(cfg, shape_name, **kwargs)
    return new / max(base, 1.0)


# each modeled variant contributes byte-model kwargs (merged when
# composed, then applied ONCE to the analytic model) and/or a collective
# scale, plus the port's implementation it stands for
MODELED_SPECS = {
    "int8_stream": ({"weight_bpe": 1.04}, 1.0,
                    "int8 weight stream (kernel 4, csrc/nmce_matmul.cu)"),
    "sparse_ffn": ({"ffn_down_frac": 0.125}, 1.0,
                   "ReLU-sparse W_down gather @k=0.125 "
                   "(kernel 2, csrc/sparse_gather.cu)"),
    "kv_quant": ({"kv_bpe": 1.04}, 1.0,
                 "int8 KV cache (serve/kv_cache.quantize_kv)"),
    "flash_fusion": ({"fused_attention": True}, 1.0,
                     "fused flash attention (kernels 1 and 5, "
                     "csrc/paged_attention.cu, csrc/decode_attention.cu)"),
    # full weight-stationary decode: dense weights also stay put; every
    # matmul psums [B, d]-sized activation partials
    "ws_dense": ({"ws_dense": True}, 1.0,
                 "weight-stationary dense decode (activations move, "
                 "weights never do: paper C1 at pod scale)"),
    "grad_compression": ({}, 0.3,
                         "int8+EF cross-pod gradient compression "
                         "(dist/compression.py)"),
}


LOWERED = {
    "block_causal": ({"block_causal": True}, None),
    "no_remat": ({"remat": False}, None),
    # weight-stationary MoE decode. Neither package's ShardingPolicy has
    # this field, so its dry run fails, as the reference's does
    "moe_ws": ({}, {"moe_weight_stationary": True}),
    # decode with weights replicated across data: no per-step FSDP gather
    "serve_replicated": ({}, {"fsdp": False}),
}

MODELED = MODELED_SPECS


def run_variant(arch: str, shape_name: str, variant: str,
                force: bool = False, chip: hw.Chip = hw.H100_SXM) -> dict:
    """Apply ``variant`` (``+``-composed names of LOWERED and MODELED) to
    the cell's analytic row at ``chip``; the record of before, after and
    the step's speedup, written to PERF_DIR (and read back from there, for
    the same chip, unless ``force``)."""
    os.makedirs(PERF_DIR, exist_ok=True)
    path = os.path.join(PERF_DIR, f"{arch}__{shape_name}__{variant}.json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            rec = json.load(f)
        if rec.get("chip") == chip.name:
            return rec

    base_row = analysis.cell_roofline(arch, shape_name, chip=chip)
    if not (base_row and base_row.get("ok")):
        raise RuntimeError(f"perf: baseline missing for {arch} x "
                           f"{shape_name}: run the dry run first")
    cfg = get_config(arch)
    t0 = time.time()
    row = base_row
    byte_kwargs = {}
    coll_scale = 1.0
    notes = []
    any_modeled = False
    for v in variant.split("+"):
        if v in LOWERED:
            cfg_patch, pol_patch = LOWERED[v]
            row = dict(_lowered_variant(arch, shape_name, cfg_patch, v,
                                        policy_patch=pol_patch, chip=chip),
                       modeled=False)
        elif v in MODELED:
            kw, cs, note = MODELED[v]
            byte_kwargs.update(kw)
            coll_scale *= cs
            notes.append(note)
            any_modeled = True
        else:
            raise KeyError(v)
    if any_modeled:
        bscale = _bytes_ratio(cfg, shape_name, **byte_kwargs) \
            if byte_kwargs else 1.0
        # sharding-schedule knobs change the collective term too
        coll_kw = {k: v for k, v in byte_kwargs.items()
                   if k in ("moe_ws", "ws_dense")}
        if coll_kw:
            cb = analysis.analytic_collective_bytes(cfg, shape_name)
            cn = analysis.analytic_collective_bytes(cfg, shape_name,
                                                    **coll_kw)
            coll_scale *= cn / max(cb, 1.0)
        row = _modeled_transform(row, bytes_scale=bscale,
                                 collective_scale=coll_scale, chip=chip,
                                 note="; ".join(notes))

    out = {
        "arch": arch, "shape": shape_name, "variant": variant,
        "chip": chip.name,
        "before": {k: base_row[k] for k in TERMS},
        "after": {k: row[k] for k in TERMS},
        "mem_gib_per_device": {"before": base_row["mem_gib_per_device"],
                               "after": row["mem_gib_per_device"]},
        "modeled": row.get("modeled", False),
        "note": row.get("model_note", ""),
        "wall_s": time.time() - t0,
    }
    sb, sa = (out["before"]["step_s_lower_bound"],
              out["after"]["step_s_lower_bound"])
    out["step_speedup"] = sb / sa if sa > 0 else 0.0
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"[perf] {arch} x {shape_name} + {variant} at {chip.name}: "
          f"{out['before']['bound']}->{out['after']['bound']}, "
          f"step {sb:.3e}->{sa:.3e} ({out['step_speedup']:.2f}x)"
          f"{' [modeled]' if out['modeled'] else ''}")
    return out


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variant", required=True)
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    return run_variant(args.arch, args.shape, args.variant, force=args.force)


if __name__ == "__main__":
    main()
