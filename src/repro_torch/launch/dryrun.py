"""Dry run of every (arch x shape x mesh) cell, counted from shapes.

The reference's dry run lowers each cell on 512 forced host devices and
reads XLA's HLO for memory, costs and collective bytes. The port has no
XLA. It counts each cell from shapes instead, and allocates nothing:

  * ``input_specs`` and ``cache_specs`` give the cell's inputs and decode
    cache as tensors on the ``meta`` device (shape and dtype, no
    storage), the frontends' inputs included: qwen2-vl's
    ``vision_embeds`` and M-RoPE positions, musicgen's codebook tokens;
  * the params (and, for a train cell, the optimizer state) are
    ``Model.init`` on the meta device;
  * ``estimate_cell_memory`` takes each leaf's shard shape from the
    port's own ``params_shardings``, ``cache_shardings`` (and the train
    step's optimizer specs) and ``block_slices`` on the production mesh,
    a ``launch.mesh.Mesh`` over meta devices (``production_mesh``);
  * the collective bytes come from ``roofline.analysis``'s
    ``analytic_collective_bytes``, recorded per device and unit in the
    layout ``parse_collectives`` gives (the key ``cell_roofline`` reads).

Records: build/dryrun/<arch>__<shape>__<mesh>.json
(``roofline.analysis.ART_DIR``; cached: cells that already have a record
are skipped unless --force). ``roofline.analysis`` reads them.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape decode_32k
  python -m repro_torch.launch.dryrun --all [--mesh pod|multipod|both]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import time
import traceback
from collections import defaultdict
from typing import Optional

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import (SHAPES, ModelConfig, TrainConfig,
                                      applicable_shapes)
from repro_torch.dist import sharding as shd
from repro_torch.launch.mesh import Mesh, make_production_mesh, mesh_info
from repro_torch.models import Model
from repro_torch.roofline import analysis
from repro_torch.train import loop as train_loop
from repro_torch.train import optimizer as opt

ARCHS = [
    "llama3.2-1b", "granite-34b", "qwen3-4b", "qwen2.5-3b",
    "llama4-maverick-400b-a17b", "moonshot-v1-16b-a3b", "qwen2-vl-72b",
    "zamba2-2.7b", "musicgen-medium", "xlstm-125m",
]

META = torch.device("meta")


# ---------------------------------------------------------------------------
# Per-arch dry-run policies (the reference's, derived from its HBM budget)


# perf-variant hook: per-config policy overrides
POLICY_OVERRIDES = {}


def train_config(cfg: ModelConfig) -> TrainConfig:
    big = cfg.param_count() > 30e9
    return TrainConfig(adam_8bit=big, microbatch=0)


def train_policy(cfg: ModelConfig) -> shd.ShardingPolicy:
    # seq_shard (Megatron-SP residuals): without it, deep models blow the
    # HBM budget on the unit-boundary residuals (88 layers x [16,4096,d]
    # bf16 ~= 70 GiB/device for granite-34b).
    resid = (cfg.n_units * (256 // 16) * 4096 * cfg.d_model * 2)
    base = shd.ShardingPolicy(fsdp=True,
                              seq_shard=resid > 6 * 2 ** 30,
                              pod_param_shard=cfg.param_count() > 100e9)
    return dataclasses.replace(base, **POLICY_OVERRIDES.get(cfg.name, {}))


def serve_policy(cfg: ModelConfig) -> shd.ShardingPolicy:
    # big models can't replicate weights across the data axis at decode
    base = shd.ShardingPolicy(fsdp=cfg.param_count() > 30e9,
                              seq_shard=False, shard_kv_seq=True)
    return dataclasses.replace(base, **POLICY_OVERRIDES.get(cfg.name, {}))


def production_mesh(multi_pod: bool = False) -> Mesh:
    """The production mesh plan (``make_production_mesh``) as a ``Mesh``
    over meta devices: shard decisions and block shapes, no device
    touched."""
    shape = make_production_mesh(multi_pod=multi_pod)
    return Mesh(shape, (META,) * math.prod(shape.values()))


# ---------------------------------------------------------------------------
# input_specs: meta-tensor stand-ins for every model input


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(cfg: ModelConfig, shape_name: str) -> dict:
    """Shape/dtype stand-ins (no allocation) for one assigned shape."""
    sh = SHAPES[shape_name]
    B, S, kind = sh["batch"], sh["seq"], sh["kind"]
    i32, f32, bf16 = torch.int32, torch.float32, torch.bfloat16

    def frontends(batch):
        if cfg.frontend == "vision_stub":
            batch["vision_embeds"] = _spec((B, S // 4, cfg.d_model), bf16)
            batch["mrope_positions"] = _spec((3, B, S), i32)
        if cfg.frontend == "audio_stub":
            batch["audio_embeds"] = _spec((B, S // 4, cfg.d_model), bf16)
        return batch

    if kind == "train":
        tok_shape = (B, S, cfg.n_codebooks) if cfg.n_codebooks else (B, S)
        return {"batch": frontends({"tokens": _spec(tok_shape, i32),
                                    "labels": _spec(tok_shape, i32),
                                    "mask": _spec((B, S), f32)})}

    if kind == "prefill":
        tok_shape = (B, S, cfg.n_codebooks) if cfg.n_codebooks else (B, S)
        return {"batch": frontends({"tokens": _spec(tok_shape, i32)}),
                "cache": cache_specs(cfg, B, S)}

    # decode: one new token against a KV cache of length S
    tok_shape = (B, 1, cfg.n_codebooks) if cfg.n_codebooks else (B, 1)
    return {"tokens": _spec(tok_shape, i32), "cache": cache_specs(cfg, B, S)}


def cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """The slot engine's decode cache of ``batch`` rows of ``max_len``
    positions, bf16, on the meta device."""
    return Model(cfg).init_cache(batch, max_len, torch.bfloat16, device=META)


def param_specs(cfg: ModelConfig) -> dict:
    """The param tree of ``cfg`` on the meta device."""
    return Model(cfg).init(torch.Generator(), device=META)


# ---------------------------------------------------------------------------
# HLO collective parsing (for HLO text from elsewhere: the port has none)

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
_DTYPE_BYTES = {"f64": 8, "f32": 4, "bf16": 2, "f16": 2, "s64": 8, "u64": 8,
                "s32": 4, "u32": 4, "s16": 2, "u16": 2, "s8": 1, "u8": 1,
                "pred": 1, "f8e4m3fn": 1, "f8e5m2": 1}
_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")


def _shape_bytes(txt: str) -> float:
    total = 0.0
    for dt, dims in _SHAPE_RE.findall(txt):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def parse_collectives(hlo_text: str) -> dict:
    """Sum PER-DEVICE operand bytes of every collective op in an (SPMD-
    partitioned, per-device) HLO text. Ops inside while loops are counted
    once."""
    per_op = defaultdict(float)
    counts = defaultdict(int)
    for line in hlo_text.splitlines():
        line = line.strip()
        m = re.search(r"=\s*(.+?)\s+(" + "|".join(_COLLECTIVES)
                      + r")(?:-start|-done)?\(", line)
        if not m:
            continue
        op = m.group(2)
        if "-done(" in line:
            continue  # avoid double counting start/done pairs
        # operand bytes approximated by the output shape (all-reduce and
        # permute: the same size; all-gather: an upper bound of the link
        # traffic per device)
        out_bytes = _shape_bytes(m.group(1))
        per_op[op] += out_bytes
        counts[op] += 1
    return {"bytes_by_type": dict(per_op), "counts": dict(counts),
            "total_bytes": float(sum(per_op.values()))}


# ---------------------------------------------------------------------------
# Analytic per-device memory


def _sharded_tree_bytes(tree, specs, mesh: Mesh) -> float:
    """Bytes of one device's blocks of ``tree`` placed per ``specs`` (a
    0-d leaf counts 0, as the reference's count of shard shapes)."""
    total = [0.0]

    def one(leaf, spec):
        local = tuple(s.stop - s.start for s in shd.block_slices(
            spec, leaf.shape, mesh, 0))
        if local:
            total[0] += float(math.prod(local)) * leaf.element_size()
    shd.map_with(one, tree, specs)
    return total[0]


def estimate_cell_memory(cfg: ModelConfig, shape_name: str, mesh: Mesh,
                         policy, params_sh, p_shard, opt_sh=None,
                         o_shard=None, cache_sh=None, c_shard=None) -> dict:
    """The reference's analytic per-device memory of one cell (GiB):
    params, optimizer state, grads, residuals and the per-unit workspace
    of a train step; params, cache and workspace of a serve step. The
    ``*_sh`` trees hold the leaves' shapes, the ``*_shard`` trees their
    specs on ``mesh``."""
    sh = SHAPES[shape_name]
    B, S, kind = sh["batch"], sh["seq"], sh["kind"]
    dpn = mesh.shape.get("data", 1) * mesh.shape.get("pod", 1)
    mo = mesh.shape.get("model", 1)
    B_l = B // dpn if B % dpn == 0 else B
    S_l = S // mo if (policy.seq_shard and S % mo == 0) else S

    params_b = _sharded_tree_bytes(params_sh, p_shard, mesh)
    out = {"params_gib": params_b / 2 ** 30}
    total = params_b
    if kind == "train":
        opt_b = _sharded_tree_bytes(opt_sh, o_shard, mesh)
        grads_b = params_b  # transient, same sharding/dtype as params
        resid_b = cfg.n_units * B_l * S_l * cfg.d_model * 2.0
        # per-unit workspace: gathered unit weights (FSDP gather over dp;
        # stays TP-sharded) x2 double-buffer + attention/ffn transients
        unit_params = params_b / max(cfg.n_units, 1) * dpn
        d_attn = cfg.n_heads * cfg.d_head
        kv_dim = cfg.n_kv_heads * cfg.d_head
        # flash per-unit liveset: q/o/do bf16 + dq f32 (query side) and
        # k/v bf16 + dk/dv f32 (kv side, GQA-small)
        attn_ws = B_l * S * (10.0 * d_attn + 12.0 * kv_dim)
        logits_ws = 4.0 * B_l * min(S, 512) * cfg.vocab / max(mo, 1)
        ws = 2 * unit_params + attn_ws + logits_ws
        out.update(opt_gib=opt_b / 2 ** 30, grads_gib=grads_b / 2 ** 30,
                   residuals_gib=resid_b / 2 ** 30,
                   workspace_gib=ws / 2 ** 30)
        total += opt_b + grads_b + resid_b + ws
    else:
        cache_b = _sharded_tree_bytes(cache_sh, c_shard, mesh) \
            if cache_sh else 0.0
        d_attn = cfg.n_heads * cfg.d_head
        if kind == "prefill":
            ws = 6.0 * B_l * S * max(d_attn, cfg.d_model) * 2.0
        else:
            ws = 4.0 * B_l * (S / max(mo, 1)) * max(d_attn, cfg.d_model) * 4.0
        unit_params = params_b / max(cfg.n_units, 1) * \
            (dpn if policy.fsdp else 1)
        ws += 2 * unit_params
        out.update(cache_gib=cache_b / 2 ** 30, workspace_gib=ws / 2 ** 30)
        total += cache_b + ws
    out["total_gib"] = total / 2 ** 30
    return out


# ---------------------------------------------------------------------------
# Cell construction


def build_cell(cfg: ModelConfig, shape_name: str, mesh: Mesh):
    """(policy, the cell's inputs, its analytic memory): the counterpart
    of the reference's ``build_lowerable``, which lowers what this counts
    from shapes."""
    kind = SHAPES[shape_name]["kind"]
    specs = input_specs(cfg, shape_name)
    params_sh = param_specs(cfg)
    if kind == "train":
        tcfg = train_config(cfg)
        policy = train_policy(cfg)
        init, _ = opt.make_optimizer(tcfg)
        opt_sh = init(params_sh)
        p_shard = shd.params_shardings(params_sh, cfg, mesh, policy)
        o_shard = train_loop._opt_shardings(opt_sh, p_shard, mesh)
        mem = estimate_cell_memory(cfg, shape_name, mesh, policy,
                                   params_sh, p_shard, opt_sh, o_shard)
        return policy, specs, mem
    policy = serve_policy(cfg)
    p_shard = shd.params_shardings(params_sh, cfg, mesh, policy)
    c_shard = shd.map_with_path(shd.cache_shardings(
        cfg, mesh, SHAPES[shape_name]["batch"], policy), specs["cache"])
    mem = estimate_cell_memory(cfg, shape_name, mesh, policy, params_sh,
                               p_shard, cache_sh=specs["cache"],
                               c_shard=c_shard)
    return policy, specs, mem


def _shapes(tree) -> object:
    """A tree of tensors as [shape, dtype] lists (for the record)."""
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return [list(tree.shape), str(tree.dtype).replace("torch.", "")]


def collective_record(cfg: ModelConfig, shape_name: str, chips: int,
                      moe_ws: bool = False) -> dict:
    """The analytic link bytes of one step per device and unit, in the
    layout of ``parse_collectives`` (no op is counted by type)."""
    total = analysis.analytic_collective_bytes(cfg, shape_name, chips,
                                               moe_ws=moe_ws)
    return {"bytes_by_type": {}, "counts": {},
            "total_bytes": total / chips / cfg.n_units,
            "source": "analytic_collective_bytes"}


# ---------------------------------------------------------------------------
# Runner


def run_cell(arch: str, shape_name: str, mesh_kind: str = "pod",
             force: bool = False) -> dict:
    """Count one cell and write its record into ``analysis.ART_DIR``
    (cached unless ``force``)."""
    os.makedirs(analysis.ART_DIR, exist_ok=True)
    path = os.path.join(analysis.ART_DIR,
                        f"{arch}__{shape_name}__{mesh_kind}.json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)

    cfg = get_config(arch)
    mesh = production_mesh(multi_pod=(mesh_kind == "multipod"))
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_info(mesh),
           "kind": SHAPES[shape_name]["kind"], "ok": False,
           "method": "analytic"}
    t0 = time.time()
    try:
        policy, specs, mem = build_cell(cfg, shape_name, mesh)
        moe_ws = bool(POLICY_OVERRIDES.get(arch, {}).get(
            "moe_weight_stationary", False))
        rec.update({
            "ok": True,
            "policy": dataclasses.asdict(policy),
            "inputs": _shapes(specs),
            "memory_analytic": mem,
            # no compiled memory analysis (the reference's CPU upper bound)
            "memory": {"per_device_total_gib": None},
            "cost_analytic": {
                "flops_global": analysis.analytic_hlo_flops(cfg, shape_name),
                "bytes_global": analysis.analytic_hlo_bytes(
                    cfg, shape_name, moe_ws=moe_ws)},
            "collectives_loopbody_once": collective_record(
                cfg, shape_name, mesh.size, moe_ws),
            "probes": {"probe_mode": "analytic",
                       "note": "counted from shapes: no lowering"},
        })
    except Exception as e:  # noqa: BLE001 — record the failure verbatim
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["wall_s"] = time.time() - t0

    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    status = "OK" if rec["ok"] else f"FAIL ({rec.get('error', '')[:120]})"
    print(f"[dryrun] {arch} x {shape_name} x {mesh_kind}: {status} "
          f"({rec['wall_s']:.2f}s)")
    return rec


def all_cells():
    for arch in ARCHS:
        cfg = get_config(arch)
        for shape_name in applicable_shapes(cfg):
            yield arch, shape_name


def main(argv: Optional[list] = None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="pod",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = list(all_cells())
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape, or --all")
    results = [run_cell(arch, shape_name, mk, force=args.force)
               for arch, shape_name in cells for mk in meshes]
    n_ok = sum(r["ok"] for r in results)
    print(f"[dryrun] {n_ok}/{len(results)} cells OK")
    if n_ok < len(results):
        raise SystemExit(1)
    return results


if __name__ == "__main__":
    main()
