"""Mixture-of-Experts with capacity-based gather dispatch (GShard-style).

Dispatch needs no host decision: each (token, choice) assignment gets a
slot inside its expert from a stable rank computation, and assignments
past an expert's capacity (``capacity``, a host integer from the static
token count) are dropped. Expert compute is one batched product over all
E experts (``torch.bmm`` of the [E, cap, d] gathered tokens with the
[E, d, f] expert weights), the reference's ``einsum('ecd,edf->ecf')``.
Nothing in ``route`` or ``moe_forward`` reads a device value on the host
(no ``.item()``, no boolean-mask indexing, no data-dependent shape), so a
paged decode step of an MoE stack can be captured as a CUDA graph and
replayed (``transformer.decode_burst``).

MoE routing is itself structured activation sparsity: the paper's C2 at
expert granularity; with ``relu_sparse`` the ReLU applies inside the
routed expert as well.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import sparsity
from repro_torch.models import layers
from repro_torch.models.ffn import init_ffn


def init_moe(generator: torch.Generator, cfg: ModelConfig,
             dtype: torch.dtype, device: torch.device) -> dict:
    """The router (f32 in every config, as the reference keeps it), the
    stacked expert weights [E, d, f] / [E, f, d] (the reference's fan-in
    law, which takes the leading E axis as the fan-in) and the shared
    experts as one FFN of width d_ff * n_shared_experts."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"router": layers.dense_init(generator, (d, E), torch.float32,
                                     device),
         "w_up": layers.dense_init(generator, (E, d, f), dtype, device),
         "w_down": layers.dense_init(generator, (E, f, d), dtype, device)}
    if cfg.glu:
        p["w_gate"] = layers.dense_init(generator, (E, d, f), dtype, device)
    if cfg.n_shared_experts:
        p["shared"] = init_ffn(generator, cfg, dtype, device,
                               d_ff=cfg.d_ff * cfg.n_shared_experts)
    return p


def capacity(tokens: int, cfg: ModelConfig) -> int:
    c = int(math.ceil(tokens * cfg.top_k / cfg.n_experts
                      * cfg.capacity_factor))
    return max(8, ((c + 7) // 8) * 8)  # pad to a multiple of 8


def route(router_logits: torch.Tensor, cfg: ModelConfig, cap: int):
    """router_logits f32[T, E] -> dispatch tables.

    Returns:
      table: i32[E, cap]  token id feeding each (expert, slot); T = empty
      gates: f32[E, cap]  combine weight per slot (0 for empty)
      aux:   the load-balancing loss (Switch-style), a 0-d f32 tensor

    An assignment's slot is its rank among the assignments to its expert
    in (token, choice) order: a stable sort by expert and the start of
    each expert's run (``searchsorted``). Dropped assignments write the
    spill column ``cap`` of expert 0 (all with the same values, so the
    write is deterministic), which is sliced off, as the reference's
    ``mode="drop"`` scatter drops them."""
    T, E = router_logits.shape
    k, dev = cfg.top_k, router_logits.device
    probs = torch.softmax(router_logits.float(), dim=-1)
    gate_vals, expert_idx = torch.topk(probs, k, dim=-1)        # [T, k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)

    flat_e = expert_idx.reshape(-1)                             # [T*k]
    flat_g = gate_vals.reshape(-1)
    n = flat_e.shape[0]
    pos = torch.arange(n, device=dev)
    token_id = pos // k

    sorted_e, order = torch.sort(flat_e, stable=True)
    starts = torch.searchsorted(sorted_e, torch.arange(E, device=dev),
                                side="left")                    # [E]
    rank = torch.empty_like(flat_e)
    rank[order] = pos - starts[sorted_e]

    keep = rank < cap
    slot = torch.where(keep, rank, cap)                         # cap = spill
    e_safe = torch.where(keep, flat_e, 0)
    table = torch.full((E, cap + 1), T, dtype=torch.int32, device=dev)
    table[e_safe, slot] = torch.where(keep, token_id, T).to(torch.int32)
    gates = torch.zeros((E, cap + 1), dtype=torch.float32, device=dev)
    gates[e_safe, slot] = torch.where(keep, flat_g, 0.0)

    # aux loss: fraction of tokens per expert * mean router prob per expert
    me = probs.mean(0)
    ce = (expert_idx[:, :1] == torch.arange(E, device=dev)).float().mean(0)
    aux = E * (me * ce).sum()
    return table[:, :cap], gates[:, :cap], aux


def combine(ye: torch.Tensor, table: torch.Tensor, T: int,
            k: int) -> torch.Tensor:
    """out[t] = the sum of the expert rows ``ye`` [E, cap, d] whose slot
    holds token t, [T, d] in ye's dtype. The reference scatter-adds every
    slot into a zero buffer in slot order (expert-major); here each
    token's (at most k) slots are found by a stable sort of the table and
    added to zero in that same order, one choice at a time, so a bf16
    model rounds as the reference does, and no atomics make the sum
    differ from run to run on the card."""
    E, cap, d = ye.shape
    dev = ye.device
    flat = table.reshape(-1).long()
    sorted_t, where = torch.sort(flat, stable=True)
    ids = torch.arange(T, device=dev)
    first = torch.searchsorted(sorted_t, ids, side="left")
    count = torch.searchsorted(sorted_t, ids, side="right") - first
    rows = torch.cat([ye.reshape(E * cap, d), ye.new_zeros(1, d)])
    out = ye.new_zeros(T, d)
    for c in range(k):
        at = (first + c).clamp(max=flat.numel() - 1)
        src = torch.where(c < count, where[at], E * cap)
        out = out + rows[src]
    return out


def moe_forward(p: dict, cfg: ModelConfig, x: torch.Tensor):
    """x: [B, S, d] -> ([B, S, d], aux_loss). Every one of the B*S rows is
    routed (a serving step's idle and padding rows too, as in the
    reference), so ``capacity`` counts them."""
    B, S, d = x.shape
    T = B * S
    xt = x.reshape(T, d)
    cap = capacity(T, cfg)
    # the router stays f32: a bf16 model's activations widen exactly, as
    # jnp promotes them in the reference's product
    table, gates, aux = route(xt.to(p["router"].dtype) @ p["router"], cfg,
                              cap)

    xpad = torch.cat([xt, xt.new_zeros(1, d)])
    xe = xpad[table.long()]                                     # [E, cap, d]
    act = "relu" if cfg.relu_sparse else cfg.act
    up = torch.bmm(xe, p["w_up"])
    if cfg.glu:
        h = sparsity.apply_act(torch.bmm(xe, p["w_gate"]), act) * up
    else:
        h = sparsity.apply_act(up, act)
    ye = torch.bmm(h, p["w_down"])                              # [E, cap, d]
    ye = ye * gates[..., None].to(ye.dtype)
    out = combine(ye, table, T, cfg.top_k)

    if cfg.n_shared_experts:
        sh = p["shared"]
        out = out + sparsity.dense_ffn(xt, sh["w_up"], sh["w_down"], act=act,
                                       w_gate=sh.get("w_gate"))
    return out.reshape(B, S, d), aux


def moe_reference(p: dict, cfg: ModelConfig, x: torch.Tensor):
    """Dense oracle: every expert computed for every token, combined by the
    full top-k gate. O(T*E*f): tests only."""
    B, S, d = x.shape
    xt = x.reshape(-1, d)
    probs = torch.softmax((xt.to(p["router"].dtype) @ p["router"]).float(),
                          dim=-1)
    vals, idx = torch.topk(probs, cfg.top_k, dim=-1)
    vals = vals / vals.sum(-1, keepdim=True)
    gates = torch.zeros_like(probs).scatter(1, idx, vals)      # [T, E]
    act = "relu" if cfg.relu_sparse else cfg.act
    up = torch.einsum("td,edf->tef", xt, p["w_up"])
    if cfg.glu:
        g = sparsity.apply_act(
            torch.einsum("td,edf->tef", xt, p["w_gate"]), act)
        h = g * up
    else:
        h = sparsity.apply_act(up, act)
    ye = torch.einsum("tef,efd->ted", h, p["w_down"])
    out = torch.einsum("ted,te->td", ye, gates.to(ye.dtype))
    if cfg.n_shared_experts:
        sh = p["shared"]
        out = out + sparsity.dense_ffn(xt, sh["w_up"], sh["w_down"], act=act,
                                       w_gate=sh.get("w_gate"))
    return out.reshape(B, S, d)
