"""Static cost of one serving step per width bucket, counted from shapes.

The serving profiler (obs.profile) asks how close each width bucket of
``ModelRunner.step`` comes to the hardware roofline; this module supplies
the numerator: the FLOPs and bytes of one step, in total and per scope.
The reference reads them from XLA (``cost_analysis()`` totals and the
dots of the optimized HLO by ``jax.named_scope``). The port has no HLO:
it counts every product of the step from the model config and the bucket
(B = max_batch rows of S = width tokens, R = B*S row positions, per
attention layer):

  attn        the q, k, v and o projections over R rows, and QK and PV
              over ``n_keys`` keys: 4 * Hq * Dh * S * n_keys (kernel 1 on
              the card, or the plain masked read);
  ffn_dense   the up (and gate) projection and the dense down projection
              over R rows, in a step with prefill rows; an MoE block's
              whole second half in every step, as the reference scopes
              it: the f32 router product over R rows, the up (and gate)
              and down products of all E experts over ``moe.capacity(R)``
              rows each (empty slots are computed too), and the shared
              experts' dense FFN over R rows;
  ffn_sparse  the gathered down projection over the top-k rows of W_down
              (kernel 2: 2 * R * k * d, k = active_fraction_to_k), plus
              the up projection in a step without prefill rows (a mixed
              step computes the gather for every row too, as the reference
              does);
  logits      the projection of every position of the step to the vocab
              (a codebook model's: to each of its nc vocabularies, through
              the head [nc, d, V]);
  sample      the greedy sampler: argmax and log-softmax over [B, V]
              (0 for a codebook model, as the reference reports it);
  other       the elementwise work, one FLOP per element and operation as
              XLA counts it: RMS norms (4), RoPE (3), residual adds, the
              attention softmax (5 a score), the activation, top-k's |h|
              and selection, the gathers' masks, the mixed step's select;
              a codebook model's sum of its nc embeddings, and the
              sinusoidal position table's add where the config has one;
              the plain read's zero fill of the gathered K and V; the QKV
              bias adds (1) and the per-head q/k RMS norms (4) where the
              config has them; an MoE block's router softmax and top-k
              (6 a logit), its activations, the gates on its expert rows
              and the combine's adds.

Bytes follow the reference's convention for a product: its operands plus
its output, each once. Kernel 2 counts the k rows of W_down it fetches
for each row; the attention read counts the K and V of its keys, the
queries and the output. ``other`` counts the embedding rows gathered (nc
a position for a codebook model, whose tokens are [B, S, nc]) and the KV
rows the step writes.

``n_keys`` is the sum over rows of the keys the attention read covers.
On the card kernel 1 reads only each row's live blocks, so the profiler
passes the tick's live keys (the sum of ``row_start + n_valid`` rounded up
to whole blocks); the plain read (the CPU, or ``attn_backend="naive"``)
gathers every row's whole table, so its count is the table capacity,
B * blocks_per_seq * block_size, whatever ``n_keys`` says. A count at
capacity on the card would charge kernel 1 for KV it never reads.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.core import sparsity
from repro_torch.models import moe

# the reference's scope names; "other" is the elementwise remainder
SCOPES = ("attn", "ffn_dense", "ffn_sparse", "logits", "sample")

F32 = 4          # activations, logits and the sampler run in f32
I32 = 4          # kernel 2's indices, the block tables


@dataclasses.dataclass
class StepCost:
    """Static cost of ONE execution of a (width, has_prefill) bucket of
    the step at ``n_keys`` attention keys: totals and the per-scope split
    (which sums to the totals by construction); ``attributed_frac`` is
    the share of the FLOPs the named scopes (all but "other") hold."""

    width: int
    has_prefill: bool
    n_keys: float
    flops: float
    hbm_bytes: float
    by_scope: Dict[str, Dict[str, float]]

    @property
    def attributed_frac(self) -> float:
        scoped = sum(v["flops"] for k, v in self.by_scope.items()
                     if k != "other")
        return scoped / self.flops if self.flops else 0.0


def _product(m: float, k: float, n: float, w_bytes: float) -> tuple:
    """(flops, bytes) of x[m, k] @ W[k, n]: f32 activations in and out,
    the weight in its own dtype."""
    return 2.0 * m * k * n, (m * k + m * n) * F32 + k * n * w_bytes


def capacity_keys(scfg) -> int:
    """Keys the attention read covers when it reads every row's whole
    table."""
    return scfg.max_batch * scfg.blocks_per_seq * scfg.block_size


def plain_read(runner) -> bool:
    """True where the step's attention read gathers every row's whole
    table: the naive backend, and any backend on the CPU (where the
    kernels' plain versions run)."""
    return (runner.scfg.attn_backend != "flash"
            or runner.device.type != "cuda")


def step_cost(runner, width: int, has_prefill: bool,
              n_keys: Optional[float] = None) -> StepCost:
    """The cost of ``runner``'s (width, has_prefill) step at ``n_keys``
    attention keys (None: the table capacity)."""
    cfg, scfg = runner.cfg, runner.scfg
    B, S = scfg.max_batch, width
    R = B * S
    d, Hq, Kv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    f, V = cfg.d_ff, cfg.vocab
    w_bytes = runner.params["embed"].element_size()
    kv_bytes = 1 if scfg.kv_quant else F32
    if n_keys is None or plain_read(runner):
        n_keys = capacity_keys(scfg)
    scope = {name: [0.0, 0.0] for name in SCOPES + ("other",)}

    def add(name, cost):
        scope[name][0] += cost[0]
        scope[name][1] += cost[1]

    glu = cfg.glu
    sparse = cfg.relu_sparse
    k = sparsity.active_fraction_to_k(f, cfg.sparse_k_frac) if sparse else 0
    for kind in cfg.layer_kinds():
        # attention: projections, the read, the softmax and the KV write
        for n_out in (Hq * Dh, Kv * Dh, Kv * Dh):
            add("attn", _product(R, d, n_out, w_bytes))
        add("attn", _product(R, Hq * Dh, d, w_bytes))
        add("attn", (4.0 * Hq * Dh * S * n_keys,
                     2 * R * Hq * Dh * F32 + 2 * n_keys * Kv * Dh * kv_bytes
                     + B * scfg.blocks_per_seq * I32))
        other = (2 * 4 * R * d            # the two RMS norms
                 + 3 * R * (Hq + Kv) * Dh  # RoPE on q and k
                 + 2 * R * d              # the residual adds
                 + 5 * Hq * S * n_keys)   # the softmax
        if plain_read(runner):
            other += 2 * capacity_keys(scfg) * Kv * Dh     # the zero fill
        if cfg.qkv_bias:
            other += R * (Hq + 2 * Kv) * Dh
        if cfg.qk_norm:
            other += 4 * R * (Hq + Kv) * Dh
        add("other", (other, 2 * R * Kv * Dh * kv_bytes))
        if kind == "moe":
            _moe_cost(cfg, R, w_bytes, add)
            continue
        # FFN
        hidden = _product(R, d, f * (2 if glu else 1), w_bytes)
        act = R * f * (2 if glu else 1)
        dense = _product(R, f, d, w_bytes)
        gather = (2.0 * R * k * d,
                  R * k * (F32 + I32) + R * k * d * w_bytes + R * d * F32)
        select = R * f + R * f + 3 * R * k     # |h|, top-k, the masks
        if not sparse:
            add("ffn_dense", hidden)
            add("ffn_dense", dense)
            add("other", (act, 0.0))
        elif not has_prefill:
            add("ffn_sparse", hidden)
            add("ffn_sparse", gather)
            add("other", (act + select, 0.0))
        else:
            add("ffn_dense", hidden)
            add("ffn_dense", dense)
            add("ffn_sparse", gather)
            add("other", (act + select + R * d, 0.0))
    nc = cfg.n_codebooks or 1
    add("logits", _product(R, d, nc * V, w_bytes))
    # the final norm, the embedding rows gathered (and a codebook model's
    # sum of its nc), the sinusoidal positions' add
    other = 4 * R * d + (nc - 1) * R * d \
        + (R * d if cfg.pos_emb == "sin" else 0)
    add("other", (other, R * d * (nc * w_bytes + F32)))
    by_scope = {name: {"flops": v[0], "bytes": v[1]}
                for name, v in scope.items() if name != "sample"}
    return StepCost(width=width, has_prefill=has_prefill,
                    n_keys=float(n_keys),
                    flops=sum(v["flops"] for v in by_scope.values()),
                    hbm_bytes=sum(v["bytes"] for v in by_scope.values()),
                    by_scope=by_scope)


def _moe_cost(cfg, R: int, w_bytes: float, add) -> None:
    """An MoE block's second half over R routed rows (see the module's
    account); its products count each expert's weights once."""
    d, f, E, k = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.top_k
    n_up = 2 if cfg.glu else 1
    rows = E * moe.capacity(R, cfg)
    add("ffn_dense", _product(R, d, E, F32))                  # the router
    add("ffn_dense", (2.0 * rows * d * f * n_up,
                      (rows * d + rows * f * n_up) * F32
                      + E * d * f * n_up * w_bytes))
    add("ffn_dense", (2.0 * rows * f * d,
                      (rows * f + rows * d) * F32 + E * f * d * w_bytes))
    fs = f * cfg.n_shared_experts
    other = (6 * R * E                  # the router's softmax and top-k
             + rows * f * n_up          # the activation (and gate product)
             + rows * d                 # the gates on the expert rows
             + R * k * d)               # the combine's adds
    if fs:
        add("ffn_dense", _product(R, d, fs * n_up, w_bytes))
        add("ffn_dense", _product(R, fs, d, w_bytes))
        other += R * fs * n_up + R * d  # its activation, and its add
    add("other", (other, (R * k + rows) * I32))


def sampler_cost(batch: int, vocab: int,
                 n_codebooks: int = 0) -> Dict[str, float]:
    """The per-tick greedy sampler (the "sample" scope): argmax and the
    log-softmax of the chosen token over f32 logits [batch, vocab]. The
    filtered sampler costs more, which the table does not model. A codebook
    model's logits [batch, nc, vocab] get 0: the reference's compiled
    sampler does not take them and it reports 0 (the engine's per-codebook
    argmax goes uncounted there too)."""
    if n_codebooks:
        return {"flops": 0.0, "bytes": 0.0}
    return {"flops": 6.0 * batch * vocab,
            "bytes": float(batch * vocab * F32 + batch * 2 * 8)}


__all__ = ["SCOPES", "StepCost", "capacity_keys", "plain_read",
           "sampler_cost", "step_cost"]
