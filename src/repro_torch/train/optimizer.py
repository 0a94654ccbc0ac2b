"""AdamW on trees of tensors, with an int8-moment variant (blockwise
scales): the port of ``repro.train.optimizer``.

The 8-bit variant keeps both Adam moments in int8 with per-256-block
scales (bitsandbytes-style), cutting optimizer state from 8 to about 2.03
bytes a parameter; v is held in sqrt-space, which compresses its dynamic
range (linear int8 v loses about 2x convergence on quadratic probes).

The schedule and the bias corrections are f32 tensors computed as jnp
computes them: Python floats would be f64 and drift from the reference.
The update returns new tensors (under ``torch.no_grad``) in the
reference's structures: an ``AdamState`` or ``Adam8State`` whose moment
trees have the params' structure.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.dist.compression import BLOCK, decode_int8, encode_int8
from repro_torch.tree import leaves, tree_map, unflatten


class AdamState(NamedTuple):
    step: torch.Tensor
    m: Any
    v: Any


class Adam8State(NamedTuple):
    step: torch.Tensor
    m_q: Any
    m_s: Any
    v_q: Any
    v_s: Any


def _i32(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(n, dtype=torch.int32, device=like.device)


def lr_schedule(cfg: TrainConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up, then a cosine down to 0.1 of ``cfg.lr``, of the
    i32 step: an f32 scalar."""
    warm = torch.clamp(step / _i32(max(cfg.warmup_steps, 1), step), max=1.0)
    prog = torch.clamp(
        (step - cfg.warmup_steps)
        / _i32(max(cfg.total_steps - cfg.warmup_steps, 1), step), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


@torch.no_grad()
def clip_by_global_norm(grads: Any, max_norm: float):
    """Scale the tree so its global L2 norm is at most ``max_norm``; the
    norm is summed leaf by leaf in the reference's order. Returns (grads,
    the norm before clipping)."""
    total = 0
    for g in leaves(grads):
        total = total + torch.sum(torch.square(g.float()))
    gn = torch.sqrt(total)
    # a tensor numerator: ``float / tensor`` multiplies by a reciprocal
    scale = torch.clamp(gn.new_tensor(max_norm) / (gn + 1e-9), max=1.0)
    return tree_map(lambda g: (g * scale).to(g.dtype), grads), gn


def _corrections(cfg: TrainConfig, step: torch.Tensor):
    """The step's learning rate and the bias corrections 1 - b ** step."""
    return (lr_schedule(cfg, step), 1 - cfg.beta1 ** step,
            1 - cfg.beta2 ** step)


def _apply(p, mh, vh, lr, cfg: TrainConfig):
    """The decoupled-decay AdamW step of one leaf: decay on matrices
    only."""
    delta = mh / (torch.sqrt(vh) + 1e-8)
    if p.ndim >= 2:
        delta = delta + cfg.weight_decay * p.float()
    return (p.float() - lr * delta).to(p.dtype)


# ---------------------------------------------------------------------------
# fp32-moment AdamW


def adam_init(params: Any) -> AdamState:
    return AdamState(
        step=torch.zeros((), dtype=torch.int32,
                         device=leaves(params)[0].device),
        m=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params),
        v=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params))


@torch.no_grad()
def adam_leaf(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
              v: torch.Tensor, lr: torch.Tensor, c1: torch.Tensor,
              c2: torch.Tensor, cfg: TrainConfig):
    """The fp32-moment AdamW step of one leaf (or of any block of it: the
    step is elementwise) at the step's ``lr`` and bias corrections
    (``_corrections``). Returns (p, m, v)."""
    gf = g.float()
    m2 = cfg.beta1 * m + (1 - cfg.beta1) * gf
    v2 = cfg.beta2 * v + (1 - cfg.beta2) * gf * gf
    return _apply(p, m2 / c1, v2 / c2, lr, cfg), m2, v2


@torch.no_grad()
def adam_update(params: Any, grads: Any, state: AdamState,
                cfg: TrainConfig):
    step = state.step + 1
    lr, c1, c2 = _corrections(cfg, step)
    out = [adam_leaf(p, g, m, v, lr, c1, c2, cfg)
           for p, g, m, v in zip(leaves(params), leaves(grads),
                                 leaves(state.m), leaves(state.v))]
    return (unflatten(params, [o[0] for o in out]),
            AdamState(step=step, m=unflatten(params, [o[1] for o in out]),
                      v=unflatten(params, [o[2] for o in out])))


# ---------------------------------------------------------------------------
# int8-moment AdamW: m quantizes linearly, v in sqrt-space


def adam8_init(params: Any) -> Adam8State:
    flat = leaves(params)

    def zq(p):
        nb = -(-p.numel() // BLOCK)
        return (torch.zeros((nb, BLOCK), dtype=torch.int8, device=p.device),
                torch.ones((nb, 1), dtype=torch.float32, device=p.device))

    qs = [zq(p) for p in flat]
    return Adam8State(
        step=torch.zeros((), dtype=torch.int32, device=flat[0].device),
        m_q=unflatten(params, [a for a, _ in qs]),
        m_s=unflatten(params, [b for _, b in qs]),
        v_q=unflatten(params, [a.clone() for a, _ in qs]),
        v_s=unflatten(params, [b.clone() for _, b in qs]))


@torch.no_grad()
def adam8_update(params: Any, grads: Any, state: Adam8State,
                 cfg: TrainConfig):
    step = state.step + 1
    lr, c1, c2 = _corrections(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    out = []
    for p, g, mq, ms, vq, vs in zip(
            leaves(params), leaves(grads), leaves(state.m_q),
            leaves(state.m_s), leaves(state.v_q), leaves(state.v_s)):
        gf = g.float()
        m = decode_int8(mq, ms, p.shape, p.numel())
        r = decode_int8(vq, vs, p.shape, p.numel())
        m2 = b1 * m + (1 - b1) * gf
        v2 = torch.clamp(b2 * (r * r) + (1 - b2) * gf * gf, min=0.0)
        out.append((_apply(p, m2 / c1, v2 / c2, lr, cfg), *encode_int8(m2),
                    *encode_int8(torch.sqrt(v2))))
    return (unflatten(params, [o[0] for o in out]),
            Adam8State(step=step,
                       m_q=unflatten(params, [o[1] for o in out]),
                       m_s=unflatten(params, [o[2] for o in out]),
                       v_q=unflatten(params, [o[3] for o in out]),
                       v_s=unflatten(params, [o[4] for o in out])))


def make_optimizer(cfg: TrainConfig):
    """(init, update) of the optimizer ``cfg`` asks for."""
    if cfg.adam_8bit:
        return adam8_init, adam8_update
    return adam_init, adam_update


def state_bytes(state: Any) -> int:
    """Bytes of an optimizer state's tensors."""
    return sum(t.numel() * t.element_size() for t in leaves(state))
