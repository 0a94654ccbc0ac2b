"""Activation sparsity — the ReLU-Llama technique (paper §V-A).

After ReLU most FFN hidden activations are exactly zero, so the rows of
W_down for those units never need to be read. The serving side: the
shared hidden activation, the dense and the top-k gathered
down-projections, the k the config asks for, and the Deja-Vu-style
low-rank predictor that self-speculation drafts with. The training side:
ReLU-fication, the sparsity measures (``sparsity_fraction``, the per-layer
EMA of ``SparsityStats``), the threshold mask and the masked-dense FFN
that the tests hold the sparse paths against, and the byte accounting.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops


def relufy_act(act_name: str) -> str:
    """ReLU Strikes Back: replace the smooth activation with ReLU to
    induce activation sparsity (fine-tuning recovers quality)."""
    return "relu"


def apply_act(x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "relu":
        return torch.relu(x)
    if act == "silu":
        return torch.nn.functional.silu(x)
    if act == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        return torch.nn.functional.gelu(x, approximate="tanh")
    if act == "relu2":
        r = torch.relu(x)
        return r * r
    raise ValueError(f"unknown activation {act!r}")


# ---------------------------------------------------------------------------
# Sparsity measurement


def sparsity_fraction(h: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Fraction of activations with |h| <= eps (exact zeros for ReLU), an
    f32 scalar."""
    return (h.abs() <= eps).float().mean()


@dataclasses.dataclass
class SparsityStats:
    """EMA tracker of per-layer activation sparsity: ``ema`` f32[n_layers],
    ``count`` i32[]. The reference registers it as a pytree; here it is a
    plain dataclass whose ``update`` returns a new one."""

    ema: torch.Tensor
    count: torch.Tensor
    decay: float = 0.99

    @classmethod
    def init(cls, n_layers: int, decay: float = 0.99,
             device: Optional[Union[str, torch.device]] = None
             ) -> "SparsityStats":
        """Zeros on ``device`` (default CUDA, see ``resolve_device``)."""
        device = resolve_device(device)
        return cls(ema=torch.zeros(n_layers, dtype=torch.float32,
                                   device=device),
                   count=torch.zeros((), dtype=torch.int32, device=device),
                   decay=decay)

    def update(self, layer_fracs: torch.Tensor) -> "SparsityStats":
        new = torch.where(self.count == 0, layer_fracs,
                          self.decay * self.ema
                          + (1 - self.decay) * layer_fracs)
        return SparsityStats(ema=new, count=self.count + 1,
                             decay=self.decay)


# ---------------------------------------------------------------------------
# Active-set selection


def topk_indices(h: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Indices of the k largest |h| along the last dim: (idx i32[..., k],
    valid bool[..., k]), ``valid`` marking entries that are nonzero."""
    mag = h.abs()
    top, idx = torch.topk(mag, k, dim=-1)
    return idx.to(torch.int32), top > 0


def threshold_mask(h: torch.Tensor, tau: float = 0.0) -> torch.Tensor:
    """Boolean mask of the active units (|h| > tau). Its count depends on
    the data, so only the masked-dense path uses it, not the gather."""
    return h.abs() > tau


def active_fraction_to_k(d_ff: int, frac: float, multiple: int = 128) -> int:
    """Target active fraction -> k, a multiple of ``multiple``."""
    k = max(multiple, int(round(d_ff * frac / multiple)) * multiple)
    return min(k, d_ff)


def ffn_hidden(x: torch.Tensor, w_up: torch.Tensor, act: str = "relu",
               w_gate: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The hidden activation h shared by the dense and the gathered
    down-projections."""
    if w_gate is not None:
        return apply_act(x @ w_gate, act) * (x @ w_up)
    return apply_act(x @ w_up, act)


def down_dense(h: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """Dense down-projection: streams all of W_down."""
    return h @ w_down


def down_sparse(h: torch.Tensor, w_down: torch.Tensor, k: int
                ) -> torch.Tensor:
    """Gathered down-projection (the paper's C2): contract only the top-k
    active units' rows of W_down. Inactive slots carry the sentinel index
    d_ff, which the gather kernel skips. h: [..., d_ff] -> [..., d]."""
    idx, valid = topk_indices(h, k)
    hk = torch.where(valid, torch.gather(h, -1, idx.long()), 0.0)
    idx = torch.where(valid, idx, w_down.shape[0])
    lead = h.shape[:-1]
    out = ops.sparse_gather_matvec(hk.reshape(-1, k).contiguous(),
                                   idx.reshape(-1, k).contiguous(), w_down)
    return out.reshape(*lead, w_down.shape[1]).to(h.dtype)


def dense_ffn(x, w_up, w_down, act="relu", w_gate=None):
    return down_dense(ffn_hidden(x, w_up, act, w_gate), w_down)


def masked_dense_ffn(x, w_up, w_down, act="relu", w_gate=None, tau=0.0):
    """Sparsity applied as a mask (no traffic saved; the correctness
    reference, equal to the dense FFN for ReLU at tau = 0)."""
    if w_gate is not None:
        g = apply_act(x @ w_gate, act)
        h = torch.where(threshold_mask(g, tau), g, 0.0) * (x @ w_up)
    else:
        h = apply_act(x @ w_up, act)
        h = torch.where(threshold_mask(h, tau), h, 0.0)
    return h @ w_down


def gathered_sparse_ffn(x, w_up, w_down, k, act="relu", w_gate=None):
    return down_sparse(ffn_hidden(x, w_up, act, w_gate), w_down, k)


# ---------------------------------------------------------------------------
# Deja-Vu-style sparsity predictor (low-rank logistic head)


@dataclasses.dataclass
class SparsityPredictor:
    """Predicts which FFN units will be active from the FFN input, so the
    W_up column gather and the W_down row gather can both be issued before
    the up-projection. ``w_in`` f32[d_model, r], ``w_out`` f32[r, d_ff];
    a stack of predictors (one per unit) carries a leading [n_units] axis
    on both, and ``unit(i)`` views one of them."""

    w_in: torch.Tensor
    w_out: torch.Tensor

    @classmethod
    def init(cls, generator: torch.Generator, d_model: int, d_ff: int,
             rank: int = 64) -> "SparsityPredictor":
        """f32 normal weights from ``generator``, on its device, at the
        reference's scales (1/sqrt(d_model), 1/sqrt(rank)): the
        reference's law, not its bits."""
        dev = generator.device
        return cls(w_in=torch.randn((d_model, rank), generator=generator,
                                    device=dev) * d_model ** -0.5,
                   w_out=torch.randn((rank, d_ff), generator=generator,
                                     device=dev) * rank ** -0.5)

    def unit(self, i: int) -> "SparsityPredictor":
        return SparsityPredictor(self.w_in[i], self.w_out[i])

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        return (x @ self.w_in) @ self.w_out

    def predict_topk(self, x: torch.Tensor, k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Top-k predicted-active indices: (idx i32[..., k], scores)."""
        val, idx = torch.topk(self.logits(x), k, dim=-1)
        return idx.to(torch.int32), val

    def loss(self, x: torch.Tensor, h_true: torch.Tensor) -> torch.Tensor:
        """Mean per-unit logistic loss against the true active mask."""
        z = self.logits(x)
        y = (h_true > 0).to(z.dtype)
        return torch.mean(torch.clamp(z, min=0) - z * y
                          + torch.log1p(torch.exp(-z.abs())))

    def recall_at_k(self, x: torch.Tensor, h_true: torch.Tensor,
                    k: int) -> torch.Tensor:
        """Fraction of the truly active mass the predicted top-k holds."""
        idx, _ = self.predict_topk(x, k)
        mag = h_true.abs()
        mass = mag.sum(dim=-1)
        picked = torch.gather(mag, -1, idx.long()).sum(dim=-1)
        return torch.mean(picked / torch.clamp(mass, min=1e-9))


def train_predictor(pred: SparsityPredictor, xs: torch.Tensor,
                    hs: torch.Tensor, lr: float = 1e-2,
                    steps: int = 100) -> SparsityPredictor:
    """Plain SGD on (FFN input, true hidden) pairs, the gradient of
    ``loss`` from torch.autograd (also inside a ``torch.no_grad``)."""
    w_in = pred.w_in.detach().clone().requires_grad_(True)
    w_out = pred.w_out.detach().clone().requires_grad_(True)
    for _ in range(steps):
        with torch.enable_grad():
            loss = SparsityPredictor(w_in, w_out).loss(xs, hs)
            g_in, g_out = torch.autograd.grad(loss, (w_in, w_out))
        with torch.no_grad():
            w_in -= lr * g_in
            w_out -= lr * g_out
    return SparsityPredictor(w_in.detach(), w_out.detach())


# ---------------------------------------------------------------------------
# Traffic accounting (the unit the paper argues in)


def ffn_weight_bytes(d_model: int, d_ff: int, bytes_per_el: float,
                     glu: bool, active_frac: float = 1.0) -> float:
    """Off-chip weight bytes of one FFN application at an active fraction:
    up (and gate) streamed whole, the W_down rows at ``active_frac``."""
    up = d_model * d_ff * bytes_per_el * (2.0 if glu else 1.0)
    down = d_model * d_ff * bytes_per_el * active_frac
    return up + down


def ffn_weight_bytes_predicted(d_model: int, d_ff: int, bytes_per_el: float,
                               glu: bool, active_frac: float,
                               predictor_rank: int) -> float:
    """Off-chip weight bytes of one FFN application with a predictor: the
    up/gate columns AND the down rows are gathered at ``active_frac``,
    and the predictor itself costs d*r + r*d_ff elements."""
    up = d_model * d_ff * bytes_per_el * (2.0 if glu else 1.0) * active_frac
    down = d_model * d_ff * bytes_per_el * active_frac
    pred = (d_model * predictor_rank + predictor_rank * d_ff) * bytes_per_el
    return up + down + pred
