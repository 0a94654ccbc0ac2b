"""Heterogeneous kernel dispatch (paper C4).

NeCTAr places dense engines near memory and sparse engines near cores, and
routes each kernel class to the engine whose placement matches its
bottleneck. The analogue here: classify every matmul site by arithmetic
intensity against a chip's ridge point and route it to the matching
implementation:

  * ``gemv_stream``   — memory-bound weight streaming (decode): the W8A8
                        NMCE kernel (int8 weights, activation-stationary;
                        ``kernels.ops.nmce_matmul`` on the card);
  * ``gemm_mxu``      — compute-bound (train/prefill): a plain dense
                        product (``torch.matmul``, cuBLAS on the card);
  * ``sparse_gather`` — the ReLU-sparse FFN contraction: the gather kernel
                        (``kernels.ops.sparse_gather_matvec``).

The classifier takes the chip's ridge point, bf16 peak over HBM rate:
about 240 FLOP/byte on the TPU v5e (``roofline.hw.V5E``, the default, so
both packages decide alike) and about 295 on the H100 SXM
(``roofline.hw.H100_SXM``, passed explicitly where the card is meant).
Sites below the ridge are memory-bound. The rule is the reference's at
any chip: nothing here is specific to Hopper.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

from repro_torch.roofline import hw


@dataclasses.dataclass(frozen=True)
class MatmulSite:
    """One matmul in the model: (batch*seq rows) x (K) @ (K, N)."""
    rows: int
    k: int
    n: int
    weight_bits: int = 16
    act_bits: int = 16
    sparsity: float = 0.0     # fraction of K (or N) rows skippable


def arithmetic_intensity(site: MatmulSite) -> float:
    """FLOPs per HBM byte, counting streamed weights + acts + outputs."""
    flops = 2.0 * site.rows * site.k * site.n
    wbytes = site.k * site.n * site.weight_bits / 8.0
    abytes = site.rows * (site.k + site.n) * site.act_bits / 8.0
    return flops / (wbytes + abytes)


def classify(site: MatmulSite, chip: hw.Chip = hw.V5E) -> str:
    ridge = chip.peak_flops / chip.hbm_bw  # flops per byte at the knee
    if site.sparsity >= 0.5 and site.rows <= 256:
        return "sparse_gather"
    if arithmetic_intensity(site) < ridge:
        return "gemv_stream"
    return "gemm_mxu"


@dataclasses.dataclass
class Dispatcher:
    """Binds regimes to callables; a caller sends each site through this so
    the heterogeneous policy is swappable (and mockable in tests). Returns
    (the bound callable's result, the regime). ``chip`` is the one
    ``classify`` judges against; ``override`` forces one regime."""

    impls: Dict[str, Callable]
    override: Optional[str] = None
    chip: hw.Chip = hw.V5E

    def __call__(self, site: MatmulSite, *args, **kwargs):
        regime = self.override or classify(site, self.chip)
        return self.impls[regime](*args, **kwargs), regime


def decode_regime_report(d_model: int, d_ff: int, vocab: int,
                         batch: int, chip: hw.Chip = hw.V5E) -> Dict[str, str]:
    """Which engine each decode-step matmul site lands on: the
    heterogeneous placement decision table."""
    sites = decode_sites(d_model, d_ff, vocab, batch)
    return {name: classify(s, chip) for name, s in sites.items()}


def decode_sites(d_model: int, d_ff: int, vocab: int,
                 batch: int) -> Dict[str, MatmulSite]:
    """The decode step's matmul sites ``decode_regime_report`` classifies."""
    return {
        "attn_qkvo": MatmulSite(rows=batch, k=d_model, n=d_model),
        "ffn_up": MatmulSite(rows=batch, k=d_model, n=d_ff),
        "ffn_down_sparse": MatmulSite(rows=batch, k=d_ff, n=d_model,
                                      sparsity=0.9),
        "lm_head": MatmulSite(rows=batch, k=d_model, n=vocab),
    }
