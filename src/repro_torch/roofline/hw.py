"""Hardware constants for roofline analysis: the NVIDIA H100 SXM5 the port
runs on (the default chip of ``ridge_point`` and ``roofline_terms``), the
reference's nominal CPU host, and the reference's TPU v5e, kept as a named
chip only so that tests can hold the port's decisions to the reference's.

H100_SXM is NVIDIA's H100 Tensor Core GPU datasheet, SXM5 column, dense
rates (without structured sparsity) at the part's 700 W: 989.4 TFLOP/s
bf16, 1,978.9 TOP/s int8, 66.9 TFLOP/s f32 outside the tensor cores,
3.35 TB/s of HBM3, 80 GB, NVLink 4 at 900 GB/s over 18 links, PCIe Gen5
at 128 GB/s; 228 KiB of shared memory per SM (the NVIDIA Hopper tuning
guide) takes the ``vmem_bytes`` role. A card set below 700 W runs slower
than these figures.

The port's ``Chip`` carries one field the reference's has not,
``peak_f32_flops``: the port serves in f32 with TF32 off, so a step is
judged against the peak of its weights' dtype (``peak_for``). V5E's f32
figure is its bf16 peak, the rate the reference's roofline judged every
step against; CPU_HOST's equals its ``peak_flops``.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Chip:
    name: str
    peak_flops: float          # bf16 FLOP/s
    peak_int8_ops: float       # int8 OP/s
    hbm_bw: float              # bytes/s
    ici_bw: float              # bytes/s per link
    ici_links: int             # links per chip
    dcn_bw: float              # bytes/s per chip, across hosts
    hbm_gib: float             # device memory per chip
    vmem_bytes: int            # on-core scratch (VMEM; shared memory per SM)
    peak_f32_flops: float      # f32 FLOP/s


V5E = Chip(
    name="tpu-v5e",
    peak_flops=197e12,
    peak_int8_ops=394e12,
    hbm_bw=819e9,
    ici_bw=50e9,
    ici_links=4,
    dcn_bw=6.25e9,
    hbm_gib=16.0,
    vmem_bytes=128 * 1024 * 1024 // 8,
    peak_f32_flops=197e12,
)

# The reference's nominal CPU-host spec for serving attainment on machines
# without an accelerator: deliberately on the high side, so that measured
# CPU runs land strictly below the roofline (attainment stays in (0, 1]).
CPU_HOST = Chip(
    name="cpu-host",
    peak_flops=2e12,
    peak_int8_ops=4e12,
    hbm_bw=100e9,              # DRAM, not HBM: the same roofline role
    ici_bw=0.0,
    ici_links=0,
    dcn_bw=12.5e9,
    hbm_gib=64.0,
    vmem_bytes=32 * 1024 * 1024,
    peak_f32_flops=2e12,
)

H100_SXM = Chip(
    name="h100-sxm",
    peak_flops=989.4e12,
    peak_int8_ops=1978.9e12,
    hbm_bw=3.35e12,
    ici_bw=50e9,               # NVLink 4: 900 GB/s over 18 links
    ici_links=18,
    dcn_bw=128e9,              # PCIe Gen5, the host link
    hbm_gib=80.0,
    vmem_bytes=228 * 1024,
    peak_f32_flops=66.9e12,
)

CHIPS = {c.name: c for c in (V5E, CPU_HOST, H100_SXM)}

# torch.cuda.get_device_name of the parts in CHIPS; any other card (the
# PCIe H100 has 2.0 TB/s, not 3.35) is refused rather than judged as one
H100_SXM_NAMES = ("NVIDIA H100 80GB HBM3",)


def active_chip(device=None) -> Chip:
    """The spec attainment is judged against, for the runner's ``device``
    (a torch.device or its name, CUDA by default as every entry point of
    the port; a chip name from CHIPS also works): CPU_HOST on the CPU,
    H100_SXM on an H100 SXM card. Any other card raises ValueError naming
    it."""
    if isinstance(device, str) and device in CHIPS:
        return CHIPS[device]
    dev = resolve_device(device)
    if dev.type == "cpu":
        return CPU_HOST
    name = torch.cuda.get_device_name(dev)
    if name in H100_SXM_NAMES:
        return H100_SXM
    raise ValueError(f"no roofline spec for the card {name!r}: known "
                     f"{H100_SXM_NAMES} (chip {H100_SXM.name})")


def peak_for(chip: Chip, dtype: torch.dtype) -> float:
    """The chip's peak operation rate for products in ``dtype``."""
    if dtype in (torch.float32, torch.float64):
        return chip.peak_f32_flops
    if dtype in (torch.int8, torch.uint8):
        return chip.peak_int8_ops
    return chip.peak_flops


def ridge_point(chip: Chip = H100_SXM, dtype_bits: int = 16) -> float:
    """FLOPs/byte at the memory/compute knee."""
    peak = chip.peak_flops if dtype_bits >= 16 else chip.peak_int8_ops
    return peak / chip.hbm_bw


def roofline_terms(flops: float, hbm_bytes: float, collective_bytes: float,
                   n_chips: int, chip: Chip = H100_SXM,
                   collective_bw: float | None = None,
                   peak: float | None = None) -> dict:
    """The three-term roofline (seconds) and the dominant bottleneck.

    ``flops``/``hbm_bytes``/``collective_bytes`` are GLOBAL (whole step,
    all chips); each term divides by aggregate machine capability.
    ``peak`` overrides the chip's bf16 rate (``peak_for`` a dtype).
    """
    bw = collective_bw if collective_bw is not None else chip.ici_bw
    peak = chip.peak_flops if peak is None else peak
    t_compute = flops / (n_chips * peak)
    t_memory = hbm_bytes / (n_chips * chip.hbm_bw)
    t_collective = (collective_bytes / (n_chips * bw)) if collective_bytes \
        else 0.0
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_collective}
    terms["bound"] = max(terms, key=lambda k: terms[k])
    terms["step_s_lower_bound"] = max(t_compute, t_memory, t_collective)
    return terms


__all__ = ["CHIPS", "CPU_HOST", "Chip", "H100_SXM", "H100_SXM_NAMES", "V5E",
           "active_chip", "peak_for", "ridge_point", "roofline_terms"]
