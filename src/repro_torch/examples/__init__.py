"""The repository's examples on the port, one module for each script of
``examples/`` and under the same name. Each runs on the card unless asked
for the CPU:

    PYTHONPATH=src python -m repro_torch.examples.<name> [--device cpu]

Each module has ``main(argv=None)``, which returns what it printed as a
dict, and keeps its work in functions that take ``(cfg, params, device)``
so that a caller can give it other weights."""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device

EXAMPLES = ("relu_llama_e2e", "quickstart", "sparse_serving",
            "streaming_serve", "spec_decode", "sharded_serve",
            "disagg_serve", "fleet_serve", "profile_serve",
            "multipod_dryrun_demo")


def resolve(device) -> torch.device:
    """``device`` as ``resolve_device`` gives it, a card with its index
    (``cuda`` is the current card: ``cuda:0`` by default), so that a mesh
    of its shards is ``[resolve(device)] * n``."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def device_name(device) -> str:
    """The name a measurement is labelled with: the card's, or "CPU"."""
    dev = resolve_device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "CPU"


def seeded(device, seed: int) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (for Model.init)."""
    return torch.Generator(device=resolve_device(device)).manual_seed(seed)


def sync(device) -> None:
    """Wait for the card, where ``device`` is one (before reading a
    host clock)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
