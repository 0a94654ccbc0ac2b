"""The port's device policy: CUDA unless the caller asks for the CPU."""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

# one device, or under a mesh (launch.mesh) a sequence of them, one a shard
Devices = Union[None, str, torch.device, Sequence[Union[str, torch.device]]]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means CUDA. A CUDA device without a card raises: the port
    never moves to the CPU by itself, the caller must pass
    ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device=\"cpu\" to run the "
            "port on the CPU (plain PyTorch versions of the kernels)")
    return dev
