"""Public model API of the port: init / paged cache / serving step."""

from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


class Model:
    """Functional facade over the decoder stack for one config."""

    def __init__(self, cfg: ModelConfig):
        transformer.check_supported(cfg)
        self.cfg = cfg

    def init(self, generator: torch.Generator,
             device: Optional[Union[str, torch.device]] = None) -> dict:
        return transformer.init_params(self.cfg, generator, device=device)

    def init_paged_cache(self, batch: int, n_blocks: int, block_size: int,
                         max_blocks_per_seq: int,
                         dtype: torch.dtype = torch.float32,
                         device: Optional[Union[str, torch.device]] = None
                         ) -> dict:
        return transformer.init_paged_cache(self.cfg, batch, n_blocks,
                                            block_size, max_blocks_per_seq,
                                            dtype=dtype, device=device)

    def forward_step(self, params, tokens, cache, n_valid, is_prefill,
                     block_size: int, backend: str = "naive",
                     has_prefill: bool = True) -> torch.Tensor:
        """One batched step serving prefill, decode and verify rows
        together (see transformer.forward_step)."""
        return transformer.forward_step(params, self.cfg, tokens, cache,
                                        n_valid, is_prefill, block_size,
                                        backend=backend,
                                        has_prefill=has_prefill)
