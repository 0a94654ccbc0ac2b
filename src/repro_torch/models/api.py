"""Public model API of the port: init / slot cache, prefill and decode /
paged cache and serving step."""

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

    def init_cache(self, batch: int, max_len: int,
                   dtype: torch.dtype = torch.float32,
                   device: Optional[Union[str, torch.device]] = None
                   ) -> dict:
        return transformer.init_cache(self.cfg, batch, max_len, dtype=dtype,
                                      device=device)

    def prefill(self, params: dict, tokens: torch.Tensor, cache: dict):
        """Process a prompt tokens i32[B, S], fill the cache, return the
        logits f32[B, 1, V] of the last position and the updated cache
        (the reference takes a batch dict {"tokens": ...})."""
        hidden, new_cache = transformer.forward(params, self.cfg, tokens,
                                                cache=cache)
        logits = transformer.project_logits(params, self.cfg,
                                            hidden[:, -1:])
        return logits, new_cache

    def decode_step(self, params: dict, tokens: torch.Tensor, cache: dict):
        """One token per row at cache["lens"]; returns (logits f32[B, 1,
        V], the cache with lens + 1)."""
        return transformer.decode_step(params, self.cfg, tokens, cache)

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
