"""Public model API of the port: init / loss / forward / slot cache,
prefill and decode / paged cache and serving step."""

from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer
from repro_torch.tree import leaves


class Model:
    """Functional facade over the decoder stack for one config."""

    def __init__(self, cfg: ModelConfig):
        transformer.check_supported(cfg)
        self.cfg = cfg

    def init(self, generator: torch.Generator,
             device: Optional[Union[str, torch.device]] = None) -> dict:
        return transformer.init_params(self.cfg, generator, device=device)

    def param_count(self, params: dict) -> int:
        """The number of parameters in ``params``, every leaf counted."""
        return sum(t.numel() for t in leaves(params))

    def loss(self, params: dict, batch: dict):
        """(loss, {"ce", "aux", "ppl"}) of a batch dict of tensors:
        ``tokens``, ``labels``, an optional ``mask`` and the frontend inputs
        ``forward`` takes (see transformer.loss_fn)."""
        return transformer.loss_fn(params, self.cfg, batch)

    def forward(self, params: dict, tokens: torch.Tensor,
                vision_embeds: Optional[torch.Tensor] = None,
                audio_embeds: Optional[torch.Tensor] = None,
                mrope_positions: Optional[torch.Tensor] = None):
        """Logits of every position of tokens i32[B, S] (a codebook
        model's [B, S, nc]) and the aux loss: (f32[B, S, V] or
        [B, S, nc, V], f32[]). The optional inputs are those of the
        reference's batch dict: the frontend stubs' embeddings [B, S', d]
        added to the first S' positions, and M-RoPE positions [3, B, S]."""
        hidden, aux, _ = transformer.forward(
            params, self.cfg, tokens, vision_embeds=vision_embeds,
            audio_embeds=audio_embeds, mrope_positions=mrope_positions)
        return transformer.project_logits(params, self.cfg, hidden), aux

    def init_cache(self, batch: int, max_len: int,
                   dtype: torch.dtype = torch.float32,
                   device: Optional[Union[str, torch.device]] = None
                   ) -> dict:
        return transformer.init_cache(self.cfg, batch, max_len, dtype=dtype,
                                      device=device)

    def check_prompt_len(self, S: int) -> None:
        """Raise ValueError for a prompt length the prefill refuses."""
        transformer.check_prompt_len(self.cfg, S)

    def merge_slot(self, cache: dict, tmp: dict, slot: int,
                   prompt_len: int) -> None:
        """Write a batch-1 prefill cache into row ``slot`` of a slot cache,
        in place (see transformer.merge_slot)."""
        transformer.merge_slot(self.cfg, cache, tmp, slot, prompt_len)

    def prefill(self, params: dict, tokens: torch.Tensor, cache: dict,
                vision_embeds: Optional[torch.Tensor] = None,
                audio_embeds: Optional[torch.Tensor] = None,
                mrope_positions: Optional[torch.Tensor] = None):
        """Process a prompt tokens i32[B, S] ([B, S, nc] for codebooks),
        fill the cache, return the logits f32[B, 1, V] ([B, 1, nc, V]) of
        the last position and the updated cache (the reference takes a
        batch dict {"tokens": ...} with the same optional inputs as
        ``forward``)."""
        hidden, _, new_cache = transformer.forward(
            params, self.cfg, tokens, cache=cache,
            vision_embeds=vision_embeds, audio_embeds=audio_embeds,
            mrope_positions=mrope_positions)
        logits = transformer.project_logits(params, self.cfg,
                                            hidden[:, -1:])
        return logits, new_cache

    def decode_step(self, params: dict, tokens: torch.Tensor, cache: dict,
                    vision_embeds: Optional[torch.Tensor] = None,
                    audio_embeds: Optional[torch.Tensor] = None):
        """One token per row at cache["lens"]; returns (logits f32[B, 1,
        V] or [B, 1, nc, V], the cache with lens + 1). The optional inputs
        are those of the reference's ``batch_extra``: the stubs'
        embeddings, added to the token's. The position is cache["lens"]
        on every M-RoPE channel: the reference's decode step reads no
        ``mrope_positions`` from its batch_extra either."""
        return transformer.decode_step(params, self.cfg, tokens, cache,
                                       vision_embeds=vision_embeds,
                                       audio_embeds=audio_embeds)

    def init_paged_cache(self, batch: int, n_blocks: int, block_size: int,
                         max_blocks_per_seq: int,
                         dtype: torch.dtype = torch.float32,
                         device: Optional[Union[str, torch.device]] = None,
                         int8_kv: bool = False,
                         max_width: Optional[int] = None,
                         kv_heads: Optional[int] = None) -> dict:
        return transformer.init_paged_cache(self.cfg, batch, n_blocks,
                                            block_size, max_blocks_per_seq,
                                            dtype=dtype, device=device,
                                            int8_kv=int8_kv,
                                            max_width=max_width,
                                            kv_heads=kv_heads)

    def forward_step(self, params, tokens, cache, n_valid, is_prefill,
                     block_size: int, backend: str = "naive",
                     has_prefill: bool = True) -> torch.Tensor:
        """One batched step serving prefill, decode and verify rows
        together (see transformer.forward_step)."""
        return transformer.forward_step(params, self.cfg, tokens, cache,
                                        n_valid, is_prefill, block_size,
                                        backend=backend,
                                        has_prefill=has_prefill)

    def decode_burst(self, params, cache, tables, tok0, lens0, alive0,
                     budget, stops, stop_len, hist0, sample_fn,
                     block_size: int, backend: str, k_ticks: int,
                     k_max: int):
        """The async engine's device-resident decode loop: k_ticks
        width-1 steps with the sample fed back on the device and per-row
        early exit (see transformer.decode_burst)."""
        return transformer.decode_burst(params, self.cfg, cache, tables,
                                        tok0, lens0, alive0, budget, stops,
                                        stop_len, hist0, sample_fn,
                                        block_size, backend, k_ticks, k_max)
