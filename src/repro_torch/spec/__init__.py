"""Speculative decoding on the paged engine (repro_torch.spec).

The decode step is memory-bound: every emitted token re-streams the
target's weights. A cheap drafter proposes K tokens, the target scores
all K+1 positions in ONE verify row of the batched step (through the
paged-attention and gather kernels), and an acceptance rule commits the
longest correct prefix, so one read of the weight stream serves up to K+1
tokens.

  * drafter.py    — the ``Drafter`` protocol; prompt-lookup n-gram
                    drafter and a small-model drafter on a contiguous cache
  * selfspec.py   — the target drafts for itself through a predictor-
                    gathered sparse FFN (core.sparsity.SparsityPredictor)
  * accept.py     — greedy acceptance and rejection sampling
  * controller.py — adaptive draft length K

The engine's side is ``serve.engine`` (``ServeConfig(spec=...)``); the
rollback is ``serve.paged_kv.PagedKVCache.truncate`` plus pin/unpin around
the verify step.
"""

from typing import Optional, Union

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig, ServeConfig, SpecConfig
from repro_torch.spec.accept import (filtered_accept, greedy_accept,
                                     rejection_accept)
from repro_torch.spec.controller import AdaptiveK
from repro_torch.spec.drafter import Drafter, ModelDrafter, NGramDrafter
from repro_torch.spec.selfspec import SelfSpecDrafter

__all__ = ["AdaptiveK", "Drafter", "ModelDrafter", "NGramDrafter",
           "SelfSpecDrafter", "SpecConfig", "filtered_accept",
           "greedy_accept", "make_drafter", "rejection_accept"]


def make_drafter(spec: SpecConfig, cfg: ModelConfig, params: dict,
                 scfg: ServeConfig, draft_params: Optional[dict] = None,
                 device: Optional[Union[str, torch.device]] = None
                 ) -> Drafter:
    """Build the drafter ``spec.drafter`` names for a target model, on
    ``device``. ``model`` needs ``draft_params`` (weights of the registry
    config ``spec.draft_name``, which shares the target's vocab);
    ``ngram`` and ``selfspec`` need nothing beyond the target."""
    if spec.drafter == "ngram":
        return NGramDrafter(n=spec.ngram)
    if spec.drafter == "selfspec":
        return SelfSpecDrafter(cfg, params, scfg.max_seq,
                               frac=spec.draft_frac,
                               rank=spec.predictor_rank,
                               temperature=spec.temperature, seed=spec.seed,
                               max_batch=scfg.max_batch, device=device)
    if spec.drafter == "model":
        if draft_params is None:
            raise ValueError(
                "spec.drafter='model' needs draft_params (weights for the "
                f"draft config {spec.draft_name!r})")
        dcfg = get_config(spec.draft_name)
        if dcfg.vocab != cfg.vocab:
            raise ValueError(
                f"draft model {dcfg.name} vocab {dcfg.vocab} != target "
                f"vocab {cfg.vocab}; drafter and target must share a "
                f"tokenizer")
        return ModelDrafter(dcfg, draft_params, scfg.max_seq,
                            temperature=spec.temperature, seed=spec.seed,
                            max_batch=scfg.max_batch, device=device)
    raise ValueError(f"unknown drafter {spec.drafter!r} "
                     f"(ngram | model | selfspec)")
