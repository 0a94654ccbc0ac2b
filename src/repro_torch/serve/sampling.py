"""Per-request sampling: ``SamplingParams``, the batched sampler and the
numpy mirrors of one row.

  * ``SamplingParams`` — temperature / top-k / top-p / repetition penalty /
    stop sequences / max_tokens / logprobs / prompt_logprobs / seed,
    attached to every ``Request``.
  * ``Sampler`` — one batched call samples every row of a step on the
    logits' device. Ticks whose rows are all greedy with no penalty take
    a plain argmax; otherwise ``sample_batch`` applies the penalty,
    temperature, top-k and top-p per row and draws as the reference's
    ``jax.random.categorical`` does (threefry Gumbel-max, ``serve.prng``)
    from the per-request key ``request_key(seed, rid, counter)``, so a
    seeded stream matches the reference token for token.
  * numpy mirrors (``softmax``, ``token_logprob``, ``categorical_np``,
    ``filter_logits_np``, ``sample_np``) — the host side of one row, as
    the slot engine draws its first token.

Stop sequences are host-side: ``stop_truncate`` is the one matcher.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.serve import prng


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """How one request turns logits into tokens (the reference's
    contract). ``temperature=None`` means unset (greedy unless the engine
    provides a default); ``top_k=0`` and ``top_p=1.0`` disable their
    filters; ``stop`` is a tuple of token-id sequences and generation
    truncates before a match; ``max_tokens`` caps the generated length;
    ``logprobs`` asks for the chosen token's log-probability per step;
    ``prompt_logprobs`` fills, for every prompt position i >= 1, log
    p(prompt[i] | prompt[:i]) (paged engine only; such a request never
    consults the prefix cache); ``seed`` makes the request's sample stream
    independent of batch composition."""

    temperature: Optional[float] = None
    top_k: int = 0
    top_p: float = 1.0
    repetition_penalty: float = 1.0
    stop: Tuple[Tuple[int, ...], ...] = ()
    max_tokens: Optional[int] = None
    logprobs: bool = False
    prompt_logprobs: bool = False
    seed: Optional[int] = None

    def __post_init__(self):
        if self.temperature is not None and self.temperature < 0:
            object.__setattr__(self, "temperature", 0.0)
        if not (0.0 < self.top_p <= 1.0):
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if self.repetition_penalty <= 0:
            raise ValueError("repetition_penalty must be > 0, got "
                             f"{self.repetition_penalty}")
        if self.max_tokens is not None and self.max_tokens < 1:
            raise ValueError(f"max_tokens must be >= 1, got {self.max_tokens}")
        stop = tuple(tuple(int(t) for t in s) for s in self.stop)
        if any(len(s) == 0 for s in stop):
            raise ValueError("empty stop sequence")
        object.__setattr__(self, "stop", stop)

    @property
    def is_greedy(self) -> bool:
        return (self.temperature or 0.0) <= 0


GREEDY = SamplingParams()


def effective_params(sp: SamplingParams,
                     fallback_temperature: float = 0.0) -> SamplingParams:
    """Resolve a request's params to a concrete temperature: unset (None)
    inherits the engine default; an explicit value always wins."""
    t = sp.temperature
    if t is None:
        t = fallback_temperature if fallback_temperature > 0 else 0.0
    return dataclasses.replace(sp, temperature=float(t))


def request_key(seed: Optional[int], rid: int, counter: int) -> np.ndarray:
    """Deterministic uint32[2] PRNG key for one sample draw of one request.

    Derived from (seed, rid, draw counter) so a request's sample stream
    does not depend on which other requests share its batch — the
    per-request reproducibility contract of ``SamplingParams.seed``."""
    ss = np.random.SeedSequence(entropy=0 if seed is None else seed,
                                spawn_key=(rid & 0xFFFFFFFF, counter))
    return ss.generate_state(2, np.uint32)


def stop_truncate(tokens: Sequence[int],
                  stop: Tuple[Tuple[int, ...], ...]) -> Optional[int]:
    """If ``tokens`` ends with any stop sequence, return the length to
    truncate to (match excluded); else None."""
    n = len(tokens)
    for seq in stop:
        m = len(seq)
        if m and n >= m and tuple(int(t) for t in tokens[n - m:]) == seq:
            return n - m
    return None


def stop_holdback(tokens: Sequence[int],
                  stop: Tuple[Tuple[int, ...], ...]) -> int:
    """How many trailing tokens might still be retracted: the longest
    suffix of ``tokens`` that is a PROPER prefix of a stop sequence."""
    best = 0
    n = len(tokens)
    for seq in stop:
        for m in range(min(len(seq) - 1, n), 0, -1):
            if tuple(int(t) for t in tokens[n - m:]) == seq[:m]:
                best = max(best, m)
                break
    return best


# ---------------------------------------------------------------------------
# The batched filter->sample math (the reference's law, row by row):
#   1. repetition penalty on seen token ids (positive logits divide by the
#      penalty, negative multiply),
#   2. temperature scale,
#   3. top-k mask, then top-p (nucleus) mask over the surviving softmax,
#   4. categorical draw; greedy rows take a plain argmax.
# Every division is by a tensor, never by a Python number: PyTorch's CUDA
# kernels turn a division by a scalar into a product with its reciprocal,
# which can differ from the CPU's quotient in the last bit.


def filter_batch(logits: torch.Tensor, presence: torch.Tensor,
                 temp: torch.Tensor, top_k: torch.Tensor,
                 top_p: torch.Tensor, rep: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Steps 1-3 for every row: (the penalized logits f32[B, V], which
    greedy rows take the argmax of; the filtered, temperature-scaled
    logits f32[B, V] with masked entries at -inf, which sampled rows
    draw from)."""
    logits = logits.float()
    V = logits.shape[-1]
    pen = torch.where(logits > 0, logits / rep[:, None],
                      logits * rep[:, None])
    logits = torch.where(presence, pen, logits)
    scaled = logits / torch.clamp(temp, min=1e-6)[:, None]
    srt = torch.sort(scaled, dim=-1, descending=True).values
    kth = torch.gather(srt, 1, (top_k.long() - 1).clamp(0, V - 1)[:, None])
    keep_k = (top_k[:, None] <= 0) | (scaled >= kth)
    masked = torch.where(keep_k, scaled, -torch.inf)
    probs = torch.softmax(masked, dim=-1)
    ps = torch.sort(probs, dim=-1, descending=True).values
    csum = torch.cumsum(ps, dim=-1)
    # nucleus: the smallest prefix with mass >= top_p; the cutoff is the
    # smallest sorted prob whose PRECEDING mass is still < top_p
    keep_sorted = (csum - ps) < top_p[:, None]
    thresh = torch.where(keep_sorted, ps, torch.inf).min(dim=-1).values
    return logits, torch.where(probs >= thresh[:, None], masked, -torch.inf)


def sample_batch(logits: torch.Tensor, presence: torch.Tensor,
                 temp: torch.Tensor, top_k: torch.Tensor,
                 top_p: torch.Tensor, rep: torch.Tensor,
                 keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits f[B, V]; presence bool[B, V] (token ids already in the
    stream); temp/top_p/rep f32[B]; top_k i32[B]; keys int64[B, 2] (the
    uint32 words of ``request_key``). All on the logits' device. Returns
    (tokens int64[B], log-probability of each chosen token f32[B])."""
    logits, final = filter_batch(logits, presence, temp, top_k, top_p, rep)
    greedy = torch.argmax(logits, dim=-1)
    sampled = prng.categorical(keys, final)
    tok = torch.where(temp > 0, sampled, greedy)
    lp = torch.log_softmax(logits, dim=-1)
    return tok, torch.gather(lp, 1, tok[:, None])[:, 0]


def greedy_batch(logits: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits f[B, V] -> (argmax int64[B], its log-probability f32[B])."""
    logits = logits.float()
    tok = torch.argmax(logits, dim=-1)
    lp = torch.log_softmax(logits, dim=-1)
    return tok, torch.gather(lp, 1, tok[:, None])[:, 0]


class Sampler:
    """Batched sampler: one call per engine tick, on the logits' device,
    then one device->host copy of the result. Ticks where every row is
    greedy with no penalty (the serving steady state) skip the filters: a
    plain argmax, as in the reference."""

    def device_call(self, logits: torch.Tensor, presence: torch.Tensor,
                    temp: torch.Tensor, top_k: torch.Tensor,
                    top_p: torch.Tensor, rep: torch.Tensor,
                    keys: torch.Tensor, greedy_only: bool
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The async engine's sampler: (tokens int64[B], log-probabilities
        f32[B]) as tensors on the logits' device, with no host sync, so
        the next dispatch can chain on them. The per-row inputs are
        tensors on that device (``sample_batch``'s); ``greedy_only`` is
        decided on the host from the requests' SamplingParams, never from
        device values."""
        if greedy_only:
            return greedy_batch(logits)
        return sample_batch(logits, presence, temp, top_k, top_p, rep, keys)

    def launch(self, logits: torch.Tensor, presence: np.ndarray,
               temp: np.ndarray, top_k: np.ndarray, top_p: np.ndarray,
               rep: np.ndarray, keys: np.ndarray
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The tick's sample from host arrays: (tokens int32[B],
        log-probabilities f32[B]) on the logits' device, not yet waited
        for."""
        dev = logits.device
        greedy_only = not np.any(temp > 0) and np.all(rep == 1.0)
        t = (lambda a: None) if greedy_only \
            else (lambda a: torch.from_numpy(a).to(dev))
        tok, lp = self.device_call(
            logits, t(presence), t(temp), t(top_k), t(top_p), t(rep),
            t(keys.astype(np.int64)), greedy_only=greedy_only)
        return tok.to(torch.int32), lp


# ---------------------------------------------------------------------------
# numpy mirrors (the slot engine's first token)


def softmax(logits: np.ndarray, temperature: float = 1.0) -> np.ndarray:
    """Temperature softmax in f64."""
    z = np.asarray(logits, np.float64) / max(temperature, 1e-6)
    z = z - z.max(axis=-1, keepdims=True)
    e = np.exp(z)
    return e / e.sum(axis=-1, keepdims=True)


def token_logprob(logits: np.ndarray, token: int) -> float:
    """log p(token) under softmax(logits) in f64 — the prompt-logprobs
    primitive (the raw model distribution: no temperature or filters)."""
    z = np.asarray(logits, np.float64)
    z = z - z.max()
    return float(z[int(token)] - np.log(np.exp(z).sum()))


def categorical_np(rng: np.random.Generator, p: np.ndarray) -> int:
    """One draw from a normalized distribution."""
    return int(rng.choice(len(p), p=p))


def _penalize_np(logits: np.ndarray, sp: SamplingParams,
                 seen: Sequence[int]) -> np.ndarray:
    z = np.asarray(logits, np.float64).copy()
    if sp.repetition_penalty != 1.0 and len(seen):
        ids = np.asarray(sorted(set(int(t) for t in seen)), np.int64)
        pos = z[ids] > 0
        z[ids[pos]] /= sp.repetition_penalty
        z[ids[~pos]] *= sp.repetition_penalty
    return z


def filter_logits_np(logits: np.ndarray, sp: SamplingParams,
                     seen: Sequence[int] = ()) -> np.ndarray:
    """One request's filters on one position's logits: repetition penalty
    over ``seen`` token ids, then top-k and top-p masks at the request
    temperature. Returns f64 logits with filtered entries at -inf."""
    z = _penalize_np(logits, sp, seen)
    t = sp.temperature or 0.0
    if t <= 0 or (sp.top_k <= 0 and sp.top_p >= 1.0):
        return z
    scaled = z / max(t, 1e-6)
    keep = np.ones(z.shape, bool)
    if sp.top_k > 0:
        kth = np.sort(scaled)[::-1][min(sp.top_k, len(scaled)) - 1]
        keep &= scaled >= kth
    if sp.top_p < 1.0:
        p = softmax(np.where(keep, scaled, -np.inf), 1.0)
        order = np.argsort(p)[::-1]
        csum = np.cumsum(p[order])
        kp = (csum - p[order]) < sp.top_p
        keep &= p >= p[order][kp].min()
    return np.where(keep, z, -np.inf)


def sample_np(logits: np.ndarray, sp: SamplingParams,
              rng: np.random.Generator,
              seen: Sequence[int] = ()) -> Tuple[int, float]:
    """Host sampling of one row (the slot engine's batch-1 prefill):
    (token, its log-probability under the penalized logits). Greedy is a
    plain argmax."""
    pen = _penalize_np(logits, sp, seen)
    lp_full = np.log(softmax(pen, 1.0))
    if sp.is_greedy:
        tok = int(np.argmax(pen))
        return tok, float(lp_full[tok])
    masked = filter_logits_np(logits, sp, seen)
    tok = categorical_np(rng, softmax(masked, sp.temperature))
    return tok, float(lp_full[tok])
