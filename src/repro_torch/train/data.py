"""Synthetic TinyStories-style data pipeline (offline, deterministic,
seekable): the port's copy of ``repro.train.data``, plain numpy, whose
batches are bit-equal to the reference's.

The paper trains its 1.7M ReLU-Llama on TinyStories. The corpus here is
synthesized with the same statistical role, so nothing is downloaded: a
small-vocab token stream from a fixed-seed generator over a story-like
grammar (subject verb object ... punctuation), tokenized by a word-level
vocab. Batch i is a pure function of (seed, i), which is what resume
after preemption needs (the checkpoint stores the cursor).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np

_SUBJECTS = ["tom", "lily", "the dog", "the cat", "a bird", "mom", "dad",
             "the girl", "the boy", "grandma"]
_VERBS = ["saw", "liked", "found", "made", "took", "gave", "wanted",
          "played with", "looked at", "helped"]
_OBJECTS = ["a ball", "the tree", "a cookie", "the toy", "a flower",
            "the book", "a star", "the car", "a fish", "the hat"]
_CONN = ["then", "and", "but", "so", "one day", "after that"]
_END = ["it was fun .", "they were happy .", "the end .",
        "everyone smiled .", "it was a good day ."]


def build_vocab() -> dict:
    words = set()
    for pool in (_SUBJECTS, _VERBS, _OBJECTS, _CONN, _END):
        for phrase in pool:
            words.update(phrase.split())
    vocab = {"<pad>": 0, "<bos>": 1, "<eos>": 2}
    for w in sorted(words):
        vocab[w] = len(vocab)
    return vocab


VOCAB = build_vocab()
VOCAB_SIZE = len(VOCAB)


def synth_story(rng: np.random.Generator, min_sents=3, max_sents=8) -> str:
    sents = []
    for _ in range(rng.integers(min_sents, max_sents + 1)):
        s = rng.choice(_SUBJECTS)
        v = rng.choice(_VERBS)
        o = rng.choice(_OBJECTS)
        c = rng.choice(_CONN) if sents else ""
        sents.append(f"{c} {s} {v} {o} .".strip())
    sents.append(rng.choice(_END))
    return " ".join(sents)


def tokenize(text: str) -> np.ndarray:
    return np.array([VOCAB[w] for w in text.split() if w in VOCAB],
                    np.int32)


@dataclasses.dataclass
class DataConfig:
    seq_len: int = 128
    batch_size: int = 16
    seed: int = 1234
    vocab_size: int = VOCAB_SIZE


class TinyStoriesSynth:
    """Deterministic, seekable batch source."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch_at(self, index: int) -> dict:
        """Batch ``index`` (pure function of (seed, index))."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.cfg.seed, index]))
        B, S = self.cfg.batch_size, self.cfg.seq_len
        toks = np.zeros((B, S + 1), np.int32)
        for b in range(B):
            stream = [np.array([VOCAB["<bos>"]], np.int32)]
            n = 1
            while n < S + 1:
                t = tokenize(synth_story(rng))
                stream.append(t)
                stream.append(np.array([VOCAB["<eos>"]], np.int32))
                n += len(t) + 1
            cat = np.concatenate(stream)[:S + 1]
            toks[b] = cat
        return {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:],
            "mask": (toks[:, 1:] != VOCAB["<pad>"]).astype(np.float32),
        }

    def iterate(self, start: int = 0) -> Iterator[Tuple[int, dict]]:
        i = start
        while True:
            yield i, self.batch_at(i)
            i += 1


def resume_cursor(step: int, grad_accum: int = 1) -> int:
    """Data cursor for exact resume at ``step`` (microbatch-aware)."""
    return step * max(grad_accum, 1)
