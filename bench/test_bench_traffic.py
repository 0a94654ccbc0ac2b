"""The traffic generator: the same sizes for every seed (a low-discrepancy
sequence over each law), seeded tokens, documents asked at interleaved
places, and the warm start of a loop in its steady state."""

import json
import numpy as np
import pytest

from bench.harness import cell, traffic

BIG_SEED = 2 ** 31 + 12345


def _mix(name):
    return json.loads((cell.BENCH / "traffic" / f"{name}.json").read_text())


def _gen(name, seed):
    mix = _mix(name)
    return traffic.make(mix, seed, 151936, mix["serve"]["prefill_chunk"], 16)


@pytest.mark.parametrize("name", ["long-decode", "doc-repeat", "doc-unique"])
def test_the_same_sizes_for_every_seed_other_tokens(name):
    a, b = _gen(name, 1), _gen(name, BIG_SEED)
    n = 128
    for q in range(n):
        ea, eb = a.entry(q), b.entry(q)
        assert (len(ea.prompt), ea.max_new) == (len(eb.prompt), eb.max_new)
    assert not np.array_equal(a.entry(0).prompt, b.entry(0).prompt)
    # along the queue the sizes spread over the law: its deciles are
    # within 12% of the law's own
    mix = _mix(name)
    outs = [a.entry(q).max_new for q in range(n)]
    want = [traffic.law_value(mix["output"], u / 10) for u in range(1, 10)]
    assert np.all(np.abs(np.percentile(outs, range(10, 100, 10)) - want)
                  <= 0.12 * np.asarray(want))
    again = _gen(name, BIG_SEED)
    assert all(np.array_equal(again.entry(q).prompt, b.entry(q).prompt)
               for q in range(8))
    # the first requests: the same sizes in the same order, other tokens,
    # with long and short ones interleaved
    ia, ib = a.initial(), b.initial()
    assert [(len(r.prompt), r.max_new) for r in ia] \
        == [(len(r.prompt), r.max_new) for r in ib]
    assert not np.array_equal(ia[0].prompt, ib[0].prompt)
    lives = [len(r.prompt) + r.max_new for r in ia]
    assert lives != sorted(lives)


def test_laws_respect_their_clips():
    mix = _mix("long-decode")
    g = _gen("long-decode", 3)
    outs = [g.entry(q).max_new for q in range(256)]
    assert min(outs) >= mix["output"]["min"] and \
        max(outs) <= mix["output"]["max"]
    assert abs(np.median(outs) - mix["output"]["median"]) < 80


def test_documents_are_asked_at_interleaved_places():
    g = _gen("doc-repeat", 5)
    asks = {}
    for q in range(400):
        m, k = g.ask(q)
        asks.setdefault(m, []).append((q, k))
    full = [v for m, v in asks.items() if m >= 0 and len(v) == 4]
    assert len(full) > 50
    for v in full:
        places = [q for q, _ in v]
        assert [k for _, k in v] == [0, 1, 2, 3]
        assert np.all(np.diff(places) == 17)
    e0, e1 = g.entry(0), g.entry(17 * 1 + 0)
    m0, m1 = g.ask(0)[0], g.ask(17)[0]
    if m0 == m1:
        assert np.array_equal(e0.prompt[:-64][:100], e1.prompt[:100])


def test_unique_documents_are_never_asked_twice():
    g = _gen("doc-unique", 5)
    docs = [g.ask(q)[0] for q in range(300)]
    assert len(set(docs)) == 300
    assert g.warm_prompts()  # the first requests' prefixes only
    assert len(g.warm_prompts()) <= g.clients


def test_warm_start_is_a_steady_state():
    g = _gen("long-decode", BIG_SEED)
    first = g.initial()
    assert len(first) == g.clients and all(r.resumed for r in first)
    # length-biased, aged: residual outputs average below fresh ones
    fresh = np.mean([g.entry(q).max_new for q in range(256)])
    assert np.mean([r.max_new for r in first]) < fresh
    warm = g.warm_prompts()
    assert all(len(w) % 16 == 0 for w in warm)
    for r, w in zip(g._initial, warm):
        assert np.array_equal(r[0].prompt[:len(w)], w)


def test_repeat_warms_the_documents_asked_again():
    g = _gen("doc-repeat", 9)
    warm = {tuple(w[:32]) for w in g.warm_prompts()}
    for q in range(3 * 17):
        m, k = g.ask(q)
        if m < 0:
            assert tuple(g.entry(q).prompt[:32]) in warm
