"""The port's refcounted block pool, radix prefix cache and the paged
engine's prefix branches, on the CPU, against the JAX reference.

The host structures are integer state: the same operations through both
packages' ``PagedKVCache`` and ``RadixPrefixCache`` must leave equal
tables, refcounts, free lists, index contents and ``stats()``. The engine
runs on the reference's weights (``init_params(PRNGKey(0))`` carried over
by ``from_jax_params``) and seeded prompts that share a system prompt;
greedy tokens must be identical to the reference's, and to the port's
own run with the cache off.
"""

from collections import Counter

import jax
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # property tests are skipped on clean environments
    from conftest import given, settings, st  # no-op stand-ins

from repro.configs import get_config
from repro.configs.base import ServeConfig as JaxServeConfig
from repro.models import Model as JaxModel
from repro.serve import paged_kv as jax_paged_kv
from repro.serve.engine import Engine as JaxEngine
from repro.serve.prefix_cache import RadixPrefixCache as JaxRadix
from repro.serve.scheduler import Request as JaxRequest
from repro_torch.configs import get_config as torch_get_config
from repro_torch.configs.base import ServeConfig
from repro_torch.serve import paged_kv
from repro_torch.serve.engine import Engine
from repro_torch.serve.prefix_cache import RadixPrefixCache
from repro_torch.serve.scheduler import Request
from repro_torch.weights import from_jax_params


@pytest.fixture(scope="module")
def nectar():
    cfg = get_config("nectar-relu-llama-1.7m")
    jparams = JaxModel(cfg).init(jax.random.PRNGKey(0))
    tcfg = torch_get_config(cfg.name)
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return cfg, jparams, tcfg, tparams


def _prompts(cfg, lengths, seed=0, shared=0):
    """Seeded prompts; the first ``shared`` tokens are common to all."""
    rng = np.random.default_rng(seed)
    head = rng.integers(0, cfg.vocab, size=shared, dtype=np.int32)
    return [np.concatenate([head, rng.integers(0, cfg.vocab, size=int(n),
                                               dtype=np.int32)])
            for n in lengths]


def _pools(n_blocks=24, block_size=4, max_batch=6, mbs=8):
    """The same pool and index in both packages."""
    kw = dict(n_blocks=n_blocks, block_size=block_size, max_batch=max_batch,
              max_blocks_per_seq=mbs)
    jcfg = get_config("nectar-relu-llama-smoke")
    tcfg = torch_get_config("nectar-relu-llama-smoke")
    jpool = jax_paged_kv.PagedKVCache(jcfg, **kw)
    tpool = paged_kv.PagedKVCache(tcfg, **kw)
    return (jpool, JaxRadix(jpool)), (tpool, RadixPrefixCache(tpool))


def _check_refcounts(pool, radix):
    """pool.ref is the multiset of slot->block references; the free list
    is disjoint from every live or cached block."""
    cnt = Counter(b for blocks in pool.owned.values() for b in blocks)
    assert dict(cnt) == pool.ref
    assert len(set(pool.free)) == len(pool.free)
    assert not set(pool.free) & set(cnt)
    assert not set(pool.free) & set(radix.blocks())


def _assert_same_state(jax_side, torch_side):
    (jpool, jrad), (tpool, trad) = jax_side, torch_side
    assert tpool.owned == jpool.owned
    assert tpool.ref == jpool.ref
    assert tpool.free == jpool.free
    assert tpool.pinned == jpool.pinned
    np.testing.assert_array_equal(tpool.tables(), jpool.tables())
    assert tpool.stats() == jpool.stats()
    assert trad.stats() == jrad.stats()
    assert sorted(trad.blocks()) == sorted(jrad.blocks())
    assert {b: trad._by_block[b].key for b in trad.blocks()} \
        == {b: jrad._by_block[b].key for b in jrad.blocks()}
    _check_refcounts(tpool, trad)


OPS = ("admit", "allocate", "free", "cow", "insert", "defrag", "pin",
       "reclaim")


def _apply(op, args, side, slot_tokens):
    """One operation on one package's (pool, index); returns what it
    returned, for comparison."""
    pool, radix = side
    if op == "admit":
        slot, toks = args
        blocks, n = radix.match(toks)
        pool.share(slot, blocks)
        if pool.can_allocate(slot, len(toks)) \
                and pool.allocate(slot, len(toks)):
            slot_tokens[slot] = toks
            return n
        pool.free_slot(slot)            # rollback, exactly like admit()
        return -1
    if op == "allocate":
        slot, n = args
        return pool.allocate(slot, n)
    if op == "free":
        slot_tokens.pop(args, None)
        return pool.free_slot(args)
    if op == "cow":
        slot, start, n = args
        if pool.n_free < pool.blocks_for(n):
            return None
        return pool.cow_for_write(slot, start, n)
    if op == "insert":
        toks = slot_tokens[args]
        return radix.insert(toks, pool.owned[args][:len(toks) // 4])
    if op == "defrag":
        perm = pool.defrag()
        return None if perm is None else perm.tolist()
    if op == "pin":
        slot, on = args
        (pool.pin if on else pool.unpin)(slot)
        return None
    freed = radix.reclaim(args)         # LRU eviction, handed back to the
    pool.free.extend(freed)             # free list as the pool's own
    return freed                        # allocation path does


@settings(max_examples=25, deadline=None)
@given(st.integers(0, 2 ** 32 - 1))
def test_pool_and_index_match_reference_on_random_ops(seed):
    """Random interleavings of admission through the index (match, share,
    allocate or roll back), growth, free, copy-on-write, insert, pin,
    defrag and LRU reclaim give equal results and equal state after every
    operation; freeing everything returns every block."""
    rng = np.random.default_rng(seed)
    jside, tside = _pools()
    jslots, tslots = {}, {}
    universe = [rng.integers(0, 64, size=int(n), dtype=np.int32)
                for n in rng.integers(8, 30, size=5)]
    for _ in range(120):
        op = str(rng.choice(OPS))
        live = sorted(tslots)
        if op == "admit":
            free = [s for s in range(6) if s not in tslots]
            if not free:
                continue
            base = universe[rng.integers(len(universe))]
            toks = np.concatenate([base, rng.integers(
                0, 64, size=int(rng.integers(1, 6)), dtype=np.int32)])
            args = (free[0], toks.astype(np.int32))
        elif op in ("allocate", "cow", "insert", "pin") and not live:
            continue
        elif op == "allocate":
            slot = int(rng.choice(live))
            args = (slot, len(tslots[slot]) + int(rng.integers(0, 8)))
        elif op == "free":
            if not live:
                continue
            args = int(rng.choice(live))
        elif op == "cow":
            slot = int(rng.choice(live))
            n = len(tslots[slot])
            start = int(rng.integers(0, n))
            args = (slot, start, n - start)
        elif op == "insert":
            args = int(rng.choice(live))
        elif op == "pin":
            args = (int(rng.choice(live)), bool(rng.integers(2)))
        elif op == "reclaim":
            args = int(rng.integers(1, 4))
        else:
            args = None
        want = _apply(op, args, jside, jslots)
        got = _apply(op, args, tside, tslots)
        assert got == want, (op, args)
        _assert_same_state(jside, tside)
    for slot in list(tslots):
        for side, slots in ((jside, jslots), (tside, tslots)):
            _apply("free", slot, side, slots)
    _assert_same_state(jside, tside)
    pool, radix = tside
    assert pool.ref == {} and pool.owned == {}
    assert len(pool.free) + radix.n_reclaimable() == pool.n_blocks


def test_radix_walk_of_a_2000_block_chain_under_the_default_limit():
    """A cached sequence of 2,000 blocks under CPython's default recursion
    limit (1,000 frames): the reclaimable count walks the chain without a
    frame a block, with the reference's counts (its recursive walk run
    under a raised limit) whole, with a slot mapping its first 100 blocks,
    and after LRU reclaim, which evicts leaf-first from the chain's tail
    in both packages."""
    import sys
    n = 2000
    sides = _pools(n_blocks=n + 1, block_size=4, max_batch=2, mbs=n)
    toks = np.arange(4 * n, dtype=np.int32) % 64
    query = np.concatenate([toks[:400], [7]]).astype(np.int32)
    counts, evicted = [], []
    limit = sys.getrecursionlimit()
    try:
        for raised, (pool, radix) in ((True, sides[0]), (False, sides[1])):
            sys.setrecursionlimit(3 * n if raised else 1000)
            assert pool.allocate(0, 4 * n)
            chain = list(pool.owned[0])
            radix.insert(toks, chain)
            seen = [radix.n_reclaimable()]
            pool.free_slot(0)
            seen.append(radix.n_reclaimable())
            blocks, m = radix.match(query)
            assert m == 400 and blocks == chain[:100]
            pool.share(1, blocks)
            seen.append(radix.n_reclaimable())
            freed = radix.reclaim(3)
            assert freed == chain[:-4:-1]
            seen.append(radix.n_reclaimable())
            counts.append(seen)
            evicted.append(freed)
    finally:
        sys.setrecursionlimit(limit)
    assert counts[1] == counts[0] == [0, n, n - 100, n - 103]
    assert evicted[1] == evicted[0]


def test_defrag_remaps_index_and_shared_blocks():
    """Defrag with an active sharer and cached reclaimable blocks: tables,
    refcounts and the radix follow the permutation in both packages, and
    a match after defrag returns the moved ids."""
    sides = _pools(n_blocks=12, block_size=4, max_batch=3)
    toks = np.arange(200, 212, dtype=np.int32)
    perms, moved = [], []
    for pool, radix in sides:
        assert pool.allocate(0, 4)          # filler, freed (makes holes)
        assert pool.allocate(1, 12)
        radix.insert(toks, list(pool.owned[1]))
        blocks, n = radix.match(np.concatenate([toks, [7]]))
        assert n == 12
        pool.share(2, blocks)
        pool.free_slot(0)
        pool.free_slot(1)
        perm = pool.defrag()
        perms.append(perm.tolist())
        again, n = radix.match(np.concatenate([toks, [7]]))
        assert n == 12 and again == pool.owned[2] == [0, 1, 2]
        moved.append(again)
    assert perms[0] == perms[1]
    _assert_same_state(*sides)


# ---------------------------------------------------------------------------
# the engine


def _serve_reference(cfg, params, prompts, max_new=8, **kw):
    base = dict(max_batch=2, max_seq=96, paged=True, block_size=8,
                prefill_chunk=16)
    eng = JaxEngine(cfg, params, JaxServeConfig(**dict(base, **kw)))
    done = eng.run([JaxRequest(rid=i, prompt=p, max_new=max_new)
                    for i, p in enumerate(prompts)], max_steps=2000)
    return {i: [int(t) for t in r.tokens_out] for i, r in done.items()}, eng


def _serve_port(cfg, params, prompts, max_new=8, **kw):
    base = dict(max_batch=2, max_seq=96, paged=True, block_size=8,
                prefill_chunk=16)
    eng = Engine(cfg, params, ServeConfig(**dict(base, **kw)), device="cpu")
    done = eng.run([Request(rid=i, prompt=p, max_new=max_new)
                    for i, p in enumerate(prompts)], max_steps=2000)
    return {i: [int(t) for t in r.tokens_out] for i, r in done.items()}, eng


def test_prefix_cache_on_off_and_reference_token_identical(nectar):
    """Four requests share a 40-token system prompt, one does not: the
    port with the cache on gives the tokens of the port with it off and of
    the reference with it on, with the same lookups, hits and cached
    tokens, fewer prompt tokens through the model, and every reference
    released at the end."""
    cfg, jparams, tcfg, tparams = nectar
    prompts = _prompts(cfg, [5, 9, 7, 11], seed=1, shared=40) \
        + _prompts(cfg, [12], seed=2)
    want, jeng = _serve_reference(cfg, jparams, prompts, prefix_cache=True)
    off, eoff = _serve_port(tcfg, tparams, prompts)
    on, eng = _serve_port(tcfg, tparams, prompts, prefix_cache=True)
    assert on == off == want
    s, js = eng.metrics.summary(), jeng.metrics.summary()
    for key in ("prefix_lookups", "prefix_hits", "prefix_cached_tokens",
                "prefill_chunks", "decode_steps", "kv_pool",
                "prefix_index"):
        assert s[key] == js[key], key
    assert s["prefix_hits"] >= 2 and s["kv_pool"]["cow"] == 0
    assert eng.metrics.prefill_tokens \
        == eoff.metrics.prefill_tokens - s["prefix_cached_tokens"]
    assert eng.pool.ref == {} and eng.pool.owned == {}
    assert eng.pool.n_free == eng.pool.n_blocks
    _check_refcounts(eng.pool, eng.prefix)


def test_prefix_cache_survives_preemption(nectar):
    """A tight pool forces evictions; replay re-matches the victim's own
    cached prompt blocks. Tokens equal the unconstrained run's and the
    reference's, with the same evictions and hits."""
    cfg, jparams, tcfg, tparams = nectar
    prompts = _prompts(cfg, [4, 6], seed=5, shared=8)
    kw = dict(max_new=16, max_seq=64, block_size=4, prefill_chunk=8)
    free, _ = _serve_port(tcfg, tparams, prompts, **kw)
    want, jeng = _serve_reference(cfg, jparams, prompts, prefix_cache=True,
                                  n_kv_blocks=10, **kw)
    tight, eng = _serve_port(tcfg, tparams, prompts, prefix_cache=True,
                             n_kv_blocks=10, **kw)
    assert eng.metrics.evictions > 0
    assert tight == free == want
    assert eng.metrics.evictions == jeng.metrics.evictions
    assert eng.metrics.prefix_hits == jeng.metrics.prefix_hits
    assert eng.pool.ref == {} and eng.pool.n_free == eng.pool.n_blocks


def test_engine_cow_on_shared_partial_tail(nectar):
    """A running request whose partial tail block gains a sibling reader
    copy-on-writes its next decode write: tokens equal the unshared run's
    and the reference's under the same share, the shared block's bytes
    stay frozen on every layer, and refcounts drain exactly."""
    cfg, jparams, tcfg, tparams = nectar
    prompt = _prompts(cfg, [10], seed=3)[0]
    kw = dict(max_batch=2, max_seq=64, paged=True, block_size=8,
              prefill_chunk=16, prefix_cache=True)

    def run(make, force_share):
        eng = make()
        eng.add_request((JaxRequest if isinstance(eng, JaxEngine)
                         else Request)(rid=0, prompt=prompt, max_new=10))
        for _ in range(3):
            eng.step()
        frozen = None
        if force_share:
            e = next(iter(eng.sched.active.values()))
            assert e.ctx_len % 8 != 0           # mid-block frontier
            b = eng.pool.owned[e.slot][e.ctx_len // 8]
            eng.pool.share(1, [b])              # a "sibling" reader
            if isinstance(eng, Engine):
                leaves = eng.runner.cache["units"]["b0"]
                frozen = (b, {k: v[:, b].clone() for k, v in leaves.items()})
        while eng._busy():
            eng.step()
        toks = [int(t) for t in eng._requests[0].tokens_out]
        if force_share:
            assert eng.pool.cow_count >= 1
            if frozen is not None:
                b, before = frozen
                for k, v in eng.runner.cache["units"]["b0"].items():
                    assert np.array_equal(before[k].numpy(),
                                          v[:, b].numpy()), k
            eng.pool.free_slot(1)
            _check_refcounts(eng.pool, eng.prefix)
        return toks, eng.pool.cow_count

    def port():
        return Engine(tcfg, tparams, ServeConfig(**kw), device="cpu")

    def reference():
        return JaxEngine(cfg, jparams, JaxServeConfig(**kw))

    plain, _ = run(port, False)
    shared, cows = run(port, True)
    want, jcows = run(reference, True)
    assert plain == shared == want
    assert cows == jcows


def test_engine_defrag_moves_the_device_pools(nectar):
    """Engine.defrag mid-serve: the host permutation equals the
    reference's, every pool leaf's rows move with it, and the tokens stay
    identical to the reference's run with the same defrag."""
    cfg, jparams, tcfg, tparams = nectar
    prompts = _prompts(cfg, [3, 20, 6], seed=7, shared=16)
    kw = dict(max_batch=2, max_seq=96, paged=True, block_size=8,
              prefill_chunk=16, prefix_cache=True)
    jeng = JaxEngine(cfg, jparams, JaxServeConfig(**kw))
    eng = Engine(tcfg, tparams, ServeConfig(**kw), device="cpu")
    for e, R in ((jeng, JaxRequest), (eng, Request)):
        for i, p in enumerate(prompts):
            e.add_request(R(rid=i, prompt=p, max_new=4 + 6 * (i != 0)))
    perms = []
    for tick in range(200):
        if not (eng._busy() or jeng._busy()):
            break
        if tick == 8:
            before = {k: v.clone()
                      for k, v in eng.runner.cache["units"]["b0"].items()}
            perm, jperm = eng.defrag(), jeng.defrag()
            assert perm is not None and jperm is not None
            assert perm.tolist() == jperm.tolist()
            idx = torch.as_tensor(perm, dtype=torch.long)
            for k, v in eng.runner.cache["units"]["b0"].items():
                assert torch.equal(v, before[k][:, idx]), k
            perms.append(perm)
        eng.step()
        jeng.step()
    assert perms
    for rid in range(len(prompts)):
        assert eng._requests[rid].tokens_out \
            == [int(t) for t in jeng._requests[rid].tokens_out]
    _check_refcounts(eng.pool, eng.prefix)


def test_prefix_cache_rejected_off_paged(nectar):
    """As in the reference, the slot engine refuses the prefix cache."""
    _, _, tcfg, tparams = nectar
    with pytest.raises(ValueError, match="prefix_cache"):
        Engine(tcfg, tparams, ServeConfig(paged=False, prefix_cache=True),
               device="cpu")
