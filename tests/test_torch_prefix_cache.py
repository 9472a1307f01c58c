"""PyTorch port, the radix prefix cache: paddle_tpu_torch.serving's
refcounted BlockAllocator, RadixPrefixCache and PagedKVCache held against
the reference's objects on the same operations, the suffix prefill
against the reference engine's at f32, and cache-on == cache-off inside
the port (the cases of tests/test_serving_prefix_cache.py).

Tolerances: the allocator and the trie are host bookkeeping, compared for
equality. Suffix prefill: the first token equal, the k/v written for a
hit within 1e-5 at f32 (the two frameworks sum in other orders). Inside
the port, cache-on and cache-off tokens are equal at f32 and bf16: every
prefill chunk has the same shapes, so a cached prefix carries the bits a
cold prefill computes.
"""
import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as fluid

from paddle_tpu_torch import serving as port
from paddle_tpu_torch.models import gpt_decode as port_decode
from paddle_tpu_torch.models.gpt import GPTConfig as PortGPTConfig
from paddle_tpu_torch.observability import metrics as port_metrics

GEO = dict(max_slots=3, block_size=8, num_blocks=32, max_len=32, window=4)


@pytest.fixture(scope="module")
def tiny():
    """(jax cfg, jax params, port cfg, port params on the CPU)."""
    from paddle_tpu.models.gpt import GPTConfig, build_lm_program
    from paddle_tpu.models import gpt_decode
    from paddle_tpu.testing import reset_programs
    reset_programs(seed=0)
    cfg = GPTConfig.tiny()
    cfg.max_position = 64
    build_lm_program(cfg)
    exe = fluid.Executor()
    exe.run(fluid.default_startup_program())
    params = gpt_decode.params_from_scope(cfg)
    port_cfg = PortGPTConfig(**{
        f.name: getattr(cfg, f.name)
        for f in dataclasses.fields(PortGPTConfig)})
    arrays = {n: np.asarray(a) for n, a in params.items()}
    return cfg, params, port_cfg, port_decode.params_from_numpy(
        port_cfg, arrays, device="cpu")


def _engine(tiny, dtype="float32", **kw):
    _, _, port_cfg, port_params = tiny
    return port.DecodeEngine(port_params, port_cfg, device="cpu",
                             dtype=dtype, **{**GEO, **kw})


def _tokens(eng, reqs):
    comps = eng.generate(reqs, timeout=240)
    assert all(c.ok for c in comps), [(c.uid, c.state, c.error)
                                      for c in comps]
    return {c.uid: c.tokens for c in comps}


def _shared_prefix_requests(vocab, n=6, seed=5, prefix_len=13):
    """n requests sharing one prefix_len-token system prompt (mid-block at
    block_size 8: the partial-tail copy-on-write path), divergent tails,
    greedy and seeded top-k alternating."""
    rng = np.random.RandomState(seed)
    sysp = rng.randint(0, vocab, (prefix_len,))
    reqs = []
    for i in range(n):
        tail = rng.randint(0, vocab, (2 + i % 3,))
        sampled = i % 2 == 1
        reqs.append(port.Request(
            prompt=np.concatenate([sysp, tail]), max_new_tokens=4 + i % 3,
            temperature=0.8 if sampled else 0.0, top_k=8 if sampled else 0,
            seed=50 + i, uid=f"p{i}"))
    return sysp, reqs


# ---------------------------------------------------------------------------
# allocator and radix cache: the port's objects == the reference's
# ---------------------------------------------------------------------------

def _state(alloc):
    return list(alloc._free), dict(alloc._refs), alloc.shared_blocks


def test_allocator_double_free_and_unknown_id_raise():
    from paddle_tpu.serving.cache import BlockAllocator as RefAllocator
    for cls in (RefAllocator, port.BlockAllocator):
        a = cls(8)
        got = a.alloc(2)
        a.free([got[0]])
        with pytest.raises(ValueError, match="double-free or unknown"):
            a.free([got[0]])
        with pytest.raises(ValueError, match="double-free or unknown"):
            a.free([99])
        with pytest.raises(ValueError, match="scratch"):
            a.free([0])
        a.free([got[1]])
        a.close()


def test_allocator_refcounts_match_reference():
    from paddle_tpu.serving.cache import BlockAllocator as RefAllocator
    ref, got = RefAllocator(8), port.BlockAllocator(8)
    for a in (ref, got):
        (b,) = a.alloc(1)
        a.share([b])
        assert a.refcount(b) == 2 and a.shared_blocks == 1
        free_before = a.free_blocks
        a.free([b])
        assert a.free_blocks == free_before and a.refcount(b) == 1
        a.free([b])
        assert a.free_blocks == free_before + 1
        with pytest.raises(ValueError, match="not live"):
            a.share([b])
    assert _state(ref) == _state(got)
    ref.close()
    got.close()


def test_random_operation_sequence_matches_reference():
    """400 seeded alloc / share / free / insert / lookup / evict operations
    through both packages' allocator + radix cache: equal chains, matched
    counts, refcounts and free lists after every operation."""
    from paddle_tpu.serving.cache import BlockAllocator as RefAllocator
    from paddle_tpu.serving.cache import RadixPrefixCache as RefRadix
    rng = np.random.RandomState(11)
    ra, pa = RefAllocator(40), port.BlockAllocator(40)
    rr, pr = RefRadix(4), port.RadixPrefixCache(4)
    held = []          # block lists this "slot side" owns one ref on
    vocab = [1, 2, 3]  # a tiny alphabet: prompts share prefixes often
    for step in range(400):
        op = rng.randint(6)
        if op == 0:
            n = int(rng.randint(1, 5))
            got_r, got_p = ra.alloc(n), pa.alloc(n)
            assert got_r == got_p
            if got_r is not None:
                held.append(got_r)
        elif op == 1 and held:
            blocks = held[rng.randint(len(held))]
            ra.share(blocks)
            pa.share(blocks)
            held.append(list(blocks))
        elif op == 2 and held:
            blocks = held.pop(rng.randint(len(held)))
            ra.free(blocks)
            pa.free(blocks)
        elif op == 3 and held:
            blocks = held[rng.randint(len(held))]
            plen = int(rng.randint(1, 4 * len(blocks) + 1))
            prompt = list(rng.choice(vocab, plen))
            rr.insert(prompt, blocks, ra)
            pr.insert(prompt, blocks, pa)
        elif op == 4:
            prompt = list(rng.choice(vocab, int(rng.randint(1, 14))))
            assert rr.lookup(prompt) == pr.lookup(prompt), step
        elif op == 5:
            need = int(rng.randint(1, 4))
            assert rr.evict(ra, need) == pr.evict(pa, need), step
        assert _state(ra) == _state(pa), step
        assert len(rr) == len(pr), step
    rr.clear(ra)
    pr.clear(pa)
    assert _state(ra) == _state(pa)
    for a in (ra, pa):
        a.close()


def test_release_unassigned_slot_raises_and_assign_with_prefix():
    cache = port.PagedKVCache(port.CacheConfig(
        num_layers=1, num_heads=1, head_dim=4, block_size=4, num_blocks=8,
        max_blocks_per_slot=6), torch.device("cpu"))
    with pytest.raises(KeyError):
        cache.release(0)
    a = cache.allocator
    chain = a.alloc(2)              # stands in for a cached chain
    got = cache.assign_with_prefix(1, chain, 2)
    assert got is not None and len(got) == 2
    assert cache.blocks_of(1) == chain + got
    assert all(a.refcount(b) == 2 for b in chain)
    with pytest.raises(ValueError, match="already holds"):
        cache.assign_with_prefix(1, chain, 1)
    # an unfundable private tail undoes the share (all-or-nothing)
    before = {b: a.refcount(b) for b in chain}
    assert cache.assign_with_prefix(2, chain, a.free_blocks + 1) is None
    assert {b: a.refcount(b) for b in chain} == before
    cache.release(1)
    assert all(a.refcount(b) == 1 for b in chain)
    with pytest.raises(KeyError):
        cache.release(1)
    a.free(chain)
    cache.close()


@pytest.mark.parametrize("case", ["lookup", "evict_lru"])
def test_radix_cases_match_reference(case):
    """The reference's radix unit cases, driven through both packages."""
    from paddle_tpu.serving.cache import BlockAllocator as RefAllocator
    from paddle_tpu.serving.cache import RadixPrefixCache as RefRadix
    seen = []
    for alloc_cls, radix_cls in ((RefAllocator, RefRadix),
                                 (port.BlockAllocator,
                                  port.RadixPrefixCache)):
        a, rc = alloc_cls(16), radix_cls(block_size=4)
        log = []
        if case == "lookup":
            prompt = list(range(10))    # 2 full chunks + a 2-token tail
            blocks = a.alloc(3)
            rc.insert(prompt, blocks, a)
            for q in (prompt, prompt + [77, 78], prompt[:8] + [99, 98],
                      [42] * 9):
                log.append(rc.lookup(q))
            rc.clear(a)
            a.free(blocks)
        else:
            b1, b2 = a.alloc(1), a.alloc(1)
            rc.insert([1, 2, 3, 4], b1, a)
            rc.insert([5, 6, 7, 8], b2, a)
            for b in (b1, b2):
                a.free(b)
            rc.lookup([1, 2, 3, 4, 9])   # touch the older chain -> MRU
            log.append(rc.evict(a, 1))
            log.append((a.refcount(b1[0]), a.refcount(b2[0])))
            a.share(b1)                  # pinned: never evicted
            log.append(rc.evict(a, 1))
            a.free(b1)
            log.append(rc.evict(a, 1))
            log.append(len(rc))
        log.append(_state(a))
        seen.append(log)
        a.close()
    assert seen[0] == seen[1]
    if case == "lookup":
        assert [m for _, m in seen[1][:4]] == [8, 10, 8, 0]
    else:
        assert seen[1][:2] == [1, (1, 0)]


# ---------------------------------------------------------------------------
# suffix prefill: the port's == the reference engine's at f32
# ---------------------------------------------------------------------------

def _chain_kv(pool, blocks, plen, bs):
    """[L, nh, plen, hd] of a chain's first plen positions, as numpy."""
    blocks = np.asarray(blocks)
    if isinstance(pool, torch.Tensor):
        g = pool[:, torch.as_tensor(blocks)].float().numpy()
    else:
        g = np.asarray(pool[:, blocks]).astype(np.float32)
    L, n, nh, _, hd = g.shape
    return g.transpose(0, 2, 1, 3, 4).reshape(L, nh, n * bs, hd)[:, :, :plen]


@pytest.mark.parametrize("prefix_len", [16, 13], ids=["full", "cow_tail"])
def test_suffix_prefill_matches_reference(tiny, prefix_len):
    """A publisher prompt, then a hit that extends it (full blocks only, or
    a partial tail block copied on write): the hit's first token equals
    the reference's, and the k/v written for its whole chain agree within
    1e-5; the publisher's shared blocks keep their bits."""
    from paddle_tpu.serving import DecodeEngine as RefEngine
    from paddle_tpu.serving import Request as RefRequest
    cfg, params = tiny[0], tiny[1]
    rng = np.random.RandomState(31)
    pub = rng.randint(0, cfg.vocab_size, (prefix_len,))
    hit = np.concatenate([pub, rng.randint(0, cfg.vocab_size, (6,))])
    results = []
    for make, req_cls in (
            (lambda: RefEngine(params, cfg, decode_kernel=False,
                               prefix_cache=True, **GEO), RefRequest),
            (lambda: _engine(tiny, prefix_cache=True),
             port.Request)):
        eng = make()
        try:
            assert eng.generate([req_cls(prompt=pub, max_new_tokens=1)],
                                timeout=240)[0].ok
            pub_chain, _ = eng.prefix_cache.lookup(
                np.concatenate([pub, [0]]))
            pub_kv = _chain_kv(eng.cache.k_pool, pub_chain, prefix_len, 8)
            c = eng.generate([req_cls(prompt=hit, max_new_tokens=1)],
                             timeout=240)[0]
            assert c.ok
            st = eng.stats()
            chain, matched = eng.prefix_cache.lookup(
                np.concatenate([hit, [0]]))
            assert matched == len(hit)
            kv = [_chain_kv(pool, chain, len(hit), 8)
                  for pool in (eng.cache.k_pool, eng.cache.v_pool)]
            pub_after = _chain_kv(eng.cache.k_pool, pub_chain, prefix_len,
                                  8)
        finally:
            eng.stop()
        assert st["prefix_cache_hits"] == 1
        assert st["prefill_tokens_saved"] == prefix_len
        np.testing.assert_array_equal(pub_after, pub_kv)
        results.append((c.tokens, kv))
    (ref_tok, ref_kv), (got_tok, got_kv) = results
    assert got_tok == ref_tok
    for r, g in zip(ref_kv, got_kv):
        np.testing.assert_allclose(g, r, atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# cache-on == cache-off inside the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("max_len", [32, 64], ids=["chunk8", "chunk16"])
def test_shared_prefix_parity_and_counters(tiny, dtype, max_len):
    """Warm cache, a concurrent shared-prefix mix (greedy + seeded top-k):
    cache-on tokens == cache-off; the hit counters and metrics move. At
    max_len 32 a prefill chunk is 8 rows (the hits skip a chunk), at 64
    it is 16 (the 13-token prefix lies inside the first chunk)."""
    cfg = tiny[0]
    sysp, reqs = _shared_prefix_requests(cfg.vocab_size)
    off = _engine(tiny, dtype, max_len=max_len)
    try:
        assert off.prefill_chunk == max_len // 4
        want = _tokens(off, reqs)
    finally:
        off.stop()
    for name in ("serving.prefix_cache.hits", "serving.prefix_cache.misses",
                 "serving.prefill_tokens_saved"):
        port_metrics.reset(name)
    on = _engine(tiny, dtype, prefix_cache=True, max_len=max_len)
    try:
        assert on.generate([reqs[0]], timeout=240)[0].ok
        got = _tokens(on, reqs)
        st = on.stats()
    finally:
        on.stop()
    assert got == want
    assert st["prefix_cache_hits"] >= len(reqs)
    assert st["prefill_tokens_saved"] >= 8 * len(reqs)
    assert st["prefix_cache_hit_rate"] > 0.5
    snap = port_metrics.snapshot()
    assert snap["serving.prefix_cache.hits"]["value"] \
        == st["prefix_cache_hits"]
    assert snap["serving.prefill_tokens_saved"]["value"] \
        == st["prefill_tokens_saved"]
    assert st["shared_blocks"] == 0      # every slot retired


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cow_isolation_divergent_tails(tiny, dtype):
    """Three requests diverging right after a mid-block shared prefix run
    concurrently against its published partial tail: each gets a private
    copy of the tail block and the cache-off tokens."""
    cfg = tiny[0]
    rng = np.random.RandomState(17)
    sysp = rng.randint(0, cfg.vocab_size, (13,))     # 1 full + 5 partial
    reqs = [port.Request(prompt=np.concatenate(
                [sysp, rng.randint(0, cfg.vocab_size, (4,))]),
            max_new_tokens=6, seed=3 + i, uid=f"d{i}") for i in range(3)]
    off = _engine(tiny, dtype)
    try:
        want = _tokens(off, reqs)
    finally:
        off.stop()
    on = _engine(tiny, dtype, prefix_cache=True)
    try:
        assert on.generate([port.Request(prompt=sysp, max_new_tokens=1,
                                         seed=99)], timeout=240)[0].ok
        tail_block = on.prefix_cache.lookup(np.concatenate([sysp, [0]]))[0]
        before = on.cache.k_pool[:, tail_block].clone()
        got = _tokens(on, reqs)
        after = on.cache.k_pool[:, tail_block]
        st = on.stats()
    finally:
        on.stop()
    assert got == want
    assert st["prefix_cache_hits"] >= len(reqs)
    assert torch.equal(before, after)    # the shared blocks were not written


def test_eviction_under_pressure_keeps_parity(tiny):
    """A pool too small to cache everything: admission evicts LRU idle
    chains instead of wedging, and a re-run of an evicted prompt refills
    cold with the same tokens."""
    cfg = tiny[0]
    rng = np.random.RandomState(23)
    prompts = [rng.randint(0, cfg.vocab_size, (9,)) for _ in range(6)]

    def one(eng, p):
        return eng.generate([port.Request(prompt=p, max_new_tokens=3,
                                          seed=7)], timeout=240)[0].tokens

    off = _engine(tiny, max_slots=2)
    try:
        want = [one(off, p) for p in prompts]
    finally:
        off.stop()
    port_metrics.reset("serving.prefix_cache.evictions")
    eng = _engine(tiny, prefix_cache=True, max_slots=2, num_blocks=10)
    try:
        got = [one(eng, p) for p in prompts]
        again = one(eng, prompts[0])
    finally:
        eng.stop()
    assert got == want and again == want[0]
    assert port_metrics.snapshot()[
        "serving.prefix_cache.evictions"]["value"] > 0


def test_prefix_cache_refuses_int8_kv_pools(tiny):
    from paddle_tpu.serving.engine import EngineConfig as RefConfig
    with pytest.raises(ValueError, match="float KV pools"):
        RefConfig(prefix_cache=True, kv_dtype="int8").resolve()
    with pytest.raises(ValueError, match="float KV pools"):
        _engine(tiny, prefix_cache=True, kv_dtype="int8")
