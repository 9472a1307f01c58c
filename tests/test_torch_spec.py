"""PyTorch port, speculative decoding: paddle_tpu_torch.serving.spec and
the engine's verify pass (the cases of tests/test_serving_spec.py).

* Inside the port, spec-on tokens == spec-off tokens at f32 and bf16:
  greedy and seeded top-k continuous batching, an all-rejected draft,
  max_new 1, eos inside a span, with the prefix cache; the rollback
  leaves refcounts exact over many rounds; kill_draft degrades with zero
  failed requests and resurrect_draft + rearm re-arm.
* Against the reference: greedy f32 spec-on tokens equal the reference
  engine's spec-on tokens; the mapped/reserve split and SpecConfig
  behave as the reference's; the span ops agree with the reference's
  within 1e-6 at f32.
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
from paddle_tpu_torch.ops import paged_ops as port_paged

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


def _mixed_reqs(vocab, seed=3, n=6, shared=False, req_cls=port.Request,
                greedy=False):
    """Greedy + seeded top-k mix; `shared` threads one system prompt
    through half the requests so the radix cache participates."""
    rng = np.random.RandomState(seed)
    sysp = rng.randint(0, vocab, (11,))
    reqs = []
    for i in range(n):
        prompt = rng.randint(0, vocab, (int(rng.randint(3, 13)),))
        if shared and i % 2 == 0:
            prompt = np.concatenate([sysp, prompt])
        sampled = i % 2 == 1 and not greedy
        reqs.append(req_cls(
            prompt=prompt, max_new_tokens=int(rng.randint(3, 9)),
            temperature=0.8 if sampled else 0.0, top_k=16 if sampled else 0,
            seed=100 + i, uid=f"s{i}"))
    return reqs


def _run(eng, reqs):
    try:
        comps = eng.generate(reqs, timeout=240)
        st = eng.stats()
    finally:
        eng.stop()
    assert all(c.ok for c in comps), [(c.uid, c.state, c.error)
                                      for c in comps]
    return {c.uid: c.tokens for c in comps}, st


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def spec_off(tiny, request):
    """(dtype, spec-off tokens of the standard mixed batch)."""
    toks, _ = _run(_engine(tiny, request.param),
                   _mixed_reqs(tiny[0].vocab_size))
    return request.param, toks


def test_spec_on_equals_spec_off_mixed_continuous(tiny, spec_off):
    dtype, want = spec_off
    got, st = _run(_engine(tiny, dtype, spec=True),
                   _mixed_reqs(tiny[0].vocab_size))
    assert got == want
    assert st["spec_decode"] and st["spec_rounds"] >= 1
    assert st["spec_accepted"] >= 1, st
    assert st["spec_proposed"] == st["spec_accepted"] + st["spec_rejected"]
    assert 0.0 <= st["spec_accept_rate"] <= 1.0
    assert st["spec_gamma"] == 4 and st["spec_draft_health"] == "live"


def test_all_rejected_drafts_still_equal_and_leak_nothing(tiny, spec_off):
    """A draft that proposes garbage every round: acceptance drops to 0,
    the tokens stay spec-off's and every speculative block rolls back."""
    dtype, want = spec_off
    vocab = tiny[0].vocab_size
    eng = _engine(tiny, dtype, spec=True)
    orig = eng.spec._propose

    def garbage():
        return {i: [(t + 1) % vocab for t in chain]
                for i, chain in orig().items()}

    eng.spec._propose = garbage
    total = eng.cache.config.num_blocks - 1
    got, st = _run(eng, _mixed_reqs(vocab))
    assert got == want
    assert st["spec_rejected"] >= 1 and st["spec_accepted"] == 0, st
    assert st["free_blocks"] == total


def test_max_new_one_and_eos_mid_span(tiny):
    vocab = tiny[0].vocab_size
    rng = np.random.RandomState(17)
    off = _engine(tiny)
    try:
        # the first prompt whose greedy run has a token first seen at
        # index >= 2: as eos, it latches inside a speculative span (the
        # tiny random model often repeats one token)
        for _ in range(20):
            prompt = rng.randint(0, vocab, (7,))
            ref6 = off.generate([port.Request(prompt=prompt,
                                              max_new_tokens=6)],
                                timeout=240)[0]
            eos = next((t for j, t in enumerate(ref6.tokens)
                        if j >= 2 and t not in ref6.tokens[:j]), None)
            if eos is not None:
                break
        assert eos is not None
        ref1 = off.generate([port.Request(prompt=prompt, max_new_tokens=1)],
                            timeout=240)[0]
        ref_eos = off.generate([port.Request(
            prompt=prompt, max_new_tokens=6, eos_token=eos)],
            timeout=240)[0]
    finally:
        off.stop()
    eng = _engine(tiny, spec=True)
    try:
        got1 = eng.generate([port.Request(prompt=prompt, max_new_tokens=1)],
                            timeout=240)[0]
        got_eos = eng.generate([port.Request(
            prompt=prompt, max_new_tokens=6, eos_token=eos)],
            timeout=240)[0]
    finally:
        eng.stop()
    assert got1.ok and got1.tokens == ref1.tokens
    assert got_eos.ok and got_eos.tokens == ref_eos.tokens
    assert got_eos.finish_reason == "eos"
    assert len(got_eos.tokens) == ref6.tokens.index(eos) + 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_spec_with_prefix_cache_parity_and_shared_blocks(tiny, dtype):
    """Speculation over radix-cache hits: the tokens of the cache-on,
    spec-off engine; the published chains' blocks keep their bits (a
    rollback never reaches them); nothing stays shared after retirement."""
    reqs = _mixed_reqs(tiny[0].vocab_size, seed=9, shared=True)
    ref, _ = _run(_engine(tiny, dtype, prefix_cache=True), reqs)
    eng = _engine(tiny, dtype, prefix_cache=True, spec=True)
    try:
        first = eng.generate(reqs[:1], timeout=240)[0]
        assert first.ok
        chain, _ = eng.prefix_cache.lookup(
            np.concatenate([reqs[0].prompt, [0]]))
        before = eng.cache.k_pool[:, chain].clone()
        comps = eng.generate(reqs, timeout=240)
        after = eng.cache.k_pool[:, chain]
        st = eng.stats()
    finally:
        eng.stop()
    assert {c.uid: c.tokens for c in comps} == ref
    assert torch.equal(before, after)
    assert st["prefix_cache_hits"] >= 1 and st["spec_accepted"] >= 1, st
    assert st["shared_blocks"] == 0


def test_rollback_refcount_exact_across_many_rounds(tiny):
    """50+ speculative rounds in waves, prefix-cache hits in the mix: after
    every wave the only live references are the radix cache's."""
    vocab = tiny[0].vocab_size
    eng = _engine(tiny, prefix_cache=True, spec=True)
    try:
        wave = 0
        while eng.stats()["spec_rounds"] < 50:
            assert wave < 40, "50 rounds never accumulated"
            comps = eng.generate(_mixed_reqs(vocab, seed=20 + wave,
                                             shared=True), timeout=240)
            wave += 1
            assert all(c.ok for c in comps)
            alloc = eng.cache.allocator
            assert alloc.shared_blocks == 0
            live = (eng.cache.config.num_blocks - 1) - alloc.free_blocks
            assert live == len(eng.prefix_cache), (wave, live)
            d = eng.spec.draft.cache.allocator
            assert d.free_blocks == eng.config.num_blocks - 1
    finally:
        eng.stop()


def test_kill_draft_degrades_then_rearms(tiny, spec_off):
    """kill_draft between rounds: zero failed requests, spec-off tokens,
    the degraded counter moves and plain windows carry on; then
    resurrect_draft + rearm speculate again with the same tokens."""
    dtype, want = spec_off
    vocab = tiny[0].vocab_size
    port_metrics.reset("serving.spec.degraded")
    eng = _engine(tiny, dtype, spec=True)
    try:
        reqs = _mixed_reqs(vocab)
        first = eng.generate(reqs[:3], timeout=240)
        assert eng.stats()["spec_rounds"] >= 1
        eng.spec.kill_draft("test: the draft dies mid-stream")
        rest = eng.generate(reqs[3:], timeout=240)
        st = eng.stats()
        eng.spec.resurrect_draft()
        assert eng.spec.health == port.Health.RESURRECTING
        eng.spec.rearm()
        rounds = st["spec_rounds"]
        again = eng.generate(reqs, timeout=240)
        st2 = eng.stats()
    finally:
        eng.stop()
    for c in first + rest + again:
        assert c.ok, (c.uid, c.state, c.error)
        assert c.tokens == want[c.uid], c.uid
    assert port_metrics.snapshot()["serving.spec.degraded"]["value"] >= 1
    assert not st["spec_armed"] and st["spec_degraded"] == 1
    assert st2["spec_armed"] and st2["spec_rounds"] > rounds


def test_greedy_f32_spec_tokens_match_reference_engine(tiny):
    from paddle_tpu.serving import DecodeEngine as RefEngine
    from paddle_tpu.serving import Request as RefRequest
    cfg, params = tiny[0], tiny[1]
    ref_eng = RefEngine(params, cfg, decode_kernel=False, spec=True, **GEO)
    want, ref_st = _run(ref_eng, _mixed_reqs(cfg.vocab_size,
                                             req_cls=RefRequest,
                                             greedy=True))
    got, st = _run(_engine(tiny, spec=True),
                   _mixed_reqs(cfg.vocab_size, greedy=True))
    assert got == want
    assert st["spec_rounds"] >= 1 and ref_st["spec_rounds"] >= 1


def test_mapped_reserve_split_matches_reference():
    """reserve_tail / extend_mapped / truncate_mapped / release through
    both packages' caches: the same rows, reserves, returns and errors."""
    from paddle_tpu.serving.cache import CacheConfig as RefConfig
    from paddle_tpu.serving.cache import PagedKVCache as RefCache
    geo = dict(num_layers=1, num_blocks=8, num_heads=1, block_size=4,
               head_dim=4, max_blocks_per_slot=6, dtype="float32")
    logs = []
    for cache in (RefCache(RefConfig(**geo)),
                  port.PagedKVCache(port.CacheConfig(**geo),
                                    torch.device("cpu"))):
        log = [list(cache.assign(0, 6))]
        cache.reserve_tail(0, 2)
        log += [cache.blocks_of(0), cache.reserved_of(0),
                cache.extend_mapped(0, 4), cache.blocks_of(0),
                cache.truncate_mapped(0, 2), cache.reserved_of(0),
                cache.extend_mapped(0, 3), cache.blocks_of(0)]
        with pytest.raises(ValueError):
            cache.extend_mapped(0, 7)
        with pytest.raises(ValueError):
            cache.truncate_mapped(0, 0)
        cache.release(0)
        log.append(cache.allocator.free_blocks)
        cache.close()
        logs.append(log)
    assert logs[0] == logs[1]
    assert logs[1][-1] == 7


def test_spec_config_validation():
    assert port.SpecConfig().resolve().tokens == 4       # the flag default
    assert port.SpecConfig(tokens=6).resolve().tokens == 6
    with pytest.raises(ValueError):
        port.SpecConfig(tokens=17).resolve()
    with pytest.raises(ValueError):
        port.SpecConfig(draft_dtype="int4").resolve()
    with pytest.raises(ValueError):
        port.SpecConfig(draft_params={"x": 1}).resolve()
    from paddle_tpu_torch import flags
    flags.set_flags({"FLAGS_serving_spec_tokens": 2})
    try:
        assert port.SpecConfig().resolve().tokens == 2
    finally:
        flags.set_flags({"FLAGS_serving_spec_tokens": 4})


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_span_ops_match_reference(kv):
    """paged_update_span + paged_attend_span (B4's plain version per row
    on CPU tensors) against the reference's span ops: the same pool bits
    after the writes, contexts within 1e-6."""
    import jax.numpy as jnp
    from paddle_tpu.ops import paged_ops as ref_paged
    rng = np.random.RandomState(4)
    L, NB, nh, bs, hd, B, MB, span = 2, 10, 2, 4, 8, 3, 4, 3
    kw = dict(kv_scale=4.0) if kv == "int8" else {}
    pool_dt = np.int8 if kv == "int8" else np.float32
    k_pool = (rng.randint(-100, 100, (L, NB, nh, bs, hd)).astype(pool_dt)
              if kv == "int8" else rng.randn(L, NB, nh, bs, hd)
              .astype(np.float32))
    v_pool = k_pool.copy()
    pt = np.array([[1, 2, 3, 0], [4, 5, 0, 0], [6, 7, 8, 9]], np.int32)
    pos = np.array([5, 2, 9], np.int32)
    k_new = rng.randn(B, nh, span, hd).astype(np.float32)
    v_new = rng.randn(B, nh, span, hd).astype(np.float32)
    q = rng.randn(B, nh, span, hd).astype(np.float32)
    live = np.array([True, True, False])
    valid = np.array([[True, True, False], [True, True, True],
                      [True, False, False]])
    rk, rv = ref_paged.paged_update_span(
        jnp.asarray(k_pool), jnp.asarray(v_pool), jnp.asarray(k_new),
        jnp.asarray(v_new), jnp.asarray(pt), jnp.asarray(pos), bs, 1,
        active=jnp.asarray(live), valid=jnp.asarray(valid), **kw)
    rctx = ref_paged.paged_attend_span(
        jnp.asarray(q), rk, rv, jnp.asarray(pt), jnp.asarray(pos), bs,
        layer=1, **kw)
    tk, tv = torch.from_numpy(k_pool.copy()), torch.from_numpy(v_pool.copy())
    port_paged.paged_update_span(
        tk, tv, torch.from_numpy(k_new), torch.from_numpy(v_new),
        torch.from_numpy(pt), torch.from_numpy(pos), bs, 1,
        active=torch.from_numpy(live), valid=torch.from_numpy(valid), **kw)
    ctx = port_paged.paged_attend_span(
        torch.from_numpy(q), tk, tv, torch.from_numpy(pt),
        torch.from_numpy(pos), bs, layer=1, **kw)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(rk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))
    np.testing.assert_allclose(ctx.numpy(), np.asarray(rctx), atol=1e-6,
                               rtol=0)
