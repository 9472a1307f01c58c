"""PyTorch port, the serving slice: paddle_tpu_torch.serving.DecodeEngine
held against the JAX DecodeEngine on the CPU, and the port's own
contracts.

* f32 greedy tokens identical to the JAX engine (dense-gather read path,
  decode_kernel=False), on the case of test_pallas_kernels._engine_tokens:
  prompts of 5/9/3 tokens, max_slots=3, block_size=8, num_blocks=24,
  max_len=32, window=4; again with int8 KV pools.
* Inside the port: continuous batching == generate_sequential (greedy and
  seeded top-k), and the paged engine == dense models.gpt_decode.generate.
  Seeded sampling is checked only inside the port: its draws are a pure
  function of (request seed, generated index), but not JAX's fold_in
  stream.
* int8 weights: quantize_params bit for bit and dequant_params within 0
  of the reference's; the int8 engines' greedy tokens equal.
* The chunked prefill against the reference's dense prefill (1e-5).
* The port imports neither jax nor paddle_tpu (an ast walk).
"""
import ast
import dataclasses
import os

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as fluid

from paddle_tpu_torch.models import gpt_decode as port_decode
from paddle_tpu_torch.models.gpt import GPTConfig as PortGPTConfig
from paddle_tpu_torch.ops.kernels import paged_attention as port_kernel
from paddle_tpu_torch import serving as port_serving

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENGINE = dict(max_slots=3, block_size=8, num_blocks=24, max_len=32,
              window=4)


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
    port_params = port_decode.params_from_numpy(port_cfg, arrays,
                                                device="cpu")
    return cfg, params, port_cfg, port_params


def _prompts(cfg):
    rng = np.random.RandomState(7)
    return [rng.randint(0, cfg.vocab_size, (n,)) for n in (5, 9, 3)]


def _requests(cfg, req_cls, **kw):
    return [req_cls(prompt=p, max_new_tokens=6, seed=i, **kw)
            for i, p in enumerate(_prompts(cfg))]


def _jax_tokens(cfg, params, **kw):
    from paddle_tpu.serving import DecodeEngine, Request
    eng = DecodeEngine(params, cfg, decode_kernel=False, **ENGINE, **kw)
    try:
        comps = eng.generate(_requests(cfg, Request), timeout=240)
    finally:
        eng.stop()
    assert all(c.ok for c in comps), comps
    return [list(c.tokens) for c in comps]


def _port_engine(tiny, **kw):
    _, _, port_cfg, port_params = tiny
    return port_serving.DecodeEngine(port_params, port_cfg, device="cpu",
                                     **{**ENGINE, **kw})


def _port_tokens(tiny, sequential=False, engine_kw=None, **req_kw):
    cfg = tiny[0]
    eng = _port_engine(tiny, **(engine_kw or {}))
    try:
        run = eng.generate_sequential if sequential else eng.generate
        comps = run(_requests(cfg, port_serving.Request, **req_kw),
                    timeout=240)
    finally:
        eng.stop()
    assert all(c.ok for c in comps), comps
    return [list(c.tokens) for c in comps]


@pytest.mark.parametrize("kv_dtype", ["", "int8"])
def test_engine_greedy_tokens_match_jax_engine(tiny, kv_dtype):
    cfg, params, _, _ = tiny
    kw = dict(kv_dtype="int8", kv_scale=8.0) if kv_dtype else {}
    want = _jax_tokens(cfg, params, **kw)
    got = _port_tokens(tiny, engine_kw=kw)
    assert got == want
    assert all(len(t) == 6 for t in got)


@pytest.mark.parametrize("sampling", [
    dict(), dict(temperature=0.8, top_k=20)], ids=["greedy", "topk"])
def test_continuous_batching_equals_sequential(tiny, sampling):
    batched = _port_tokens(tiny, **sampling)
    sequential = _port_tokens(tiny, sequential=True, **sampling)
    assert batched == sequential


@pytest.mark.parametrize("sampling", [
    dict(), dict(temperature=0.8, top_k=20)], ids=["greedy", "topk"])
def test_paged_engine_equals_dense_generate(tiny, sampling):
    cfg, _, port_cfg, port_params = tiny
    paged = _port_tokens(tiny, **sampling)
    for i, p in enumerate(_prompts(cfg)):
        dense = port_decode.generate(port_params, port_cfg, p[None], 6,
                                     seed=i, device="cpu", **sampling)
        assert dense[0, len(p):].tolist() == paged[i], f"request {i}"


def test_engine_counts_and_metrics_on_cpu(tiny):
    """On CPU tensors the engine reads through the plain version: no kernel
    launch is counted. The serving metrics move."""
    from paddle_tpu_torch.observability import metrics
    metrics.reset()
    port_kernel.reset_launches()
    _port_tokens(tiny)
    assert set(port_kernel.launches.values()) == {0}
    snap = metrics.snapshot()
    assert snap["serving.tokens_out"]["value"] == 3 * 5   # first via prefill
    assert snap["serving.ttft_ms"]["count"] == 3
    assert snap["serving.tpot_ms"]["count"] == 3
    assert snap["serving.window_ms"]["count"] >= 2


def test_engine_eos_and_stats(tiny):
    cfg = tiny[0]
    want = _port_tokens(tiny)
    eos = want[1][2]       # request 1 stops at its third token
    eng = _port_engine(tiny)
    try:
        comps = eng.generate(
            _requests(cfg, port_serving.Request, eos_token=eos),
            timeout=240)
        stats = eng.stats()
    finally:
        eng.stop()
    assert comps[1].finish_reason == "eos"
    assert comps[1].tokens == want[1][:want[1].index(eos) + 1]
    assert stats["completed"] == 3 and stats["active_slots"] == 0
    assert stats["free_blocks"] == ENGINE["num_blocks"] - 1
    assert stats["health"] == port_serving.Health.LIVE


def test_engine_rejects_and_sheds(tiny):
    cfg = tiny[0]
    R = port_serving.Request
    eng = _port_engine(tiny, num_blocks=3)
    try:
        assert eng.submit(R(prompt=[], max_new_tokens=2)).result(
            timeout=5, raise_on_error=False).state == "rejected"
        bad_tok = eng.submit(R(prompt=[cfg.vocab_size], max_new_tokens=2))
        assert bad_tok.result(timeout=5, raise_on_error=False).state \
            == "rejected"
        too_long = eng.submit(R(prompt=np.zeros(30, np.int32),
                                max_new_tokens=8))
        assert "budget" in too_long.result(
            timeout=5, raise_on_error=False).finish_reason
        # 20 positions need 3 blocks; the pool has 2 besides scratch
        h = eng.submit(R(prompt=np.zeros(12, np.int32), max_new_tokens=8))
        with pytest.raises(port_serving.ShedError) as e:
            h.result(timeout=5)
        assert e.value.reason == "unfundable"
    finally:
        eng.stop()


def test_block_allocator_all_or_nothing_and_double_free():
    alloc = port_serving.BlockAllocator(5)
    a = alloc.alloc(3)
    assert sorted(a) == [1, 2, 3] and alloc.free_blocks == 1
    assert alloc.alloc(2) is None and alloc.free_blocks == 1
    alloc.free(a[:1])
    with pytest.raises(ValueError, match="double-free"):
        alloc.free(a[:1])
    with pytest.raises(ValueError, match="scratch"):
        alloc.free([0])
    assert alloc.free_blocks == 2
    alloc.close()
    cache = port_serving.PagedKVCache(port_serving.CacheConfig(
        num_layers=1, num_heads=2, head_dim=4, block_size=8, num_blocks=6,
        max_blocks_per_slot=3), torch.device("cpu"))
    assert cache.assign(1, 2) is not None
    with pytest.raises(ValueError, match="already holds"):
        cache.assign(1, 1)
    pt = cache.page_table_rows(3)
    assert pt.dtype == np.int32 and pt.shape == (3, 3)
    assert (pt[0] == 0).all() and (pt[1, :2] > 0).all() and pt[1, 2] == 0
    cache.release(1)
    with pytest.raises(KeyError):
        cache.release(1)
    cache.close()


@pytest.mark.parametrize("option", [
    dict(prefix_cache=True), dict(spec=True),
    dict(spec=port_serving.SpecConfig(tokens=2, draft_dtype="bfloat16")),
    dict(dtype="int8")],
    ids=["prefix_cache", "spec", "spec_config", "int8_weights"])
def test_ported_options_serve(tiny, option):
    """The options the reference serves with build an engine and serve
    the greedy requests with the tokens of the plain engine (int8: the
    requests complete)."""
    got = _port_tokens(tiny, engine_kw=option)
    assert all(len(t) == 6 for t in got)
    if "dtype" not in option:
        assert got == _port_tokens(tiny)


def test_int8_quantize_matches_reference_bitwise(tiny):
    """quantize_params: the int8 payloads and f32 scales of the reference,
    bit for bit; dequant_params (the registered dequantize_abs_max
    lowering) equal within 0, in f32 and in bf16."""
    import jax.numpy as jnp
    from paddle_tpu.serving import weights as ref_weights
    _, params, _, _ = tiny
    r_pay, r_sc = ref_weights.quantize_params(params)
    arrays = {n: np.asarray(a) for n, a in params.items()}
    p_pay, p_sc = port_serving.quantize_params(arrays)
    assert sorted(p_sc) == sorted(r_sc)
    assert "wte" in p_sc and "dec0_ln1_scale" not in p_sc
    for n in r_pay:
        np.testing.assert_array_equal(p_pay[n].numpy(), np.asarray(r_pay[n]))
    for n in r_sc:
        assert p_sc[n].dtype == torch.float32
        np.testing.assert_array_equal(p_sc[n].numpy(), np.asarray(r_sc[n]))
    for r_dt, p_dt in ((jnp.float32, torch.float32),
                       (jnp.bfloat16, torch.bfloat16)):
        want = ref_weights.dequant_params(r_pay, r_sc, compute_dtype=r_dt)
        got = port_serving.dequant_params(p_pay, p_sc, compute_dtype=p_dt)
        for n in r_sc:
            np.testing.assert_array_equal(
                got[n].float().numpy(),
                np.asarray(want[n]).astype(np.float32))


def test_int8_engine_greedy_tokens_match_jax_engine(tiny):
    """The int8-weight engines of both packages on the same prompts: the
    same greedy tokens. Both keep the biases f32, so both compute their
    activations in f32 against the bf16 KV pool."""
    cfg, params, _, _ = tiny
    want = _jax_tokens(cfg, params, dtype="int8")
    got = _port_tokens(tiny, engine_kw=dict(dtype="int8"))
    assert got == want
    eng = _port_engine(tiny, dtype="int8")
    try:
        assert eng.params["wte"].dtype == torch.int8
        assert eng.params["dec0_attn_qkv_b"].dtype == torch.float32
        assert eng.params["dec0_ln1_scale"].dtype == torch.float32
        assert eng.compute_dtype == torch.bfloat16
        assert eng.cache.k_pool.dtype == torch.bfloat16
    finally:
        eng.stop()


def test_chunked_prefill_matches_dense_prefill(tiny):
    """The engine's prefill in chunks (8 rows at max_len 32, 16 at 64)
    against one fixed-width k/v buffer: the prompt's k/v agree with the
    reference's dense prefill at f32 within 1e-5, and the first token is
    the same whatever the chunk."""
    from paddle_tpu.models import gpt_decode as ref_decode
    import jax.numpy as jnp
    cfg, params, _, _ = tiny
    prompt = np.random.RandomState(3).randint(0, cfg.vocab_size, (19,))
    rk, rv, _ = ref_decode.prefill(params, cfg, jnp.asarray(prompt[None]),
                                   19, 19)
    firsts = []
    for max_len in (32, 64):
        eng = _port_engine(tiny, max_len=max_len)
        try:
            assert eng.prefill_chunk == max_len // 4
            k, v, first = eng._prefill_fn(prompt, 19, 0.0, 0, 0)
        finally:
            eng.stop()
        assert k.shape[2] == eng.prefill_width >= 32
        for i in range(cfg.num_layers):
            np.testing.assert_allclose(k[i, :, :19].numpy(),
                                       np.asarray(rk[i])[0], atol=1e-5)
            np.testing.assert_allclose(v[i, :, :19].numpy(),
                                       np.asarray(rv[i])[0], atol=1e-5)
        firsts.append(int(first))
    assert len(set(firsts)) == 1


def test_sampler_is_a_pure_function_of_seed_and_index():
    """The Gumbel noise of a row depends on (seed, index) only: the same in
    any batch position and batch, other for another seed or index; top_k
    1 and temperature 0 both give the argmax; top_k k draws only from the
    k largest logits."""
    seeds = torch.tensor([port_decode.fold_seed(s) for s in (5, 6, 5)])
    index = torch.tensor([3, 3, 4])
    noise = port_decode.gumbel_noise(seeds, index, 300)
    alone = port_decode.gumbel_noise(seeds[1:2], index[1:2], 300)
    assert torch.equal(noise[1], alone[0])
    assert not torch.equal(noise[0], noise[1])
    assert not torch.equal(noise[0], noise[2])
    assert torch.equal(port_decode.gumbel_noise(seeds, index, 300), noise)
    logits = torch.randn(3, 300, generator=torch.Generator().manual_seed(1))
    top = torch.argmax(logits, dim=-1)
    for temps, ks in (([0.0] * 3, [0, 5, 0]), ([0.9] * 3, [1, 1, 1])):
        got = port_decode.sample_rows(logits, torch.tensor(temps),
                                      torch.tensor(ks), seeds, index)
        assert torch.equal(got, top)
    top5 = set(torch.topk(logits[0], 5).indices.tolist())
    for i in range(40):
        tok = port_decode.sample_rows(
            logits[:1], torch.tensor([1.0]), torch.tensor([5]),
            torch.tensor([port_decode.fold_seed(i)]), torch.tensor([0]))
        assert int(tok) in top5


def test_slot_placement_does_not_change_seeded_tokens(tiny):
    cfg = tiny[0]
    reqs = _requests(cfg, port_serving.Request, temperature=0.8, top_k=20)
    eng = _port_engine(tiny)
    try:
        fwd = [c.tokens for c in eng.generate(reqs, timeout=240)]
        rev = [c.tokens for c in eng.generate(reqs[::-1], timeout=240)]
    finally:
        eng.stop()
    assert fwd == rev[::-1]


def test_replay_launch_counting():
    """A capture's launches are recorded apart from the counts (on the
    capturing thread only) and added again per replay."""
    port_kernel.reset_launches()
    port_kernel.launches["paged_decode_bf16"] = 3
    with port_kernel.capture_launches() as delta:
        for _ in range(24):                           # "captured"
            port_kernel._count("paged_decode_bf16")
    assert delta["paged_decode_bf16"] == 24
    assert port_kernel.launches["paged_decode_bf16"] == 3
    for _ in range(2):
        port_kernel.count_replay(delta)
    assert port_kernel.launches["paged_decode_bf16"] == 51
    port_kernel.reset_launches()


def test_engine_defaults_to_cuda(tiny, monkeypatch):
    _, _, port_cfg, port_params = tiny
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_serving.DecodeEngine(port_params, port_cfg, **ENGINE)


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_reference():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "paddle_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 15
    walked = {os.path.relpath(f, REPO) for f in files}
    for new in ("serving/resilience.py", "serving/frontend.py",
                "observability/trace.py", "observability/flight.py",
                "resilience/faults.py", "resilience/retry.py",
                "resilience/__init__.py", "monitor.py",
                "framework/fetch.py", "framework/executor.py",
                "models/gpt.py", "ops/kernels/counts.py", "lr.py",
                "io.py", "layers/learning_rate_scheduler.py",
                "resilience/checkpoint.py", "resilience/snapshot.py",
                "resilience/integrity.py", "dataloader/__init__.py",
                "dataloader/dataloader.py", "dataloader/dataset.py",
                "dataloader/sampler.py", "dataloader/feeder.py",
                "dataset.py", "native/__init__.py", "native/dataplane.py"):
        assert f"paddle_tpu_torch/{new}" in walked, new
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "paddle_tpu"), \
                f"{os.path.relpath(path, REPO)} imports {mod}"
