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
* The port imports neither jax nor paddle_tpu (an ast walk).
"""
import ast
import dataclasses
import os

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as fluid

from paddle_tpu_torch.framework.errors import UnimplementedError
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
    dict(prefix_cache=True), dict(spec=True), dict(dtype="int8")],
    ids=["prefix_cache", "spec", "int8_weights"])
def test_unported_options_raise(tiny, option):
    with pytest.raises(NotImplementedError):
        _port_engine(tiny, **option)


def test_step_deadline_flag_raises(tiny):
    from paddle_tpu_torch import flags
    flags.set_flags({"FLAGS_step_deadline_ms": 100.0})
    try:
        with pytest.raises(UnimplementedError):
            _port_engine(tiny)
    finally:
        flags.set_flags({"FLAGS_step_deadline_ms": 0.0})


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
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "paddle_tpu"), \
                f"{os.path.relpath(path, REPO)} imports {mod}"
