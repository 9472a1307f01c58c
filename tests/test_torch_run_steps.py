"""PyTorch port, the executor surface: `Executor.run_steps`, `FetchHandle`
lazy fetches, `Executor.stage`, `Program.clone(for_test)` and the device
run seed, modelled on the reference's tests/test_run_steps.py and
tests/test_async_dispatch.py.

* `run_steps(k)` equals k `run()` calls BIT FOR BIT, dropout on (hidden
  and attention dropout 0.1), on BERT-tiny and GPT-tiny: every stacked
  loss and every persistable after the last step. k = 1 equals run;
  k < 1 raises; parameter-server / pipeline / LocalSGD programs raise.
* Feeds with a leading [k] axis and broadcast feeds (the per-step shape)
  both work, and agree bit for bit when the [k] axis repeats one batch;
  fetches are stacked [k, ...]; a feed of neither shape raises.
* The port's run_steps losses match the reference's run_steps losses at
  f32 with dropout off (rtol 1e-5: the frameworks sum in other orders).
* FetchHandle: lazy until read, one counted sync per materialisation,
  indexing a stacked fetch stays on the device; `return_numpy=False`
  gives unsynced tensors; sync is the default.
* `stage`: consumed by the matching call only, bounded per tag, and a
  snapshot (a host array changed after stage does not reach the run).
* `clone(for_test=True)`: its desc equals the reference's clone of the
  same program, and its eval loss matches the reference's (rtol 1e-5).
* The device run seed: keys derived from a seed tensor equal keys from
  the same int; the flash plain version fed a seed tensor equals the one
  fed the same int (bit for bit, values and gradients).
* Persistables are written in place: a step leaves every scope tensor at
  its address, and a rebinding inside a capture raises.
* Captures and the garbage collector: `collector_paused` collects once,
  then keeps the cyclic collector off (nesting, across threads, and
  leaving a collector that was off, off); a captured step holds no
  reference to its executor, so a dropped executor is freed at once.
* On a CUDA card (marker `cuda`, skipped here; run it there with
  `python -m pytest -m cuda tests/test_torch_run_steps.py`): the captured
  run_steps(3) equals 3 eager runs bit for bit, dropout on, with no eager
  step, also across two captured signatures, staged feeds and lazy
  fetches; a dead executor's graph, left in a reference cycle, is freed
  before the next capture and never inside it (freeing a CUDA graph
  inside a capture invalidates that capture).
"""
import gc
import threading
import weakref

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.fluid as fluid
from paddle_tpu.framework import program as ref_program
from paddle_tpu.framework import unique_name as ref_unique_name
from paddle_tpu.framework.scope import Scope as RefScope
from paddle_tpu.models import gpt as ref_gpt

from paddle_tpu_torch import monitor
from paddle_tpu_torch.device import collector_paused
from paddle_tpu_torch import optimizer as port_optimizer
from paddle_tpu_torch.flags import flag
from paddle_tpu_torch.framework import Executor, Scope, errors, load_numpy
from paddle_tpu_torch.framework import executor as port_executor
from paddle_tpu_torch.framework import program as port_program
from paddle_tpu_torch.framework import unique_name as port_unique_name
from paddle_tpu_torch.framework.fetch import FetchHandle
from paddle_tpu_torch.models import bert as port_bert
from paddle_tpu_torch.models import gpt as port_gpt
from paddle_tpu_torch.observability import metrics
from paddle_tpu_torch.ops import registry as port_registry
from paddle_tpu_torch.ops.kernels import flash_attention as port_fa

K, BATCH = 3, 2


def _port_program(model, dropout, cfg=None):
    """(main, startup, feed names, loss) of the port's BERT pretrain or GPT
    LM program with Adam(1e-3)."""
    main, start = port_program.Program(), port_program.Program()
    with port_program.program_guard(main, start), port_unique_name.guard():
        if model == "bert":
            cfg = cfg or port_bert.BertConfig.tiny()
            cfg.hidden_dropout = cfg.attention_dropout = dropout
            _, _, loss = port_bert.build_pretrain_program(
                cfg, use_input_mask=True)
        else:
            cfg = cfg or port_gpt.GPTConfig.tiny()
            cfg.hidden_dropout = cfg.attention_dropout = dropout
            _, loss = port_gpt.build_lm_program(cfg)
        port_optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return main, start, cfg, loss


def _feeds(model, cfg, k=K, seed=0):
    """[k, ...] feeds: random ids (and labels and a padding mask)."""
    rng = np.random.RandomState(seed)
    s = cfg.seq_len
    ids = rng.randint(0, cfg.vocab_size, (k, BATCH, s)).astype(np.int64)
    if model == "gpt":
        return {"tokens": ids}
    lens = rng.randint(s // 2, s + 1, size=(k, BATCH, 1))
    return {"input_ids": ids,
            "mlm_labels": rng.randint(0, cfg.vocab_size,
                                      (k, BATCH, s, 1)).astype(np.int64),
            "input_mask": (np.arange(s) < lens).astype(np.float32)}


def _start_arrays(start, device="cpu"):
    scope = Scope()
    Executor(device).run(start, scope=scope)
    return {n: scope.numpy(n) for n in scope.local_names()
            if not n.startswith("__")}


def _persistables(main):
    return sorted(v.name for v in main.global_block().vars.values()
                  if v.persistable)


@pytest.mark.parametrize("model", ["bert", "gpt"])
def test_run_steps_equals_k_runs_bitwise_with_dropout(model):
    main, start, cfg, loss = _port_program(model, dropout=0.1)
    assert any(op.type == "dropout" for op in main.global_block().ops)
    arrays = _start_arrays(start)
    feeds = _feeds(model, cfg)
    exe = Executor("cpu")
    a = load_numpy(Scope(), arrays, "cpu")
    runs = [exe.run(main, feed={n: v[b] for n, v in feeds.items()},
                    fetch_list=[loss], scope=a)[0] for b in range(K)]
    b = load_numpy(Scope(), arrays, "cpu")
    stacked, = exe.run_steps(K, main, feed=feeds, fetch_list=[loss], scope=b)
    assert stacked.shape == (K,)
    np.testing.assert_array_equal(stacked, np.stack(runs))
    assert len(set(stacked.tolist())) == K
    for n in _persistables(main):
        assert torch.equal(a.find(n), b.find(n)), n
    assert a.find("__rng_state__") == b.find("__rng_state__") == K


def test_run_steps_k1_equals_run_and_bad_k_raises():
    main, start, cfg, loss = _port_program("gpt", dropout=0.1)
    arrays = _start_arrays(start)
    feed = {"tokens": _feeds("gpt", cfg, k=1)["tokens"][0]}
    exe = Executor("cpu")
    a, b = (load_numpy(Scope(), arrays, "cpu") for _ in range(2))
    one, = exe.run(main, feed=feed, fetch_list=[loss], scope=a)
    st, = exe.run_steps(1, main, feed=feed, fetch_list=[loss], scope=b)
    assert st.shape == (1,) and st[0] == one
    for n in _persistables(main):
        assert torch.equal(a.find(n), b.find(n)), n
    for bad in (0, -1, 1.5, True):
        with pytest.raises(errors.InvalidArgumentError):
            exe.run_steps(bad, main, feed=feed, fetch_list=[loss], scope=b)
    for attr, val in (("_ps_hooks", [object()]), ("_microbatch_k", 4),
                      ("_localsgd_k", 2)):
        setattr(main, attr, val)
        with pytest.raises(errors.UnimplementedError):
            exe.run_steps(2, main, feed=feed, fetch_list=[loss], scope=b)
        delattr(main, attr)


def test_broadcast_and_stacked_feeds_agree():
    main, start, cfg, loss = _port_program("gpt", dropout=0.1)
    arrays = _start_arrays(start)
    one = _feeds("gpt", cfg, k=1)["tokens"][0]
    exe = Executor("cpu")
    a, b = (load_numpy(Scope(), arrays, "cpu") for _ in range(2))
    bc, = exe.run_steps(K, main, feed={"tokens": one}, fetch_list=[loss],
                        scope=a)
    st, = exe.run_steps(K, main, feed={"tokens": np.stack([one] * K)},
                        fetch_list=[loss], scope=b)
    np.testing.assert_array_equal(bc, st)
    assert len(set(bc.tolist())) == K          # each step trained
    # a fetched parameter comes back stacked per step
    w, = exe.run_steps(2, main, feed={"tokens": one}, fetch_list=["wte"],
                       scope=a)
    assert w.shape == (2,) + tuple(arrays["wte"].shape)
    assert not np.array_equal(w[0], w[1])
    with pytest.raises(errors.InvalidArgumentError, match="matches neither"):
        exe.run_steps(K, main, feed={"tokens": one[None, None]},
                      fetch_list=[loss], scope=a)


def _ref_gpt(dropout, fused=None, opt=True):
    main, start = ref_program.Program(), ref_program.Program()
    with ref_program.program_guard(main, start), ref_unique_name.guard():
        cfg = ref_gpt.GPTConfig.tiny()
        cfg.hidden_dropout = cfg.attention_dropout = dropout
        _, loss = ref_gpt.build_lm_program(cfg, fused_head=fused)
        if opt:
            paddle.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return main, start, cfg, loss


def test_run_steps_matches_reference_run_steps():
    """f32, dropout off: the port's stacked losses and final parameters
    against the reference's run_steps (rtol 1e-5 / atol 1e-5)."""
    rmain, rstart, rcfg, rloss = _ref_gpt(dropout=0.0)
    rscope = RefScope()
    rexe = fluid.Executor()
    rexe.run(rstart, scope=rscope)
    init = {n: np.asarray(rscope.find(n)) for n in rscope.local_names()
            if not n.startswith("__")}
    feeds = _feeds("gpt", rcfg)
    want, = rexe.run_steps(K, rmain, feed=feeds, fetch_list=[rloss],
                           scope=rscope)
    main, _, _, loss = _port_program("gpt", dropout=0.0)
    scope = load_numpy(Scope(), init, "cpu")
    got, = Executor("cpu").run_steps(K, main, feed=feeds, fetch_list=[loss],
                                     scope=scope)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5)
    for n in ("wte", "dec0_attn_qkv_w", "dec1_ffn_out_w"):
        np.testing.assert_allclose(scope.numpy(n), np.asarray(rscope.find(n)),
                                   rtol=0, atol=1e-5, err_msg=n)


def _sync_count():
    return monitor.stat_get("executor.fetch_sync_count")


def test_fetch_handle_lazy_counted_and_indexed_on_device():
    main, start, cfg, loss = _port_program("gpt", dropout=0.0)
    scope = load_numpy(Scope(), _start_arrays(start), "cpu")
    feeds = _feeds("gpt", cfg)
    exe = Executor("cpu")
    assert flag("FLAGS_async_dispatch") is False
    out, = exe.run(main, feed={"tokens": feeds["tokens"][0]},
                   fetch_list=[loss], scope=scope)
    assert isinstance(out, np.ndarray)                 # sync by default
    n0 = _sync_count()
    h, = exe.run(main, feed={"tokens": feeds["tokens"][1]},
                 fetch_list=[loss], scope=scope, sync=False)
    assert isinstance(h, FetchHandle) and not h.is_materialized()
    assert h.shape == () and h.dtype == np.float32
    assert _sync_count() == n0
    v = float(h)
    assert h.is_materialized() and _sync_count() == n0 + 1
    assert float(h) == v and np.asarray(h).shape == ()
    assert _sync_count() == n0 + 1
    stk, = exe.run_steps(K, main, feed=feeds, fetch_list=[loss],
                         scope=scope, sync=False)
    assert isinstance(stk, FetchHandle) and stk.shape == (K,)
    assert len(stk) == K
    tail = stk[-1]
    assert isinstance(tail, FetchHandle) and not stk.is_materialized()
    assert isinstance(tail.device_array, torch.Tensor)
    last = float(tail)
    assert not stk.is_materialized() and _sync_count() == n0 + 2
    np.testing.assert_array_equal(last, np.asarray(stk)[-1])
    assert stk[-1].is_materialized() and float(stk[-1].numpy()) == last
    raw, = exe.run(main, feed={"tokens": feeds["tokens"][0]},
                   fetch_list=[loss], scope=scope, return_numpy=False)
    rs, = exe.run_steps(2, main, feed={"tokens": feeds["tokens"][:2]},
                        fetch_list=[loss], scope=scope, return_numpy=False)
    assert isinstance(raw, torch.Tensor) and isinstance(rs, torch.Tensor)
    assert rs.shape == (2,) and _sync_count() == n0 + 3


def test_lazy_fetch_of_a_parameter_is_a_snapshot():
    """A fetched persistable is copied: the next step updates the scope's
    tensor in place, the handle keeps the value of its own step."""
    main, start, cfg, loss = _port_program("gpt", dropout=0.0)
    scope = load_numpy(Scope(), _start_arrays(start), "cpu")
    feeds = _feeds("gpt", cfg)
    exe = Executor("cpu")
    h, = exe.run(main, feed={"tokens": feeds["tokens"][0]},
                 fetch_list=["wte"], scope=scope, sync=False)
    after_one = scope.numpy("wte")
    exe.run(main, feed={"tokens": feeds["tokens"][1]}, fetch_list=[loss],
            scope=scope)
    np.testing.assert_array_equal(np.asarray(h), after_one)
    assert not np.array_equal(scope.numpy("wte"), after_one)


def test_stage_matching_depth_and_snapshot():
    main, start, cfg, loss = _port_program("gpt", dropout=0.1)
    arrays = _start_arrays(start)
    feeds = _feeds("gpt", cfg, k=6)["tokens"]
    exe = Executor("cpu")
    a, b = (load_numpy(Scope(), arrays, "cpu") for _ in range(2))
    want, = exe.run(main, feed={"tokens": feeds[0]}, fetch_list=[loss],
                    scope=a)
    host = feeds[0].copy()
    feed = {"tokens": host}
    dev = exe.stage(feed, program=main)
    assert isinstance(dev["tokens"], torch.Tensor)
    assert metrics.get("executor.dispatch_queue_depth") == 1
    host[:] = 0                                  # after stage: not seen
    # a call with other feed objects does not consume the window
    other = {"tokens": feeds[0].copy()}
    assert exe._take_staged(main, other, None) is None
    got, = exe.run(main, feed=feed, fetch_list=[loss], scope=b)
    assert got == want
    assert metrics.get("executor.dispatch_queue_depth") == 0
    # bounded per tag: manual windows drop the oldest, tagged ones stay
    tag = object()
    for i in range(3):
        exe.stage({"tokens": feeds[i]}, program=main, tag=tag, depth=4)
    for i in range(3, 6):
        exe.stage({"tokens": feeds[i]}, program=main)
    tags = [e.tag for e in exe._staged]
    depth = int(flag("FLAGS_dispatch_queue_depth"))
    assert tags.count(tag) == 3 and tags.count(None) == depth
    # run_steps consumes a window staged with k
    exe._staged.clear()
    kfeed = {"tokens": feeds[:K]}
    exe.stage(kfeed, program=main, k=K)
    out, = exe.run_steps(K, main, feed=kfeed, fetch_list=[loss], scope=b)
    assert out.shape == (K,) and not exe._staged


def test_clone_for_test_desc_and_eval_loss_match_reference():
    rmain, rstart, rcfg, rloss = _ref_gpt(dropout=0.1)
    main, start, cfg, loss = _port_program("gpt", dropout=0.1)
    rtest, ptest = rmain.clone(for_test=True), main.clone(for_test=True)
    assert ptest.to_desc() == rtest.to_desc()
    ops = ptest.global_block().ops
    assert ops and all(op.attrs.get("op_role", 0) not in (1, 2)
                       for op in ops)
    assert all(op.attrs["is_test"] for op in ops if "is_test" in op.attrs)
    assert len(ops) < len(main.global_block().ops)
    rscope = RefScope()
    fluid.Executor().run(rstart, scope=rscope)
    init = {n: np.asarray(rscope.find(n)) for n in rscope.local_names()
            if not n.startswith("__")}
    feed = {"tokens": _feeds("gpt", cfg, k=1)["tokens"][0]}
    want, = fluid.Executor().run(rtest, feed=feed, fetch_list=[rloss],
                                 scope=rscope)
    scope = load_numpy(Scope(), init, "cpu")
    got, = Executor("cpu").run(ptest, feed=feed, fetch_list=[loss],
                               scope=scope)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5)
    np.testing.assert_array_equal(scope.numpy("wte"), init["wte"])


@pytest.mark.parametrize("seed", [0, 5, -3, 2 ** 31 + 7, (1 << 40) + 9])
def test_seed_tensor_derives_the_keys_of_the_same_int(seed):
    attrs = {"__rng_seed__": 11}
    a = port_registry.LowerCtx(run_seed=seed).op_seed(attrs)
    b = port_registry.LowerCtx(
        run_seed=torch.tensor(seed, dtype=torch.int64)).op_seed(attrs)
    assert a.dtype == torch.int32 and a.shape == (1,)
    assert torch.equal(a, b)
    other = port_registry.LowerCtx(run_seed=seed + 1).op_seed(attrs)
    assert not torch.equal(a, other)


@pytest.mark.parametrize("seed", [9, -3, 2 ** 31 + 5])
def test_flash_plain_takes_a_seed_tensor(seed):
    """The plain flash version keyed by a seed tensor (the executor's
    device key) equals the one keyed by the same int: output and
    gradients bit for bit, causal and dropout 0.1."""
    rng = np.random.RandomState(0)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((2, 2, 16, 8))
                                    .astype(np.float32)) for _ in range(4))
    s32 = seed & 0xFFFFFFFF
    t = torch.tensor([s32 - (1 << 32) if s32 >= 1 << 31 else s32],
                     dtype=torch.int32)

    def run(sd):
        qq, kk, vv = (x.clone().requires_grad_() for x in (q, k, v))
        o = port_fa.flash_attention(qq, kk, vv, causal=True, dropout=0.1,
                                    seed=sd)
        return (o,) + torch.autograd.grad(o, (qq, kk, vv), do)

    for x, y in zip(run(seed), run(t)):
        assert torch.equal(x, y)
    assert torch.equal(port_fa.seed_tensor(seed, torch.device("cpu")), t)


def test_persistables_written_in_place():
    main, start, cfg, loss = _port_program("gpt", dropout=0.0)
    scope = load_numpy(Scope(), _start_arrays(start), "cpu")
    before = {n: scope.find(n) for n in _persistables(main)}
    ptrs = {n: t.data_ptr() for n, t in before.items()}
    pow1 = [n for n in before if "beta1_pow" in n]
    assert pow1
    v0 = scope.numpy(pow1[0])
    Executor("cpu").run(main, feed={"tokens": _feeds("gpt", cfg, k=1)[
        "tokens"][0]}, fetch_list=[loss], scope=scope)
    for n, t in before.items():
        assert scope.find(n) is t and t.data_ptr() == ptrs[n], n
    np.testing.assert_allclose(scope.numpy(pow1[0]), v0 * 0.9, rtol=1e-6)
    with pytest.raises(errors.UnavailableError, match="rebound"):
        port_executor._write_persistable(scope, "wte", torch.zeros(3),
                                         strict=True)


class _Cycle:
    def __init__(self):
        self.me = self


def test_collector_paused_collects_then_pauses_and_nests():
    assert gc.isenabled()
    dead = _Cycle()
    ref = weakref.ref(dead)
    del dead
    entered, left = threading.Event(), threading.Event()
    seen = {}

    def other_thread():
        with collector_paused():
            entered.set()
            left.wait(10)
        seen["after_other"] = gc.isenabled()

    with collector_paused():
        # the dead cycle went in the collection at the start
        assert ref() is None
        assert not gc.isenabled()
        t = threading.Thread(target=other_thread)
        t.start()
        assert entered.wait(10)
        with collector_paused():
            assert not gc.isenabled()
        assert not gc.isenabled()
    # the other thread still holds it off
    assert not gc.isenabled()
    left.set()
    t.join(10)
    assert seen["after_other"] and gc.isenabled()


def test_collector_paused_keeps_a_disabled_collector_off():
    gc.disable()
    try:
        with collector_paused():
            assert not gc.isenabled()
        assert not gc.isenabled()
    finally:
        gc.enable()


def test_dropped_executor_frees_its_captured_steps_without_a_collection():
    main, _, _, _ = _port_program("bert", dropout=0.0)
    exe, scope = Executor("cpu"), Scope()
    exe._captured["key"] = port_executor._CapturedStep(
        exe.device, main, {"x": ((2,), torch.float32)}, [], scope)
    ref = weakref.ref(exe)
    gc.disable()
    try:
        del exe
        assert ref() is None
    finally:
        gc.enable()


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the captured step runs only there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_captured_run_steps_equals_eager_runs_on_the_card(cuda_card):
    """GPT at head_dim 64 (the flash kernels' width), 2 layers, dropout
    0.1: run_steps(3) replays the captured step; it equals 3 eager runs bit
    for bit, the captured arm makes no eager step, and B1-B3 launch once
    per layer and step. A second fetch list captures a second graph in the
    executor's pool; fed from `stage` and fetched lazily, both graphs in
    turn go on equal to the eager runs."""
    cfg = port_gpt.GPTConfig(vocab_size=512, hidden_size=128, num_layers=2,
                             num_heads=2, intermediate_size=256,
                             max_position=64, seq_len=64)
    main, start, cfg, loss = _port_program("gpt", dropout=0.1, cfg=cfg)
    arrays = _start_arrays(start, "cuda")
    feeds = _feeds("gpt", cfg)
    eager, cap = Executor("cuda"), Executor("cuda")
    a = load_numpy(Scope(), arrays, "cuda")
    runs = [eager.run(main, feed={"tokens": feeds["tokens"][b]},
                      fetch_list=[loss], scope=a)[0] for b in range(K)]
    b = load_numpy(Scope(), arrays, "cuda")
    port_fa.reset_launches()
    stacked, = cap.run_steps(K, main, feed=feeds, fetch_list=[loss],
                             scope=b)
    np.testing.assert_array_equal(stacked, np.stack(runs))
    for n in _persistables(main):
        assert torch.equal(a.find(n), b.find(n)), n
    assert cap.stats["eager_steps"] == 0 and cap.stats["graph_replays"] == K
    port_fa.reset_launches()
    cap.run_steps(K, main, feed=feeds, fetch_list=[loss], scope=b)
    assert cap.stats["captures"] == 1
    assert port_fa.launches == dict.fromkeys(port_fa.KERNEL_NAMES,
                                             K * cfg.num_layers)
    # a second signature (another fetch list) shares the executor's pool;
    # with staged feeds and lazy handles, both graphs in turn stay equal
    # to the eager runs
    def eager_k():
        return np.stack([eager.run(main, feed={"tokens": feeds["tokens"][j]},
                                   fetch_list=[loss], scope=a)[0]
                         for j in range(K)])

    eager_k()                                   # a catches up with b
    cap.stage(feeds, program=main, k=K)
    h, w = cap.run_steps(K, main, feed=feeds, fetch_list=[loss, "wpe"],
                         scope=b, sync=False)
    assert isinstance(h, FetchHandle) and not h.is_materialized()
    assert not cap._staged
    np.testing.assert_array_equal(np.asarray(h), eager_k())
    np.testing.assert_array_equal(w.numpy()[-1], a.numpy("wpe"))
    st, = cap.run_steps(K, main, feed=feeds, fetch_list=[loss], scope=b)
    np.testing.assert_array_equal(st, eager_k())
    assert cap.stats["captures"] == 2 and cap.stats["eager_steps"] == 0
    for n in _persistables(main):
        assert torch.equal(a.find(n), b.find(n)), n


@pytest.mark.cuda
def test_dead_executor_graph_is_freed_outside_the_next_capture(cuda_card):
    """A captured executor dropped inside a reference cycle, then a capture
    in a second executor with the collector set to run at every
    allocation: the dead graph is freed by the collection before the
    capture (never inside it, which would invalidate the capture), and the
    second executor captures once and equals eager runs."""
    cfg = port_gpt.GPTConfig(vocab_size=512, hidden_size=128, num_layers=2,
                             num_heads=2, intermediate_size=256,
                             max_position=64, seq_len=64)
    main, start, cfg, loss = _port_program("gpt", dropout=0.1, cfg=cfg)
    arrays = _start_arrays(start, "cuda")
    feeds = _feeds("gpt", cfg)
    first = Executor("cuda")
    first.run_steps(K, main, feed=feeds, fetch_list=[loss],
                    scope=load_numpy(Scope(), arrays, "cuda"))
    assert first.stats["captures"] == 1
    freed_while_capturing = []
    holder = _Cycle()
    holder.exe = first
    weakref.finalize(holder, lambda: freed_while_capturing.append(
        torch.cuda.is_current_stream_capturing()))
    del first, holder
    thresholds = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        cap = Executor("cuda")
        b = load_numpy(Scope(), arrays, "cuda")
        stacked, = cap.run_steps(K, main, feed=feeds, fetch_list=[loss],
                                 scope=b)
    finally:
        gc.set_threshold(*thresholds)
    assert freed_while_capturing == [False]
    assert cap.stats["captures"] == 1 and cap.stats["eager_steps"] == 0
    eager, a = Executor("cuda"), load_numpy(Scope(), arrays, "cuda")
    runs = [eager.run(main, feed={"tokens": feeds["tokens"][j]},
                      fetch_list=[loss], scope=a)[0] for j in range(K)]
    np.testing.assert_array_equal(stacked, np.stack(runs))
