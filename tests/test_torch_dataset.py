"""PyTorch port, the training data path from files: the MultiSlot data plane
(`paddle_tpu_torch/native/dataplane.{cc,py}`), fluid.dataset
(`paddle_tpu_torch/dataset.py`) and `Executor.train_from_dataset`, held
against the reference's on the same files, modelled on the reference's
tests/test_data_pipeline.py.

* The planes: the port's C++ plane (built here with g++) and its Python
  plane give the same batches as each other and as the reference's
  planes, streaming and in memory; with a seeded `local_shuffle` the
  port's C++ plane gives the reference's C++ plane's order and the port's
  Python plane the reference's Python plane's (one loader thread: the
  reference's in-memory order with more depends on thread timing; the
  port's is file order at any thread count, checked at 4).
* fluid.dataset: InMemoryDataset and QueueDataset of both packages yield
  the same feed dicts in the same order for one seed; sizes and
  release_memory; global_shuffle across processes raises.
* `train_from_dataset` trains GPT-tiny (f32, dropout off) from an
  InMemoryDataset at `steps_per_loop` 1 and 3 (7 batches: two groups and
  a tail): the last loss and the parameters match the reference's
  train_from_dataset on the same files within rtol 1e-5 / atol 1e-5 (the
  frameworks sum in other orders); inside the port, grouped == ungrouped
  == run_steps / run on the same batches, bit for bit, and nothing stays
  staged.
* The producer: its error is raised on the calling thread; a failed step
  stops and joins it; a fast producer with a slow consumer ends; PS and
  LocalSGD programs raise naming their ROADMAP items; a pipeline
  (microbatch) program trains step by step, equal to run() bit for bit.
"""
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.fluid as fluid
from paddle_tpu import dataset as ref_dataset
from paddle_tpu.framework import program as ref_program
from paddle_tpu.framework import unique_name as ref_unique_name
from paddle_tpu.framework.scope import Scope as RefScope
from paddle_tpu.models import gpt as ref_gpt
from paddle_tpu.native import dataplane as ref_dataplane

from paddle_tpu_torch import dataset as port_dataset
from paddle_tpu_torch import layers as port_layers
from paddle_tpu_torch import optimizer as port_optimizer
from paddle_tpu_torch.framework import Executor, Scope, errors, load_numpy
from paddle_tpu_torch.initializer import TruncatedNormal
from paddle_tpu_torch.layer_helper import ParamAttr
from paddle_tpu_torch.framework import program as port_program
from paddle_tpu_torch.framework import unique_name as port_unique_name
from paddle_tpu_torch.models import gpt as port_gpt
from paddle_tpu_torch.native import dataplane as port_dataplane

SEQ, BATCH = 32, 4


def _write_multislot(tmp_path, n_files=3, rows=10):
    """Each row: a dense float slot of dim 2 (v, v/2) and an id slot of
    dim 3 (v, v+1, v+2), v the row's global index; one row per file has 5
    ids (truncated to 3) and one 2 (padded with 0)."""
    paths = []
    for f in range(n_files):
        p = tmp_path / f"part-{f}"
        with open(p, "w") as fh:
            for i in range(rows):
                v = f * rows + i
                ids = {0: f"5 {v} {v + 1} {v + 2} 7 8",
                       1: f"2 {v} {v + 1}"}.get(i, f"3 {v} {v + 1} {v + 2}")
                fh.write(f"2 {v} {v / 2} {ids}\n")
        paths.append(str(p))
    return paths


SLOTS = [("x", "float", 2), ("ids", "int64", 3)]


def _batches(plane_cls, slot_cls, paths, batch_size=4, n_threads=1,
             in_memory=False, shuffle_seed=None):
    plane = plane_cls([slot_cls(*s) for s in SLOTS], batch_size,
                      n_threads=n_threads)
    plane.set_files(paths)
    if in_memory:
        plane.load_into_memory()
        if shuffle_seed is not None:
            plane.local_shuffle(shuffle_seed)
    return [{k: np.array(v) for k, v in b.items()} for b in plane], plane


def _py_plane(slots, batch_size, n_threads=1):
    return port_dataplane._PyDataPlane(slots, batch_size)


def _ref_py_plane(slots, batch_size, n_threads=1):
    return ref_dataplane._PyDataPlane(slots, batch_size)


def _assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert set(x) == set(y)
        for k in x:
            assert x[k].dtype == y[k].dtype, k
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


def test_port_plane_is_native_here_and_parses_like_the_python_plane(
        tmp_path):
    paths = _write_multislot(tmp_path)
    native, plane = _batches(port_dataplane.NativeDataPlane,
                             port_dataplane.SlotSpec, paths)
    assert plane.native, "g++ builds the native plane on this host"
    python, _ = _batches(_py_plane, port_dataplane.SlotSpec, paths)
    _assert_same(native, python)
    rows = np.concatenate([b["x"][:, 0] for b in native])
    np.testing.assert_array_equal(rows, np.arange(30, dtype=np.float32))
    ids = np.concatenate([b["ids"] for b in native])
    np.testing.assert_array_equal(ids[0], [0, 1, 2])       # truncated
    np.testing.assert_array_equal(ids[1], [1, 2, 0])       # padded
    assert [len(b["x"]) for b in native] == [4] * 7 + [2]


@pytest.mark.parametrize("n_threads", [1, 4])
def test_in_memory_planes_match_without_shuffle(tmp_path, n_threads):
    paths = _write_multislot(tmp_path)
    native, plane = _batches(port_dataplane.NativeDataPlane,
                             port_dataplane.SlotSpec, paths,
                             n_threads=n_threads, in_memory=True)
    assert plane.memory_size() == 30
    python, _ = _batches(_py_plane, port_dataplane.SlotSpec, paths,
                         in_memory=True)
    _assert_same(native, python)
    ref, _ = _batches(ref_dataplane.NativeDataPlane, ref_dataplane.SlotSpec,
                      paths, in_memory=True)
    _assert_same(native, ref)
    plane.release_memory()
    assert plane.memory_size() == 0


@pytest.mark.parametrize("seed", [1, 7])
def test_seeded_shuffle_orders_match_the_reference(tmp_path, seed):
    paths = _write_multislot(tmp_path)
    kw = dict(in_memory=True, shuffle_seed=seed)
    native, _ = _batches(port_dataplane.NativeDataPlane,
                         port_dataplane.SlotSpec, paths, **kw)
    ref_native, _ = _batches(ref_dataplane.NativeDataPlane,
                             ref_dataplane.SlotSpec, paths, **kw)
    _assert_same(native, ref_native)
    four, _ = _batches(port_dataplane.NativeDataPlane,
                       port_dataplane.SlotSpec, paths, n_threads=4, **kw)
    _assert_same(native, four)
    python, _ = _batches(_py_plane, port_dataplane.SlotSpec, paths, **kw)
    ref_python, _ = _batches(_ref_py_plane, ref_dataplane.SlotSpec, paths,
                             **kw)
    _assert_same(python, ref_python)
    rows = np.concatenate([b["x"][:, 0] for b in native])
    assert sorted(rows.tolist()) == list(range(30))
    assert rows.tolist() != list(range(30))


def _port_vars():
    main, start = port_program.Program(), port_program.Program()
    with port_program.program_guard(main, start), port_unique_name.guard():
        x = port_layers.data(name="x", shape=[2], dtype="float32")
        ids = port_layers.data(name="ids", shape=[3], dtype="int64")
    return [x, ids]


def _ref_vars():
    main, start = ref_program.Program(), ref_program.Program()
    with ref_program.program_guard(main, start), ref_unique_name.guard():
        x = fluid.layers.data(name="x", shape=[2], dtype="float32")
        ids = fluid.layers.data(name="ids", shape=[3], dtype="int64")
    return [x, ids]


def _dataset(module, kind, use_vars, paths, thread=1, shuffles=1):
    ds = module.DatasetFactory().create_dataset(kind)
    ds.set_batch_size(4)
    ds.set_thread(thread)
    ds.set_use_var(use_vars)
    ds.set_filelist(paths)
    if kind == "InMemoryDataset":
        ds.load_into_memory()
        for _ in range(shuffles):
            ds.local_shuffle()
    return ds


@pytest.mark.parametrize("shuffles", [0, 1, 2])
def test_in_memory_dataset_matches_the_reference(tmp_path, shuffles):
    paths = _write_multislot(tmp_path)
    got = list(_dataset(port_dataset, "InMemoryDataset", _port_vars(),
                        paths, shuffles=shuffles))
    want = list(_dataset(ref_dataset, "InMemoryDataset", _ref_vars(),
                         paths, shuffles=shuffles))
    _assert_same(got, want)
    assert got[0]["x"].shape == (4, 2) and got[0]["ids"].shape == (4, 3)
    # a second epoch serves the same memory in the same order
    ds = _dataset(port_dataset, "InMemoryDataset", _port_vars(), paths,
                  thread=4, shuffles=shuffles)
    assert ds.plane.native
    _assert_same(list(ds), got)
    _assert_same(list(ds), got)
    assert ds.get_memory_data_size() == ds.get_shuffle_data_size() == 30
    ds.release_memory()
    assert ds.get_memory_data_size() == 0
    # under fleet, global_shuffle takes the reference's rank-mixed seed
    # (rank 0 here; tests/test_torch_divergence.py runs launched ranks)
    ds = _dataset(port_dataset, "InMemoryDataset", _port_vars(), paths,
                  shuffles=shuffles)
    ds.global_shuffle(fleet=_WorkerZero())
    ref = _dataset(ref_dataset, "InMemoryDataset", _ref_vars(), paths,
                   shuffles=shuffles)
    ref.global_shuffle()
    _assert_same(list(ds), list(ref))


class _WorkerZero:
    def worker_index(self):
        return 0


def test_queue_dataset_streams_like_the_reference(tmp_path):
    paths = _write_multislot(tmp_path)
    got = list(_dataset(port_dataset, "QueueDataset", _port_vars(), paths))
    want = list(_dataset(ref_dataset, "QueueDataset", _ref_vars(), paths))
    _assert_same(got, want)
    d = port_dataset.DatasetFactory().create_dataset("QueueDataset")
    assert d.desc()["batch_size"] == 1
    with pytest.raises(ValueError, match="unknown dataset class"):
        port_dataset.DatasetFactory().create_dataset("Nope")


# ---------------------------------------------------------------------------
# train_from_dataset on GPT-tiny
# ---------------------------------------------------------------------------

def _token_files(tmp_path, n_batches=7, seed=0):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, 512, (n_batches * BATCH, SEQ))
    p = tmp_path / "tokens-0"
    with open(p, "w") as fh:
        for row in toks:
            fh.write(f"{SEQ} " + " ".join(map(str, row)) + "\n")
    return [str(p)], toks


def _ref_gpt():
    main, start = ref_program.Program(), ref_program.Program()
    with ref_program.program_guard(main, start), ref_unique_name.guard():
        cfg = ref_gpt.GPTConfig.tiny()
        tokens, loss = ref_gpt.build_lm_program(cfg)
        paddle.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return main, start, tokens, loss


def _port_gpt():
    main, start = port_program.Program(), port_program.Program()
    with port_program.program_guard(main, start), port_unique_name.guard():
        cfg = port_gpt.GPTConfig.tiny()
        tokens, loss = port_gpt.build_lm_program(cfg)
        port_optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return main, start, tokens, loss


@pytest.fixture(scope="module")
def gpt_init():
    main, start, _, _ = _ref_gpt()
    scope = RefScope()
    fluid.Executor().run(start, scope=scope)
    return {n: np.asarray(scope.find(n)) for n in scope.local_names()
            if not n.startswith("__")}


PARAMS = ("wte", "dec0_attn_qkv_w", "dec1_ffn_out_w", "final_ln_scale")


@pytest.mark.parametrize("steps_per_loop", [1, 3])
def test_train_from_dataset_matches_the_reference(tmp_path, gpt_init,
                                                  steps_per_loop):
    paths, _ = _token_files(tmp_path)
    rmain, _, rtokens, rloss = _ref_gpt()
    rscope = RefScope()
    for n, a in gpt_init.items():
        rscope.set(n, a)
    rds = _dataset(ref_dataset, "InMemoryDataset", [rtokens], paths)
    want = fluid.Executor().train_from_dataset(
        rmain, rds, scope=rscope, fetch_list=[rloss],
        steps_per_loop=steps_per_loop)
    main, _, tokens, loss = _port_gpt()
    scope = load_numpy(Scope(), gpt_init, "cpu")
    ds = _dataset(port_dataset, "InMemoryDataset", [tokens], paths,
                  thread=2)
    exe = Executor("cpu")
    got = exe.train_from_dataset(main, ds, scope=scope, fetch_list=[loss],
                                 steps_per_loop=steps_per_loop)
    np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=1e-5)
    for n in PARAMS:
        np.testing.assert_allclose(scope.numpy(n), np.asarray(rscope.find(n)),
                                   rtol=1e-5, atol=1e-5, err_msg=n)
    assert scope.find("__rng_state__") == 7
    assert not exe._staged
    # 7 batches: two windows of 3 and one run() at steps_per_loop 3
    assert exe.stats["eager_steps"] == 7


def test_grouped_training_equals_run_steps_and_run_bitwise(tmp_path,
                                                           gpt_init):
    """steps_per_loop 3 over 7 batches == run_steps(3) twice then one run()
    on the same batches, and == steps_per_loop 1, bit for bit (on the CPU
    run_steps runs the step body eagerly; on the card the same equality
    holds for the captured step, chip_smoke.py's data phase)."""
    paths, toks = _token_files(tmp_path)
    main, _, tokens, loss = _port_gpt()
    ds = _dataset(port_dataset, "InMemoryDataset", [tokens], paths)
    batches = [b["tokens"] for b in ds]
    assert len(batches) == 7
    exe = Executor("cpu")
    scopes = [load_numpy(Scope(), gpt_init, "cpu") for _ in range(3)]
    g3 = exe.train_from_dataset(main, ds, scope=scopes[0],
                                fetch_list=[loss], steps_per_loop=3)
    g1 = exe.train_from_dataset(main, ds, scope=scopes[1],
                                fetch_list=[loss])
    for w in range(2):
        exe.run_steps(3, main, feed={"tokens": np.stack(
            batches[3 * w:3 * w + 3])}, fetch_list=[loss], scope=scopes[2])
    last, = exe.run(main, feed={"tokens": batches[6]}, fetch_list=[loss],
                    scope=scopes[2])
    np.testing.assert_array_equal(g3[0], last)
    np.testing.assert_array_equal(g1[0], last)
    for n in PARAMS:
        assert torch.equal(scopes[0].find(n), scopes[2].find(n)), n
        assert torch.equal(scopes[1].find(n), scopes[2].find(n)), n


def _tiny_program():
    main, start = port_program.Program(), port_program.Program()
    with port_program.program_guard(main, start), port_unique_name.guard():
        x = port_layers.data(name="px", shape=[2], dtype="float32")
        # pins px's trailing dim to 2
        h = port_layers.fc(x, 3, param_attr=ParamAttr(
            initializer=TruncatedNormal(0.0, 0.5)))
        out = port_layers.mean(h)
    exe = Executor("cpu")
    scope = Scope()
    exe.run(start, scope=scope)
    return main, out, exe, scope


def test_producer_error_is_raised_on_the_calling_thread():
    main, out, exe, scope = _tiny_program()

    class BadDataset:
        def __iter__(self):
            yield {"px": np.zeros((1, 2), np.float32)}
            raise RuntimeError("corrupt record at byte 42")

    with pytest.raises(RuntimeError, match="corrupt record"):
        exe.train_from_dataset(main, BadDataset(), scope=scope,
                               fetch_list=[out])
    assert not exe._staged


def test_failed_step_does_not_leak_the_producer():
    main, out, exe, scope = _tiny_program()

    class EndlessDataset:
        def __iter__(self):
            yield {"px": np.zeros((1, 2), np.float32)}    # fine
            while True:
                # a wrong trailing dim: the fc's product fails
                yield {"px": np.zeros((1, 5), np.float32)}

    with pytest.raises(Exception):
        exe.train_from_dataset(main, EndlessDataset(), scope=scope,
                               fetch_list=[out], steps_per_loop=2)
    for t in threading.enumerate():
        assert not (t.name == "dataplane-prefetch" and t.is_alive()), \
            "prefetch thread leaked"
    assert not exe._staged


def test_fast_producer_with_a_slow_consumer_terminates():
    """The producer finishing while the bounded queue is full must not
    lose the end sentinel."""
    main, out, exe, scope = _tiny_program()
    real_run = exe.run

    def slow_run(*a, **kw):
        time.sleep(0.02)
        return real_run(*a, **kw)

    exe.run = slow_run

    class FastDataset:
        def __iter__(self):
            for i in range(12):
                yield {"px": np.full((1, 2), float(i), np.float32)}

    done = []
    t = threading.Thread(target=lambda: done.append(exe.train_from_dataset(
        main, FastDataset(), scope=scope, fetch_list=[out])), daemon=True)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive(), "train_from_dataset deadlocked"
    want, = real_run(main, feed={"px": np.full((1, 2), 11.0, np.float32)},
                     fetch_list=[out], scope=scope)
    np.testing.assert_array_equal(done[0][0], want)


def _microbatch_runs_step_by_step():
    """A PipelineOptimizer program (2 microbatches, SGD) through
    train_from_dataset at steps_per_loop 3 equals run() on the same 4
    batches, bit for bit: a pipeline step is not grouped."""
    main, start = port_program.Program(), port_program.Program()
    with port_program.program_guard(main, start), port_unique_name.guard():
        x = port_layers.data(name="px", shape=[2], dtype="float32")
        h = port_layers.fc(x, 3, param_attr=ParamAttr(
            name="w", initializer=TruncatedNormal(0.0, 0.5)))
        out = port_layers.mean(h)
        port_optimizer.PipelineOptimizer(
            port_optimizer.SGD(learning_rate=0.1),
            num_microbatches=2).minimize(out)
    exe, sa, sb = Executor("cpu"), Scope(), Scope()
    exe.run(start, scope=sa)
    for n in sa.local_names():
        v = sa.find(n)
        sb.set(n, v.clone() if isinstance(v, torch.Tensor) else v)
    feeds = [{"px": np.random.RandomState(i).rand(4, 2).astype(np.float32)}
             for i in range(4)]
    eager = exe.stats["eager_steps"]
    got = exe.train_from_dataset(main, feeds, scope=sa, fetch_list=[out],
                                 steps_per_loop=3)
    assert exe.stats["eager_steps"] - eager == len(feeds)
    for f in feeds:
        want = exe.run(main, feed=f, fetch_list=[out], scope=sb)
    np.testing.assert_array_equal(got[0], want[0])
    assert torch.equal(sa.find("w"), sb.find("w"))
    assert exe.stats["graph_replays"] == 0


@pytest.mark.parametrize("attr,item", [("_ps_hooks", "19.2"),
                                       ("_microbatch_k", "16"),
                                       ("_localsgd_k", "15.1")])
def test_unported_program_kinds_raise_naming_their_item(attr, item):
    if attr == "_microbatch_k":
        # ported: a pipeline program trains from a dataset step by step
        _microbatch_runs_step_by_step()
        return
    main, out, exe, scope = _tiny_program()
    setattr(main, attr, [object()] if attr == "_ps_hooks" else 2)
    with pytest.raises(errors.UnimplementedError, match=f"item {item}"):
        exe.train_from_dataset(main, [{"px": np.zeros((1, 2), np.float32)}],
                               scope=scope, fetch_list=[out])
    with pytest.raises(errors.InvalidArgumentError):
        exe.train_from_dataset(main, None)


def test_infer_from_dataset_runs_one_step_per_batch():
    main, out, exe, scope = _tiny_program()
    feeds = [{"px": np.full((2, 2), float(i), np.float32)} for i in range(3)]
    res = exe.infer_from_dataset(main, feeds, scope=scope, fetch_list=[out])
    want, = exe.run(main, feed=feeds[-1], fetch_list=[out], scope=scope)
    np.testing.assert_array_equal(res[0], want)
    assert exe.train_from_dataset(main, [], scope=scope,
                                  fetch_list=[out]) is None
