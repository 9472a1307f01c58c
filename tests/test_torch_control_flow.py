"""PyTorch port, control flow: paddle_tpu_torch's layers/control_flow.py
(the sub-block ops and the LoDTensorArray functions), the executor's
sub-block runner and its capture rules, held against the JAX reference on
the CPU.

* Each of the 8 control-flow op types (`__while__`, `__cond__`,
  `__switch__`, `__scan__`, `create_array`, `array_write`, `array_read`,
  `array_length`), `StaticRNN` and `DynamicRNN`: a program built in both
  packages has the same desc (every block), and runs to the same values
  on the same numpy inputs: integer and bool outputs exactly, f32 within
  rtol 1e-5 / atol 1e-6 (training steps: losses rtol 1e-5, parameters
  atol 1e-5).
* The array edge cases: a data-dependent write past the capacity is
  dropped (the length still reports the index), a read past the end is
  clamped, a build-time index grows the buffer, an array that enters a
  While without a buffer raises the reference's ValueError.
* Eager against captured forms (`LowerCtx.capturing`: every branch run,
  outputs selected on the device) of `cond`, `Switch` and the bounded
  `While`: equal bits. A branch not taken that divides by zero: the eager
  and the captured gradients are the reference's (d/dw = 2).
* An unbounded While in a training program raises a typed error, as the
  reference refuses it; `run_steps` runs a program holding one eagerly
  each step (counted); a Switch case not taken (or run and not selected,
  under capture) leaves a persistable it writes untouched; a random op in
  a loop body draws the same mask every iteration, as the reference's.
"""
import types

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as fluid
from paddle_tpu import layers as ref_layers
from paddle_tpu import optimizer as ref_optimizer
from paddle_tpu.framework import backward as ref_backward
from paddle_tpu.framework import program as ref_program
from paddle_tpu.framework import unique_name as ref_unique_name
from paddle_tpu.framework.scope import Scope as RefScope
from paddle_tpu.initializer import Constant as RefConstant

from paddle_tpu_torch import layers as port_layers
from paddle_tpu_torch import optimizer as port_optimizer
from paddle_tpu_torch.framework import Executor, Scope, errors, load_numpy
from paddle_tpu_torch.framework import backward as port_backward
from paddle_tpu_torch.framework import executor as port_executor
from paddle_tpu_torch.framework import program as port_program
from paddle_tpu_torch.framework import unique_name as port_unique_name
from paddle_tpu_torch.initializer import Constant as PortConstant
from paddle_tpu_torch.ops import registry as port_registry

REF = types.SimpleNamespace(prog=ref_program, names=ref_unique_name,
                            L=ref_layers, opt=ref_optimizer,
                            bw=ref_backward, Constant=RefConstant)
PORT = types.SimpleNamespace(prog=port_program, names=port_unique_name,
                             L=port_layers, opt=port_optimizer,
                             bw=port_backward, Constant=PortConstant)
TOL = dict(rtol=1e-5, atol=1e-6)


def build(ns, fn):
    """(main, startup, fetch vars) of `fn(ns)` in fresh programs."""
    main, start = ns.prog.Program(), ns.prog.Program()
    with ns.prog.program_guard(main, start), ns.names.guard():
        outs = fn(ns)
    return main, start, list(outs) if isinstance(outs, (list, tuple)) \
        else [outs]


def assert_descs_equal(ref, port):
    rd, pd = ref.to_desc(), port.to_desc()
    assert len(pd["blocks"]) == len(rd["blocks"])
    for rb, pb in zip(rd["blocks"], pd["blocks"]):
        for r, p in zip(rb["ops"], pb["ops"]):
            assert p == r, (rb["idx"], r["type"], r, p)
    assert pd == rd


def run_ref(main, start, fetch, feed, steps=1):
    exe, scope = fluid.Executor(), RefScope()
    exe.run(start, scope=scope)
    init = {n: np.asarray(scope.find(n)) for n in scope.local_names()
            if not n.startswith("__")}
    outs = [exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
            for _ in range(steps)]
    return init, outs, scope


def port_step(main, scope, feed, fetch, capturing=False, exe=None):
    """One step of `main` through the executor's step body, in the eager
    form or the captured form (every branch run and selected)."""
    exe = exe or Executor("cpu")
    block = main.global_block()
    env = {n: port_executor._coerce_feed_value(block, n, v, exe.device)
           for n, v in feed.items()}
    ctx = port_registry.LowerCtx(run_seed=0, device="cpu",
                                 capturing=capturing)
    names = [v.name if not isinstance(v, str) else v for v in fetch]
    return [v.detach().numpy().copy() for v in
            exe._step(main, env, scope, ctx, names)]


def assert_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, **TOL)
    else:
        np.testing.assert_array_equal(got, want)


def parity(fn, feed, steps=1):
    """Build `fn` in both packages (descs equal), run `steps` steps of
    each from the reference's startup arrays; fetches agree. Returns the
    port's (main, scope, fetch vars)."""
    rm, rs, rf = build(REF, fn)
    pm, ps, pf = build(PORT, fn)
    assert_descs_equal(rm, pm)
    assert ps.to_desc() == rs.to_desc()
    init, ref_outs, _ = run_ref(rm, rs, rf, feed, steps)
    scope = load_numpy(Scope(), init, "cpu")
    exe = Executor("cpu")
    for want in ref_outs:
        got = exe.run(pm, feed=feed, fetch_list=pf, scope=scope)
        for g, w in zip(got, want):
            assert_close(g, w)
    return pm, scope, pf


# ---------------------------------------------------------------------------
# __while__, while_loop
# ---------------------------------------------------------------------------

def sum_of_squares(ns, bound=None):
    """s = sum_{i < n} (x + i)^2 over an unbounded (or bounded) While."""
    L = ns.L
    x = L.data(name="x", shape=[3], dtype="float32", append_batch_size=False)
    n = L.data(name="n", shape=[1], dtype="int64", append_batch_size=False)
    i = L.fill_constant([1], "int64", 0)
    s = L.fill_constant([3], "float32", 0.0)
    flag = L.less_than(i, n)
    w = L.While(flag, bound=bound)
    with w.block():
        xi = x + L.cast(i, "float32")
        L.assign(s + xi * xi, s)
        L.increment(i)
        L.less_than(i, n, cond=flag)
    return s, i


@pytest.mark.parametrize("bound", [None, 8])
def test_while_sum_of_squares(bound):
    feed = {"x": np.array([0.5, -1.0, 2.0], np.float32),
            "n": np.array([5], np.int64)}
    pm, scope, (s, i) = parity(lambda ns: sum_of_squares(ns, bound), feed)
    got_s, got_i = Executor("cpu").run(pm, feed=feed, fetch_list=[s, i],
                                       scope=scope)
    want = sum((feed["x"] + k) ** 2 for k in range(5))
    np.testing.assert_allclose(got_s, want, rtol=1e-6)
    assert int(got_i[0]) == 5
    assert port_executor._host_synced(pm) == (bound is None)
    op = [o for o in pm.global_block().ops if o.type == "__while__"][0]
    assert op.attrs["trip_bound"] == (bound or 0)


def test_while_loop():
    def fn(ns):
        L = ns.L
        x = L.data(name="x", shape=[4], dtype="float32",
                   append_batch_size=False)
        i = L.fill_constant([1], "int32", 0)
        ten = L.fill_constant([1], "int32", 7)
        i, x2 = L.while_loop(lambda i, v: L.less_than(i, ten),
                             lambda i, v: [i + 1, v * 1.5 + 1.0], [i, x])
        return i, x2
    feed = {"x": np.array([1.0, -2.0, 0.25, 3.0], np.float32)}
    pm, scope, (i, x2) = parity(fn, feed)
    got_i, got_x = Executor("cpu").run(pm, feed=feed, fetch_list=[i, x2],
                                       scope=scope)
    want = feed["x"].copy()
    for _ in range(7):
        want = want * 1.5 + 1.0
    assert int(got_i[0]) == 7
    np.testing.assert_allclose(got_x, want, rtol=1e-6)


# ---------------------------------------------------------------------------
# __cond__, __switch__
# ---------------------------------------------------------------------------

def cond_program(ns):
    L = ns.L
    x = L.data(name="x", shape=[3], dtype="float32", append_batch_size=False)
    p = L.data(name="p", shape=[1], dtype="float32", append_batch_size=False)
    zero = L.fill_constant([1], "float32", 0.0)
    out = L.cond(L.greater_than(p, zero), lambda: L.tanh(x) * 2.0,
                 lambda: L.exp(x) - 1.0)
    return out


@pytest.mark.parametrize("pred", [1.0, -1.0])
def test_cond_each_branch_and_captured_form(pred):
    feed = {"x": np.array([0.3, -0.7, 1.1], np.float32),
            "p": np.array([pred], np.float32)}
    pm, scope, (out,) = parity(cond_program, feed)
    eager = port_step(pm, scope, feed, [out])
    captured = port_step(pm, scope, feed, [out], capturing=True)
    assert np.array_equal(eager[0], captured[0])
    want = np.tanh(feed["x"]) * 2 if pred > 0 else np.exp(feed["x"]) - 1
    np.testing.assert_allclose(eager[0], want, rtol=1e-6)


def switch_program(ns):
    """Three cases over a step counter and a default; the var each case
    writes is a persistable (an LR-schedule's shape)."""
    L = ns.L
    step = L.data(name="step", shape=[1], dtype="float32",
                  append_batch_size=False)
    lr = L.create_global_var([1], 0.5, "float32", persistable=True,
                             name="lr")
    other = L.create_global_var([1], 7.0, "float32", persistable=True,
                                name="other")
    b1 = L.fill_constant([1], "float32", 10.0)
    b2 = L.fill_constant([1], "float32", 20.0)
    with L.Switch() as sw:
        with sw.case(L.less_than(step, b1)):
            L.assign(step * 0.01, lr)
        with sw.case(L.less_than(step, b2)):
            L.assign(L.fill_constant([1], "float32", 0.1), lr)
            L.assign(L.fill_constant([1], "float32", -1.0), other)
        with sw.default():
            L.assign(L.fill_constant([1], "float32", 0.01), lr)
    return lr, other


@pytest.mark.parametrize("step", [3.0, 12.0, 25.0])
def test_switch_each_case_and_captured_form(step):
    feed = {"step": np.array([step], np.float32)}
    pm, scope, (lr, other) = parity(switch_program, feed)
    assert [o.type for o in pm.global_block().ops].count("__switch__") == 1
    eager = port_step(pm, scope, feed, [lr, other])
    captured = port_step(pm, scope, feed, [lr, other], capturing=True)
    for e, c in zip(eager, captured):
        assert np.array_equal(e, c)
    want = step * 0.01 if step < 10 else 0.1 if step < 20 else 0.01
    np.testing.assert_allclose(eager[0], [want], rtol=1e-6)


@pytest.mark.parametrize("capturing", [False, True])
def test_switch_case_not_taken_leaves_its_persistable(capturing):
    """Case 2 writes `other`; at step 3 case 1 is taken: `other` keeps its
    value (under capture case 2 runs too, and its write stays in the
    sub-block's env), and the scope's tensor is the same object."""
    main, start, (lr, other) = build(PORT, switch_program)
    scope, exe = Scope(), Executor("cpu")
    exe.run(start, scope=scope)
    before = scope.find("other")
    port_step(main, scope, {"step": np.array([3.0], np.float32)}, [lr],
              capturing=capturing, exe=exe)
    assert scope.find("other") is before
    assert scope.numpy("other").tolist() == [7.0]
    assert scope.numpy("lr").tolist() == pytest.approx([0.03])


def guarded_program(ns):
    """y = 2w where p >= 0, else 1/w; loss = sum(y); w a parameter at
    0."""
    L = ns.L
    p = L.data(name="p", shape=[1], dtype="float32", append_batch_size=False)
    w = L.create_parameter([3], "float32", name="w",
                           default_initializer=ns.Constant(0.0))
    zero = L.fill_constant([1], "float32", 0.0)
    one = L.fill_constant([3], "float32", 1.0)
    y = L.cond(L.greater_equal(p, zero), lambda: w * 2.0,
               lambda: L.elementwise_div(one, w))
    loss = L.reduce_sum(y)
    ns.bw.append_backward(loss)
    return loss, "w@GRAD"


def test_cond_gradient_through_a_branch_not_taken():
    """The taken branch is 2w at w = 0; the other divides by zero. The
    reference's lax.cond and the port's eager form differentiate the taken
    branch only: d/dw = 2. The captured form runs both and selects with
    `where`; the branch not taken sees its inputs cut from the gradient,
    so its infinite derivative adds nothing and the captured gradient is
    the reference's too."""
    rm, rs, rf = build(REF, guarded_program)
    pm, ps, pf = build(PORT, guarded_program)
    assert_descs_equal(rm, pm)
    feed = {"p": np.array([1.0], np.float32)}
    init, (ref_out,), _ = run_ref(rm, rs, rf, feed)
    np.testing.assert_array_equal(ref_out[1], [2.0, 2.0, 2.0])
    scope = load_numpy(Scope(), init, "cpu")
    eager = port_step(pm, scope, feed, pf)
    np.testing.assert_array_equal(eager[1], ref_out[1])
    captured = port_step(pm, scope, feed, pf, capturing=True)
    assert captured[0] == eager[0]
    np.testing.assert_array_equal(captured[1], ref_out[1])


def guarded_switch_program(ns):
    """out = 2w where p < 0, else (the default) 1/w; loss = sum(out); w a
    parameter at 0."""
    L = ns.L
    p = L.data(name="p", shape=[1], dtype="float32", append_batch_size=False)
    w = L.create_parameter([3], "float32", name="w",
                           default_initializer=ns.Constant(0.0))
    out = w * 0.0
    zero = L.fill_constant([1], "float32", 0.0)
    one = L.fill_constant([3], "float32", 1.0)
    with L.Switch() as sw:
        with sw.case(L.less_than(p, zero)):
            L.assign(w * 2.0, out)
        with sw.default():
            L.assign(L.elementwise_div(one, w), out)
    loss = L.reduce_sum(out)
    ns.bw.append_backward(loss)
    return loss, "w@GRAD"


def test_switch_gradient_through_a_case_not_taken():
    """The Switch's counterpart of the cond test: the case taken is 2w at
    w = 0, the default not taken divides by zero. Eager and captured
    forms give the reference's d/dw = 2 (the captured one gave NaN before
    each case's inputs were cut from the gradient where it is not the
    case taken)."""
    rm, rs, rf = build(REF, guarded_switch_program)
    pm, ps, pf = build(PORT, guarded_switch_program)
    assert_descs_equal(rm, pm)
    feed = {"p": np.array([-1.0], np.float32)}
    init, (ref_out,), _ = run_ref(rm, rs, rf, feed)
    np.testing.assert_array_equal(ref_out[1], [2.0, 2.0, 2.0])
    scope = load_numpy(Scope(), init, "cpu")
    for capturing in (False, True):
        got = port_step(pm, scope, feed, pf, capturing=capturing)
        assert got[0] == ref_out[0]
        np.testing.assert_array_equal(got[1], ref_out[1])


# ---------------------------------------------------------------------------
# arrays
# ---------------------------------------------------------------------------

def array_program(ns):
    """Writes at build-time indices 0, 1 and 200 (past the default 128
    slots: the buffer grows), a data-dependent write at `i` into a
    4-slot array and reads at build-time and data-dependent indices."""
    L = ns.L
    a = L.data(name="a", shape=[2], dtype="float32", append_batch_size=False)
    i = L.data(name="i", shape=[1], dtype="int64", append_batch_size=False)
    j = L.data(name="j", shape=[1], dtype="int64", append_batch_size=False)
    arr = L.create_array("float32")
    L.array_write(a, L.fill_constant([1], "int64", 0), array=arr)
    L.array_write(a * 2.0, L.fill_constant([1], "int64", 1), array=arr)
    L.array_write(a * 3.0, L.fill_constant([1], "int64", 200), array=arr)
    small = L.create_array("float32", capacity=4)
    L.array_write(a + 1.0, L.fill_constant([1], "int64", 0), array=small,
                  capacity=4)
    L.array_write(a + 5.0, i, array=small, capacity=4)
    r1 = L.array_read(arr, L.fill_constant([1], "int64", 1))
    r200 = L.array_read(arr, L.fill_constant([1], "int64", 200))
    rj = L.array_read(small, j)
    return (r1, r200, rj, L.array_length(arr), L.array_length(small))


@pytest.mark.parametrize("i,j", [(2, 2), (6, 9), (3, -1)])
def test_array_write_read_length(i, j):
    """(2, 2): an in-range write and read; (6, 9): the write at 6 of 4
    slots is dropped (length 7) and the read at 9 clamped to slot 3;
    (3, -1): a negative read counts from the end."""
    feed = {"a": np.array([1.5, -2.0], np.float32),
            "i": np.array([i], np.int64), "j": np.array([j], np.int64)}
    pm, scope, outs = parity(array_program, feed)
    r1, r200, rj, n_arr, n_small = Executor("cpu").run(
        pm, feed=feed, fetch_list=outs, scope=scope)
    np.testing.assert_array_equal(r1, feed["a"] * 2)
    np.testing.assert_array_equal(r200, feed["a"] * 3)
    assert n_arr.tolist() == [201]
    assert n_small.tolist() == [max(1, i + 1)]
    slots = {0: feed["a"] + 1}
    if i < 4:
        slots[i] = feed["a"] + 5
    want = slots.get(min(j % 4 if j < 0 else j, 3), np.zeros(2))
    np.testing.assert_array_equal(rj, want)
    # the buffer grew for the write at 200: 256 slots
    writes = [o for o in pm.global_block().ops if o.type == "array_write"]
    assert writes[2].attrs["capacity"] == 256


def test_unmaterialised_array_in_a_while_raises():
    def fn(ns):
        L = ns.L
        arr = L.create_array("float32")
        i = L.fill_constant([1], "int64", 0)
        n = L.fill_constant([1], "int64", 3)
        flag = L.less_than(i, n)
        w = L.While(flag)
        with w.block():
            L.array_write(L.fill_constant([2], "float32", 1.0), i,
                          array=arr)
            L.increment(i)
            L.less_than(i, n, cond=flag)
        return L.array_length(arr)
    rm, rs, rf = build(REF, fn)
    pm, ps, pf = build(PORT, fn)
    assert_descs_equal(rm, pm)
    with pytest.raises(ValueError, match="un-materialized"):
        run_ref(rm, rs, rf, {})
    with pytest.raises(ValueError, match="un-materialized"):
        Executor("cpu").run(pm, fetch_list=pf, scope=Scope())


def test_array_with_element_shape_in_a_while():
    """create_array(element_shape=) makes the buffer at once, so the
    first write may be inside the loop; the array itself fetches as its
    buffer."""
    def fn(ns):
        L = ns.L
        x = L.data(name="x", shape=[2], dtype="float32",
                   append_batch_size=False)
        arr = L.create_array("float32", capacity=8, element_shape=[2])
        i = L.fill_constant([1], "int64", 0)
        n = L.fill_constant([1], "int64", 5)
        flag = L.less_than(i, n)
        w = L.While(flag)
        with w.block():
            L.array_write(x * L.cast(i, "float32"), i, array=arr)
            L.increment(i)
            L.less_than(i, n, cond=flag)
        out, _ = L.tensor_array_to_tensor(arr, axis=0, use_stack=True)
        return out, L.array_length(arr), arr
    feed = {"x": np.array([1.0, -0.5], np.float32)}
    rm, rs, rf = build(REF, fn)
    pm, ps, pf = build(PORT, fn)
    assert_descs_equal(rm, pm)
    _, (ref_out,), _ = run_ref(rm, rs, rf[:2], feed)
    got, length, buf = Executor("cpu").run(pm, feed=feed, fetch_list=pf,
                                           scope=Scope())
    assert_close(got, ref_out[0])
    assert_close(length, ref_out[1])
    want = np.zeros((8, 2), np.float32)
    want[:5] = feed["x"][None] * np.arange(5)[:, None]
    np.testing.assert_array_equal(got, want)
    assert length.tolist() == [5]
    # a fetched array comes back as its buffer
    np.testing.assert_array_equal(buf, want)


# ---------------------------------------------------------------------------
# StaticRNN, DynamicRNN
# ---------------------------------------------------------------------------

def static_rnn_program(ns):
    L = ns.L
    x = L.data(name="x", shape=[5, 4, 3], dtype="float32",
               append_batch_size=False)           # [seq, batch, d]
    label = L.data(name="label", shape=[4, 6], dtype="float32",
                   append_batch_size=False)
    rnn = L.StaticRNN()
    with rnn.step():
        x_t = rnn.step_input(x)
        h_prev = rnn.memory(shape=[-1, 6], batch_ref=x_t,
                            ref_batch_dim_idx=0)
        h = L.fc(L.concat([x_t, h_prev], axis=1), 6, act="tanh")
        rnn.update_memory(h_prev, h)
        rnn.step_output(h)
    out = rnn()                                      # [seq, batch, 6]
    last = L.reshape(L.slice(out, axes=[0], starts=[4], ends=[5]), [4, 6])
    loss = L.mean(L.square_error_cost(last, label))
    ns.opt.Adam(learning_rate=1e-2).minimize(loss)
    return loss, out


def test_static_rnn_trains_as_the_reference():
    rng = np.random.RandomState(0)
    feed = {"x": rng.randn(5, 4, 3).astype(np.float32),
            "label": rng.randn(4, 6).astype(np.float32)}
    pm, scope, _ = parity(static_rnn_program, feed, steps=3)
    assert [o.type for o in pm.global_block().ops].count("__scan__") == 1
    assert any(o.type == "__vjp__" and o.attrs["fwd_type"] == "__scan__"
               for o in pm.global_block().ops)


def drnn_program(ns):
    """DynamicRNN of a tanh cell over ragged lengths, Adam on the mean of
    its outputs."""
    L = ns.L
    x = L.data(name="x", shape=[5, 3], dtype="float32")
    lens = L.data(name="lens", shape=[1], dtype="int64")
    drnn = L.DynamicRNN()
    with drnn.block():
        step = drnn.step_input(x, length=lens)
        prev = drnn.memory(shape=[6], value=0.0)
        h = L.fc(L.concat([step, prev], axis=1), 6, act="tanh")
        drnn.update_memory(prev, h)
        drnn.output(h)
    out = drnn()
    loss = L.mean(out)
    ns.opt.Adam(learning_rate=1e-2).minimize(loss)
    return loss, out


def drnn_feed():
    rng = np.random.RandomState(0)
    return {"x": rng.randn(4, 5, 3).astype(np.float32),
            "lens": np.array([[3], [5], [1], [4]], np.int64)}


def test_dynamic_rnn_trains_as_the_reference():
    """Descs (2 blocks) equal; 3 Adam steps agree; the outputs are zero
    past each length; the parameters read inside the loop body get their
    gradients from the __while__ op's grad op (nonzero)."""
    feed = drnn_feed()
    pm, scope, (loss, out) = parity(drnn_program, feed, steps=3)
    assert len(pm.blocks) == 2
    got, = Executor("cpu").run(pm, feed=feed, fetch_list=[out], scope=scope)
    for r, n in enumerate(feed["lens"][:, 0]):
        assert not got[r, n:].any()
    wop = [o for o in pm.global_block().ops if o.type == "__while__"][0]
    assert wop.attrs["trip_bound"] == 5
    # the cell's fc is built inside the body: its parameters are Free
    # inputs of the loop
    params = {p.name for p in pm.all_parameters()}
    assert params and params <= set(wop.inputs["Free"])
    vjp = [o for o in pm.global_block().ops if o.type == "__vjp__"
           and o.attrs["fwd_type"] == "__while__"][0]
    grads = [n for n in vjp.outputs["IG:Free"] if n != "@EMPTY@"]
    assert grads
    vals = Executor("cpu").run(pm, feed=feed, fetch_list=grads, scope=scope)
    assert all(np.abs(v).sum() > 0 for v in vals)


def test_bounded_while_captured_form_and_run_steps_bitwise():
    """The DynamicRNN step in the captured form equals the eager form bit
    for bit, and run_steps(3) equals 3 run() calls."""
    rm, rs, _ = build(REF, drnn_program)
    init, _, _ = run_ref(rm, rs, [], drnn_feed(), steps=0)
    pm, _, (loss, out) = build(PORT, drnn_program)
    feed = drnn_feed()
    a, b = (load_numpy(Scope(), init, "cpu") for _ in range(2))
    eager = [port_step(pm, a, feed, [loss, out]) for _ in range(2)]
    captured = [port_step(pm, b, feed, [loss, out], capturing=True)
                for _ in range(2)]
    for e, c in zip(eager, captured):
        assert all(np.array_equal(x, y) for x, y in zip(e, c))
    c, d = (load_numpy(Scope(), init, "cpu") for _ in range(2))
    exe = Executor("cpu")
    runs = [exe.run(pm, feed=feed, fetch_list=[loss], scope=c)[0]
            for _ in range(3)]
    stacked, = exe.run_steps(3, pm, feed=feed, fetch_list=[loss], scope=d)
    assert np.array_equal(np.stack(runs), stacked)
    for n in init:
        assert np.array_equal(c.numpy(n), d.numpy(n)), n


# ---------------------------------------------------------------------------
# the unbounded While: no gradient, no capture
# ---------------------------------------------------------------------------

def unbounded_training(ns):
    L = ns.L
    x = L.data(name="x", shape=[3], dtype="float32", append_batch_size=False)
    w = L.create_parameter([3], "float32", name="w",
                           default_initializer=ns.Constant(0.5))
    i = L.fill_constant([1], "int64", 0)
    n = L.fill_constant([1], "int64", 3)
    h = L.assign(x)
    flag = L.less_than(i, n)
    loop = L.While(flag)
    with loop.block():
        L.assign(L.tanh(h * w), h)
        L.increment(i)
        L.less_than(i, n, cond=flag)
    loss = L.mean(h)
    ns.opt.SGD(learning_rate=0.1).minimize(loss)
    return loss


def test_unbounded_while_training_raises_typed():
    feed = {"x": np.array([0.1, 0.2, 0.3], np.float32)}
    rm, rs, rf = build(REF, unbounded_training)
    pm, ps, pf = build(PORT, unbounded_training)
    assert_descs_equal(rm, pm)
    with pytest.raises(Exception, match="[Rr]everse-mode"):
        run_ref(rm, rs, rf, feed)
    scope, exe = Scope(), Executor("cpu")
    exe.run(ps, scope=scope)
    with pytest.raises(errors.UnimplementedError, match="unbounded While"):
        exe.run(pm, feed=feed, fetch_list=pf, scope=scope)


def test_run_steps_runs_an_unbounded_while_eagerly():
    """An inference program holding an unbounded While: run_steps(3) runs
    the step body 3 times (no capture) and equals 3 run() calls."""
    main, _, (s, i) = build(PORT, sum_of_squares)
    exe = Executor("cpu")
    feeds = {"x": np.stack([np.full(3, k, np.float32) for k in range(3)]),
             "n": np.array([[2], [4], [3]], np.int64)}
    got_s, got_i = exe.run_steps(3, main, feed=feeds, fetch_list=[s, i],
                                 scope=Scope())
    assert exe.stats["eager_steps"] == 3 and exe.stats["captures"] == 0
    assert got_i[:, 0].tolist() == [2, 4, 3]
    for k in range(3):
        want = exe.run(main, feed={n: v[k] for n, v in feeds.items()},
                       fetch_list=[s], scope=Scope())[0]
        assert np.array_equal(got_s[k], want)


@pytest.mark.cuda
def test_run_steps_runs_an_unbounded_while_eagerly_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run_steps captures only there")
    main, _, (s, i) = build(PORT, sum_of_squares)
    exe = Executor("cuda")
    feeds = {"x": np.ones((3, 3), np.float32),
             "n": np.array([[2], [4], [3]], np.int64)}
    _, got_i = exe.run_steps(3, main, feed=feeds, fetch_list=[s, i],
                             scope=Scope())
    assert exe.stats["eager_steps"] == 3 and exe.stats["captures"] == 0
    assert got_i[:, 0].tolist() == [2, 4, 3]


# ---------------------------------------------------------------------------
# randomness in a loop body, the desc round trip
# ---------------------------------------------------------------------------

def test_dropout_in_a_loop_body_draws_one_mask():
    """Every iteration of a bounded While sees the same run key, as the
    reference hands each iteration the same key: a dropout inside the body
    draws the same mask each time."""
    def fn(ns):
        L = ns.L
        ones = L.fill_constant([64], "float32", 1.0)
        arr = L.create_array("float32", capacity=4, element_shape=[64])
        i = L.fill_constant([1], "int64", 0)
        n = L.fill_constant([1], "int64", 4)
        flag = L.less_than(i, n)
        w = L.While(flag, bound=4)
        with w.block():
            L.array_write(L.dropout(ones, 0.5), i, array=arr)
            L.increment(i)
            L.less_than(i, n, cond=flag)
        out, _ = L.tensor_array_to_tensor(arr, axis=0, use_stack=True)
        return out
    main, start, (out,) = build(PORT, fn)
    got, = Executor("cpu").run(main, fetch_list=[out], scope=Scope())
    assert 0 < (got[0] == 0).sum() < 64
    assert all(np.array_equal(got[k], got[0]) for k in range(4))


def test_multi_block_desc_round_trips():
    """The reference's DynamicRNN desc loads in the port with every block,
    its parent and the ops' block indices as they were; `clone` keeps
    them."""
    rm, _, _ = build(REF, drnn_program)
    desc = rm.to_desc()
    prog = port_program.Program.from_desc(desc)
    assert prog.to_desc() == desc
    assert [b.parent_idx for b in prog.blocks] == [-1, 0]
    assert prog.current_block_idx == 0
    test_prog = prog.clone(for_test=True)
    assert len(test_prog.blocks) == 2
    wop = [o for o in test_prog.global_block().ops if o.type == "__while__"]
    assert wop[0].attrs["sub_block"] == 1
    assert test_prog.blocks[1].to_desc() == prog.blocks[1].to_desc()
    p = port_program.Program()
    sub = p.create_block()
    assert (sub.idx, sub.parent_idx, p.current_block_idx) == (1, 0, 1)
    p.rollback()
    assert p.current_block_idx == 0
