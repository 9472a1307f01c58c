"""PyTorch port, layer scan: parallel/transforms.py `apply_layer_scan` and
the `__layer_scan__` op with its reverse-loop gradient, reached directly
and through fleet's `layer_scan` strategy, held against the JAX reference
on the CPU.

* The rolled GPT-tiny and BERT-tiny programs (fleet `layer_scan`, alone
  and with `recompute`) equal the reference's rolled programs desc for
  desc, main and startup (the `stack` op), and the reference's rolled
  desc round-trips through the port's `Program.from_desc`;
  `clone(for_test)` sets `is_test` inside the scan's `sub_ops`, at every
  depth, as the reference's clone does.
* 3 Adam steps of the port's rolled program from the reference's startup
  arrays against the reference's rolled program, with and without
  `remat`: the reference's tolerance (tests/test_layer_scan.py `TOL`,
  rtol 1e-5 / atol 1e-7) on the losses, rtol 1e-5 / atol 1e-6 on every
  persistable (`PARAM_TOL` says why).
* Inside the port, dropout 0.1: rolled equals unrolled bit for bit, the
  losses and every layer's row of every stacked parameter, with and
  without `remat`, in f32 and under fleet AMP bf16.
* Each fallback returns None and leaves the program as it was, as the
  reference's does: unequal spacing, non-isomorphic segments, a
  persistable written inside a segment, a value of the rolled region read
  outside it, two carried vars and, under pp, segments on different
  `device_guard` stages.
* `FLAGS_layer_scan` rolls like the strategy knob; with `recompute` the
  consumed interior boundaries leave the recompute checkpoints.
* Checkpoints: an unrolled checkpoint loads into the rolled program (the
  next run restacks it, `copy_`'d into the bound `@LAYERS` tensor, and
  the per-layer entries leave the scope), and the rolled program's file
  round-trips.
* With `remat` the reverse loop keeps one layer's intermediates alive at
  a time (`transforms.scan_stats`: the layers whose pullbacks are alive),
  L without it.
"""
import os

import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu.fluid as fluid
from paddle_tpu import flags as ref_flags
from paddle_tpu import initializer as ref_init
from paddle_tpu.distributed import fleet as ref_fleet
from paddle_tpu.framework import program as ref_program
from paddle_tpu.framework import unique_name as ref_unique_name
from paddle_tpu.framework.scope import Scope as RefScope
from paddle_tpu.models import bert as ref_bert
from paddle_tpu.models import gpt as ref_gpt
from paddle_tpu.parallel import transforms as ref_transforms

from paddle_tpu_torch import flags as port_flags
from paddle_tpu_torch import initializer as port_init
from paddle_tpu_torch import io as port_io
from paddle_tpu_torch import layers as port_layers
from paddle_tpu_torch import optimizer as port_optimizer
from paddle_tpu_torch.distributed import fleet as port_fleet
from paddle_tpu_torch.framework import Executor, Scope, load_numpy
from paddle_tpu_torch.framework import program as port_program
from paddle_tpu_torch.framework import unique_name as port_unique_name
from paddle_tpu_torch.layer_helper import ParamAttr as PortParamAttr
from paddle_tpu_torch.models import bert as port_bert
from paddle_tpu_torch.models import gpt as port_gpt
from paddle_tpu_torch.parallel import transforms as port_transforms

# the reference's own tolerance for rolled programs (tests/test_layer_scan.py)
TOL = dict(rtol=1e-5, atol=1e-7)
# the persistables across frameworks: the two sum in different orders, and
# Adam's sign-normalised first steps turn a near-zero gradient's last-bit
# difference into a step of up to lr (1e-4): a few elements of a stacked
# weight land ~7e-7 apart (tests/test_torch_gpt_lm.py holds the unrolled
# program at atol 1e-5)
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)
LR, STEPS, BATCH = 1e-4, 3, 2

_PKGS = {
    "ref": dict(prog=ref_program, names=ref_unique_name, gpt=ref_gpt,
                bert=ref_bert, fleet=ref_fleet, opt=paddle.optimizer,
                L=fluid.layers, tr=ref_transforms, guard=fluid.device_guard,
                attr=paddle.ParamAttr, init=ref_init),
    "port": dict(prog=port_program, names=port_unique_name, gpt=port_gpt,
                 bert=port_bert, fleet=port_fleet, opt=port_optimizer,
                 L=port_layers, tr=port_transforms,
                 guard=port_program.device_guard, attr=PortParamAttr,
                 init=port_init),
}


def model_cfg(pkg, model, dropout=0.0, layers=None):
    m = _PKGS[pkg]
    cfg = (m["gpt"].GPTConfig.tiny() if model == "gpt"
           else m["bert"].BertConfig.tiny())
    cfg.hidden_dropout = cfg.attention_dropout = dropout
    if layers:
        cfg.num_layers = layers
    return cfg


def build(pkg, model="gpt", rolled=True, remat=False, amp=False,
          dropout=0.0, layers=None, recompute=True):
    """(main, startup, loss) of `model`-tiny minimised by Adam through
    fleet (buckets off), rolled by the `layer_scan` knob; `remat` turns
    `recompute` on, at the layer boundaries (or, `recompute=False`, with
    no checkpoints: a remat scan alone)."""
    m = _PKGS[pkg]
    main, start = m["prog"].Program(), m["prog"].Program()
    with m["prog"].program_guard(main, start), m["names"].guard():
        cfg = model_cfg(pkg, model, dropout, layers)
        if model == "gpt":
            _, loss = m["gpt"].build_lm_program(cfg)
        else:
            _, _, loss = m["bert"].build_pretrain_program(
                cfg, use_input_mask=True)
        m["fleet"].init(is_collective=True)
        s = m["fleet"].DistributedStrategy()
        s.amp = amp
        s.layer_scan = rolled
        s.fuse_grad_size_in_mb = 0
        if remat:
            s.recompute = True
            s.recompute_configs = {"checkpoints": loss._layer_checkpoints
                                   if recompute else []}
        m["fleet"].distributed_optimizer(
            m["opt"].Adam(learning_rate=LR), s).minimize(loss)
    return main, start, loss


def feeds(model, steps=STEPS, seed=0):
    rng = np.random.RandomState(seed)
    cfg = model_cfg("port", model)
    s = cfg.seq_len
    if model == "gpt":
        return [{"tokens": rng.randint(0, cfg.vocab_size,
                                       (BATCH, s)).astype(np.int64)}
                for _ in range(steps)]
    out = []
    for _ in range(steps):
        lens = rng.randint(s // 2, s + 1, size=(BATCH, 1))
        out.append({
            "input_ids": rng.randint(0, cfg.vocab_size,
                                     (BATCH, s)).astype(np.int64),
            "mlm_labels": rng.randint(0, cfg.vocab_size,
                                      (BATCH, s, 1)).astype(np.int64),
            "input_mask": (np.arange(s)[None] < lens).astype(np.float32)})
    return out


def persistables(main):
    return sorted(v.name for v in main.global_block().vars.values()
                  if v.persistable)


def ref_run(main, start, loss, fs):
    scope = RefScope()
    exe = fluid.Executor()
    exe.run(start, scope=scope)
    init = {n: np.asarray(scope.find(n)) for n in scope.local_names()
            if not n.startswith("__")}
    losses = [float(exe.run(main, feed=f, fetch_list=[loss],
                            scope=scope)[0]) for f in fs]
    return init, losses, {n: np.asarray(scope.find(n), np.float32)
                          for n in persistables(main)}


def port_run(main, loss, fs, init=None, start=None):
    exe, scope = Executor("cpu"), Scope()
    if init is not None:
        load_numpy(scope, init, "cpu")
    else:
        exe.run(start, scope=scope)
    losses = [float(exe.run(main, feed=f, fetch_list=[loss],
                            scope=scope)[0]) for f in fs]
    return losses, scope


def scan_ops(main):
    return [op for op in main.global_block().ops
            if op.type == "__layer_scan__"]


@pytest.mark.parametrize("model,remat", [("gpt", False), ("gpt", True),
                                         ("bert", False)],
                         ids=["gpt", "gpt_recompute", "bert"])
def test_rolled_descs_equal_reference(model, remat):
    rm, rs, _ = build("ref", model, remat=remat, dropout=0.1)
    pm, ps, _ = build("port", model, remat=remat, dropout=0.1)
    assert pm.to_desc() == rm.to_desc()
    assert ps.to_desc() == rs.to_desc()
    assert port_program.Program.from_desc(rm.to_desc()).to_desc() \
        == rm.to_desc()
    assert [op.type for op in ps.global_block().ops].count("stack") \
        == len(pm._layer_stacks)
    if remat:
        # the scan sits inside the prologue segment, with a remat body
        seg = [op for op in pm.global_block().ops
               if op.type == "__segment__"]
        inner = [d for s in seg for d in s.attrs["sub_ops"]
                 if d["type"] == "__layer_scan__"]
        assert len(inner) == 1 and inner[0]["attrs"]["remat"] is True
    else:
        scan, = scan_ops(pm)
        layers = model_cfg("port", model).num_layers
        assert scan.attrs["num_layers"] == layers
        assert any(s is not None and len(s) == layers
                   for s in scan.attrs["layer_seeds"])
    rt, pt = rm.clone(for_test=True), pm.clone(for_test=True)
    assert pt.to_desc() == rt.to_desc()

    def flipped(sub_ops):
        n = 0
        for od in sub_ops:
            if "is_test" in od["attrs"]:
                assert od["attrs"]["is_test"] is True, od["type"]
                n += 1
            n += flipped(od["attrs"].get("sub_ops", []))
        return n
    assert sum(flipped(op.attrs.get("sub_ops", []))
               for op in pt.global_block().ops) > 0


@pytest.mark.parametrize("model,remat", [("gpt", False), ("gpt", True),
                                         ("bert", False), ("bert", True)])
def test_rolled_matches_reference(model, remat):
    fs = feeds(model)
    rm, rs, rloss = build("ref", model, remat=remat)
    init, ref_losses, ref_final = ref_run(rm, rs, rloss, fs)
    pm, _, ploss = build("port", model, remat=remat)
    assert persistables(pm) == sorted(ref_final)
    losses, scope = port_run(pm, ploss, fs, init)
    np.testing.assert_allclose(losses, ref_losses, **TOL)
    for n, want in ref_final.items():
        np.testing.assert_allclose(scope.numpy(n), want, err_msg=n,
                                   **PARAM_TOL)
    stacks = [n for n in init if n.endswith("@LAYERS")]
    assert stacks and all(not np.array_equal(scope.numpy(n), init[n])
                          for n in stacks if n.endswith("_w@LAYERS"))


@pytest.fixture(scope="module")
def unrolled():
    """The unrolled run of (model, amp), shared by the plain and the
    remat arms: its losses and scope after the steps (the same program,
    startup and feeds give the same bits either time)."""
    cache = {}

    def get(model, amp):
        if (model, amp) not in cache:
            um, us, uloss = build("port", model, rolled=False, amp=amp,
                                  dropout=0.1)
            cache[(model, amp)] = port_run(um, uloss, feeds(model), start=us)
        return cache[(model, amp)]
    return get


@pytest.mark.parametrize("model,amp", [("gpt", False), ("gpt", True),
                                       ("bert", False)],
                         ids=["gpt_f32", "gpt_amp_bf16", "bert_f32"])
@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_rolled_equals_unrolled_bitwise(model, amp, remat, unrolled):
    fs = feeds(model)
    u_losses, u_scope = unrolled(model, amp)
    rm, rs, rloss = build("port", model, remat=remat, amp=amp, dropout=0.1,
                          recompute=False)
    assert [op.attrs["remat"] for op in scan_ops(rm)] == [remat]
    r_losses, r_scope = port_run(rm, rloss, fs, start=rs)
    assert r_losses == u_losses
    assert rm._layer_stacks
    for sname, parts in rm._layer_stacks.items():
        stacked = r_scope.numpy(sname)
        for i, p in enumerate(parts):
            assert np.array_equal(stacked[i], u_scope.numpy(p)), (sname, i)
    for n in persistables(rm):
        if not n.endswith("@LAYERS") and "@LAYERS_" not in n:
            assert np.array_equal(r_scope.numpy(n), u_scope.numpy(n)), n


def _fc_stack(pkg, acts, widths=None, guard_stages=None, write_state=False,
              read_inside=False, two_carries=False):
    """x -> fc(8, act) per layer -> fc(1) -> mean; returns (main,
    boundaries) with the variants each fallback needs."""
    m = _PKGS[pkg]
    L = m["L"]
    main, start = m["prog"].Program(), m["prog"].Program()
    with m["prog"].program_guard(main, start), m["names"].guard():
        x = L.data(name="x", shape=[8], dtype="float32")
        h, other, bounds = x, x, []

        def fc(v, act, width=8):
            return L.fc(v, width, act=act, param_attr=m["attr"](
                initializer=m["init"].TruncatedNormal(0.0, 0.5)))
        for i, act in enumerate(acts):
            width = widths[i] if widths else 8
            if guard_stages:
                with m["guard"](f"gpu:{guard_stages[i]}"):
                    h = fc(h, act, width)
            else:
                h = fc(h, act, width)
            if write_state:
                c = L.create_global_var([1], 0.0, "float32",
                                        persistable=True, name=f"c{i}")
                L.increment(c, value=1.0, in_place=True)
            if two_carries:
                other = L.elementwise_add(other, h)
                h = L.elementwise_add(h, other)
            bounds.append(h.name)
        if read_inside:
            h = L.elementwise_add(h, main.global_block().var(
                main.global_block().ops[1].output_names()[0]))
        L.mean(fc(h, None, 1))
    return main, bounds


FALLBACKS = {
    "non_isomorphic": dict(acts=["relu", "relu", None]),
    "unequal_spacing": dict(acts=["relu", None, "relu"]),
    "written_persistable": dict(acts=["relu"] * 3, write_state=True),
    "read_outside": dict(acts=["relu"] * 3, read_inside=True),
    "two_carries": dict(acts=["relu"] * 3, two_carries=True),
    "pp_stage_attrs": dict(acts=["relu"] * 3, guard_stages=[0, 0, 1]),
}


@pytest.mark.parametrize("case", sorted(FALLBACKS))
def test_fallbacks_leave_the_program_untouched(case):
    for pkg in ("ref", "port"):
        main, bounds = _fc_stack(pkg, **FALLBACKS[case])
        before = main.to_desc()
        assert _PKGS[pkg]["tr"].apply_layer_scan(main, bounds) is None, pkg
        assert main.to_desc() == before
        assert not getattr(main, "_layer_stacks", None)
    # the isomorphic stack rolls
    main, bounds = _fc_stack("port", acts=["relu"] * 3)
    assert port_transforms.apply_layer_scan(main, bounds) == bounds[:-1]


def test_flag_rolls_and_recompute_drops_consumed_boundaries():
    port_flags.set_flags({"FLAGS_layer_scan": True})
    ref_flags.set_flags({"FLAGS_layer_scan": True})
    try:
        pm, ps, _ = build("port", rolled=False, remat=True)
        rm, rs, _ = build("ref", rolled=False, remat=True)
    finally:
        port_flags.set_flags({"FLAGS_layer_scan": False})
        ref_flags.set_flags({"FLAGS_layer_scan": False})
    assert pm.to_desc() == rm.to_desc() and ps.to_desc() == rs.to_desc()
    segs = [op for op in pm.global_block().ops if op.type == "__segment__"]
    # the roll consumed every interior boundary: one segment holds the
    # embedding and the scan, the next the head
    inner = [[d["type"] for d in s.attrs["sub_ops"]] for s in segs]
    assert sum(t.count("__layer_scan__") for t in inner) == 1
    assert len(segs) == 2
    assert not scan_ops(pm)
    main, _, _ = build("port", rolled=False)
    assert not scan_ops(main)


def test_checkpoint_round_trip(tmp_path):
    fs = feeds("gpt", steps=2)
    um, us, uloss = build("port", rolled=False)
    exe, u_scope = Executor("cpu"), Scope()
    exe.run(us, scope=u_scope)
    port_io.save_persistables(exe, str(tmp_path), um, scope=u_scope)
    want = float(exe.run(um, feed=fs[0], fetch_list=[uloss],
                         scope=u_scope)[0])

    rm, rs, rloss = build("port")
    exe, scope = Executor("cpu"), Scope()
    exe.run(rs, scope=scope)
    bound = {n: scope.find(n) for n in rm._layer_stacks}
    port_io.load_persistables(exe, str(tmp_path), rm, scope=scope)
    parts = [p for ps in rm._layer_stacks.values() for p in ps]
    assert all(scope.has(p) for p in parts)       # loaded, not yet stacked
    got = float(exe.run(rm, feed=fs[0], fetch_list=[rloss], scope=scope)[0])
    assert got == want
    assert not any(scope.has(p) for p in parts)   # stale entries gone
    for n, t in bound.items():                    # restacked in place
        assert scope.find(n) is t

    d2 = os.path.join(str(tmp_path), "rolled")
    port_io.save_persistables(exe, d2, rm, scope=scope)
    stack = next(iter(rm._layer_stacks))
    before = scope.numpy(stack)
    nxt = float(exe.run(rm, feed=fs[1], fetch_list=[rloss], scope=scope)[0])
    port_io.load_persistables(exe, d2, rm, scope=scope)
    assert np.array_equal(scope.numpy(stack), before)
    again = float(exe.run(rm, feed=fs[1], fetch_list=[rloss], scope=scope)[0])
    assert again == nxt


@pytest.mark.parametrize("remat", [False, True])
def test_remat_keeps_one_layer_alive(remat):
    layers = 4
    main, start, loss = build("port", remat=remat, layers=layers,
                              recompute=False)
    exe, scope = Executor("cpu"), Scope()
    exe.run(start, scope=scope)
    port_transforms.scan_stats(reset=True)
    exe.run(main, feed=feeds("gpt", 1)[0], fetch_list=[loss], scope=scope)
    stats = port_transforms.scan_stats()
    assert stats["live_layers"] == 0
    assert stats["peak_live_layers"] == (1 if remat else layers)


def test_recompute_around_the_scan_runs_its_remat():
    """Fleet recompute puts the scan inside the prologue `__segment__`:
    that segment pairs with its grad op and runs taped, so the scan's own
    remat works inside it (a layer at a time) and its forward runs twice
    a step, not three times."""
    layers = 4
    main, start, loss = build("port", remat=True, layers=layers)
    seg = [op for op in main.global_block().ops if op.type == "__segment__"]
    assert any(d["type"] == "__layer_scan__" for s in seg
               for d in s.attrs["sub_ops"])
    exe, scope = Executor("cpu"), Scope()
    exe.run(start, scope=scope)
    calls = []
    real = port_transforms._Scan.layer
    try:
        port_transforms._Scan.layer = lambda self, i, c: (
            calls.append(i), real(self, i, c))[1]
        port_transforms.scan_stats(reset=True)
        exe.run(main, feed=feeds("gpt", 1)[0], fetch_list=[loss],
                scope=scope)
    finally:
        port_transforms._Scan.layer = real
    # the segment's taped forward (the remat scan keeps its inputs) and
    # the reverse loop's re-run of each layer, taped
    assert calls == list(range(layers))
    # the segment's tape and one layer's
    assert port_transforms.scan_stats()["peak_live_layers"] == 2
