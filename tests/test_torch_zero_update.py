"""PyTorch port, the fused flat-bucket optimizer updates B6-B8
(paddle_tpu_torch/ops/kernels/zero_update.py) held against the JAX
reference's `fused_flat_update` (paddle_tpu/ops/pallas/zero_update.py) on
the CPU.

* The plain versions (the port's dense rules, which are also its
  per-parameter lowerings) against the reference's fused kernel under
  `jax.jit`, run as tests/test_pallas_kernels.py runs it (interpret mode
  on the CPU): sgd, momentum (nesterov + l2_decay, and plain), adam,
  adamw; shapes (256,), (3, 128) and (100003,). Tolerance: 1 ulp
  (`assert_array_max_ulp(maxulp=1)`). The rules are one torch op per jnp
  op in the reference's order; under jit XLA may still round adam's
  parameter update once where the rule rounds twice, which moves one
  element of the 100003 by 1 ulp.
* The wrapper updates the given tensors in place and counts no launch on
  CPU tensors; `supports` gates on op type and a dense floating gradient.
* The CUDA branch (`launch`), driven on CPU tensors with a stand-in
  library that takes every pointer, size and scalar the real one gets and
  redoes the kernel's arithmetic in numpy float32, one rounded operation
  at a time in the order of csrc/zero_update.cu (B8 forms lr_t from the
  LearningRate, Beta1Pow and Beta2Pow pointers itself): bit-identical to
  the plain rule (which is what the card check asserts of the real
  kernel), also at n % 4 != 0 and on buckets that are views one element
  into a larger buffer; one library call per bucket and no `adam_lr_t`.
"""
import ctypes

import numpy as np
import pytest
import torch

import jax

from paddle_tpu.ops.pallas.zero_update import fused_flat_update as ref_fused

from paddle_tpu_torch.ops.kernels import zero_update as zk

ARMS = ["sgd", "momentum_nesterov_l2", "momentum", "adam", "adamw"]
SHAPES = [(256,), (3, 128), (100003,)]


def _case(arm, shape, seed=0):
    """(op_type, numpy ins, attrs) as test_pallas_kernels.py:_opt_case
    builds them."""
    rng = np.random.RandomState(seed)
    op_type = arm.split("_")[0]
    ins = {"Param": [rng.randn(*shape).astype(np.float32)],
           "Grad": [rng.randn(*shape).astype(np.float32)],
           "LearningRate": [np.asarray([1e-3], np.float32)]}
    attrs = {}
    if op_type == "momentum":
        ins["Velocity"] = [rng.randn(*shape).astype(np.float32)]
        attrs = {"mu": 0.9, "use_nesterov": arm != "momentum"}
        if arm != "momentum":
            attrs.update(regularization_method="l2_decay",
                         regularization_coeff=1e-4)
    elif op_type in ("adam", "adamw"):
        ins["Moment1"] = [rng.randn(*shape).astype(np.float32)]
        ins["Moment2"] = [np.abs(rng.randn(*shape)).astype(np.float32)]
        ins["Beta1Pow"] = [np.asarray([0.9 ** 3], np.float32)]
        ins["Beta2Pow"] = [np.asarray([0.999 ** 3], np.float32)]
        if op_type == "adamw":
            attrs = {"coeff": 0.01, "with_decay": True}
    return op_type, ins, attrs


def _torch_ins(ins):
    return {s: [torch.from_numpy(a.copy()) for a in vs]
            for s, vs in ins.items()}


_IN_SLOT = {"ParamOut": "Param", "VelocityOut": "Velocity",
            "Moment1Out": "Moment1", "Moment2Out": "Moment2"}


@pytest.mark.parametrize("shape", SHAPES, ids=["flat", "rolled", "tail"])
@pytest.mark.parametrize("arm", ARMS)
def test_plain_matches_reference_kernel(arm, shape):
    op_type, ins, attrs = _case(arm, shape)
    want = jax.jit(lambda: ref_fused(op_type, ins, attrs))()
    tins = _torch_ins(ins)
    zk.reset_launches()
    got = zk.fused_flat_update(op_type, tins, attrs)
    assert zk.launches == {"zero_sgd": 0, "zero_momentum": 0,
                           "zero_adam": 0}
    assert set(got) == set(_IN_SLOT) & set(want)
    for slot, (out,) in got.items():
        assert out is tins[_IN_SLOT[slot]][0]           # in place
        assert tuple(out.shape) == shape and out.dtype == torch.float32
        np.testing.assert_array_max_ulp(out.numpy(),
                                        np.asarray(want[slot][0]), maxulp=1)


def test_supports_gating():
    _, ins, _ = _case("sgd", (8,))
    tins = _torch_ins(ins)
    assert all(zk.supports(op, tins) for op in zk.FUSED_OPS)
    assert not zk.supports("lamb", tins)
    assert not zk.supports("sgd", dict(tins, Grad=[tins["Grad"][0].int()]))
    assert not zk.supports("sgd", dict(tins, Grad=[object()]))
    with pytest.raises(ValueError, match="no fused kernel"):
        zk.fused_flat_update("lamb", tins, {})


def test_cuda_branch_refuses_what_the_kernels_do_not_take():
    _, ins, _ = _case("adam", (8,))
    meta = {s: [torch.empty(a.shape, device="meta") for a in vs]
            for s, vs in ins.items()}
    with pytest.raises(ValueError, match="one CUDA device"):
        zk.fused_flat_update("adam", meta, {})
    bf16 = dict(meta, Grad=[meta["Grad"][0].bfloat16()])
    with pytest.raises(TypeError, match="float32"):
        zk.fused_flat_update("adam", bf16, {})


# ---------------------------------------------------------------------------
# The CUDA branch with a stand-in library
# ---------------------------------------------------------------------------

def _array(ptr, n):
    """The float32 memory behind a device pointer, as the kernel sees it."""
    return np.ctypeslib.as_array((ctypes.c_float * n).from_address(ptr))


class _StandInLibrary:
    """Records each launch's arguments and redoes csrc/zero_update.cu's
    arithmetic in numpy float32, one rounded operation at a time, in place
    through the pointers."""

    def __init__(self, rc=0):
        self.calls, self.rc = [], rc

    def zero_sgd(self, lr, p, g, n, stream):
        self.calls.append(("zero_sgd", (lr, p, g, n, stream)))
        lr0 = _array(lr, 1)[0]
        pa, ga = _array(p, n), _array(g, n)
        pa[:] = pa - lr0 * ga
        return self.rc

    def zero_momentum(self, lr, p, g, v, n, mu, l2, use_l2, nesterov,
                      stream):
        self.calls.append(("zero_momentum", (lr, p, g, v, n, mu, l2, use_l2,
                                             nesterov, stream)))
        f = np.float32
        lr0 = _array(lr, 1)[0]
        pa, ga, va = _array(p, n), _array(g, n), _array(v, n)
        gi = ga + f(l2) * pa if use_l2 else ga.copy()
        vo = f(mu) * va + gi
        step = gi + f(mu) * vo if nesterov else vo
        pa[:] = pa - lr0 * step
        va[:] = vo
        return self.rc

    def zero_adam(self, lr, b1p, b2p, p, g, m1, m2, n, b1, omb1, b2, omb2,
                  eps, coeff, decay, stream):
        self.calls.append(("zero_adam", (lr, b1p, b2p, p, g, m1, m2, n, b1,
                                         omb1, b2, omb2, eps, coeff, decay,
                                         stream)))
        f = np.float32
        lr0, b1p0, b2p0 = (_array(x, 1)[0] for x in (lr, b1p, b2p))
        # lr_t = (lr * sqrt(1 - b2p)) / (1 - b1p), one f32 rounding each
        lrt0 = f(f(lr0 * np.sqrt(f(f(1) - b2p0))) / f(f(1) - b1p0))
        pa, ga = _array(p, n), _array(g, n)
        m1a, m2a = _array(m1, n), _array(m2, n)
        m1o = f(b1) * m1a + f(omb1) * ga
        m2o = f(b2) * m2a + f(omb2) * (ga * ga)
        po = pa - (lrt0 * m1o) / (np.sqrt(m2o) + f(eps))
        if decay:
            po = po - (lr0 * f(coeff)) * pa
        pa[:], m1a[:], m2a[:] = po, m1o, m2o
        return self.rc

    def zero_update_error_string(self, rc):
        return b"an illegal memory access was encountered"


@pytest.mark.parametrize("arm", ARMS)
def test_cuda_branch_with_stand_in_library(arm):
    op_type, ins, attrs = _case(arm, (1000,), seed=5)
    lib = _StandInLibrary()
    tins = _torch_ins(ins)
    zk.reset_launches()
    got = zk.launch(lib, op_type, tins, attrs, stream=1234)
    (name, args), = lib.calls
    assert name == zk.KERNEL_NAMES[op_type]
    assert zk.launches[name] == 1 and sum(zk.launches.values()) == 1
    assert args[-1] == 1234                              # the given stream
    ptr = lambda s: tins[s][0].data_ptr()               # noqa: E731
    n = 1000
    if op_type == "sgd":
        assert args[:4] == (ptr("LearningRate"), ptr("Param"), ptr("Grad"), n)
    elif op_type == "momentum":
        l2 = arm == "momentum_nesterov_l2"
        assert args[:9] == (ptr("LearningRate"), ptr("Param"), ptr("Grad"),
                            ptr("Velocity"), n, 0.9, 1e-4 if l2 else 0.0,
                            int(l2), int(l2))
    else:
        assert args[:8] == (ptr("LearningRate"), ptr("Beta1Pow"),
                            ptr("Beta2Pow"), ptr("Param"), ptr("Grad"),
                            ptr("Moment1"), ptr("Moment2"), n)
        assert args[8:15] == (0.9, 1 - 0.9, 0.999, 1 - 0.999, 1e-8,
                              0.01 if op_type == "adamw" else 0.0,
                              int(op_type == "adamw"))
    want = zk.fused_flat_update_plain(op_type, _torch_ins(ins), attrs)
    for slot, (out,) in got.items():
        assert out is tins[_IN_SLOT[slot]][0]
        assert torch.equal(out, want[slot][0]), slot     # bit for bit


def _offset_ins(ins, offset):
    """`_torch_ins`, each bucket tensor a view `offset` elements into a
    larger buffer (what the card gets from a bucket that does not start on
    16 bytes)."""
    out = _torch_ins(ins)
    for slot in ("Param", "Grad", "Velocity", "Moment1", "Moment2"):
        if slot in out:
            t = out[slot][0]
            buf = torch.zeros(t.numel() + offset)
            buf[offset:] = t
            out[slot] = [buf[offset:]]
    return out


@pytest.mark.parametrize("n,offset", [(1001, 0), (1003, 1), (1000, 3)],
                         ids=["n_mod4_1", "offset1_n_mod4_3", "offset3"])
@pytest.mark.parametrize("arm", ARMS)
def test_cuda_branch_with_stand_in_library_ragged(arm, n, offset):
    """The launch path at n % 4 != 0 and on offset views: the library gets
    each view's own pointer and element count, and the result is bit for
    bit the plain rule's."""
    op_type, ins, attrs = _case(arm, (n,), seed=7)
    lib = _StandInLibrary()
    tins = _offset_ins(ins, offset)
    assert tins["Param"][0].data_ptr() % 16 == (4 * offset) % 16
    got = zk.launch(lib, op_type, tins, attrs, stream=0)
    (_, args), = lib.calls
    assert tins["Param"][0].data_ptr() in args and n in args
    want = zk.fused_flat_update_plain(op_type, _torch_ins(ins), attrs)
    for slot, (out,) in got.items():
        assert out is tins[_IN_SLOT[slot]][0]
        assert torch.equal(out, want[slot][0]), slot


@pytest.mark.parametrize("arm", ["adam", "adamw"])
def test_cuda_branch_one_launch_per_bucket_without_adam_lr_t(monkeypatch,
                                                             arm):
    """Adam's CUDA branch is one library call per bucket: lr_t is formed in
    the kernel, so `adam_lr_t` (the [1]-tensor ops the plain rule runs) is
    never called there."""
    from paddle_tpu_torch.ops import optimizer_ops
    buckets = [_case(arm, (n,), seed=n) for n in (256, 1000, 77)]
    want = [zk.fused_flat_update_plain(op, _torch_ins(ins), attrs)
            for op, ins, attrs in buckets]

    def no_lr_t(*a):
        raise AssertionError("adam_lr_t called on the CUDA branch")

    monkeypatch.setattr(optimizer_ops, "adam_lr_t", no_lr_t)
    lib = _StandInLibrary()
    zk.reset_launches()
    for (op_type, ins, attrs), w in zip(buckets, want):
        got = zk.launch(lib, op_type, _torch_ins(ins), attrs, stream=0)
        for slot, (out,) in got.items():
            assert torch.equal(out, w[slot][0]), slot
    assert [name for name, _ in lib.calls] == ["zero_adam"] * 3
    assert zk.launches["zero_adam"] == 3


def test_cuda_branch_raises_on_a_failed_launch():
    op_type, ins, attrs = _case("sgd", (16,))
    zk.reset_launches()
    with pytest.raises(RuntimeError, match="zero_sgd launch failed: an "
                       "illegal memory access.*cudaError 700"):
        zk.launch(_StandInLibrary(rc=700), op_type, _torch_ins(ins), attrs,
                  stream=0)
    assert zk.launches["zero_sgd"] == 0
