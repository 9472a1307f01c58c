"""Flash attention B1-B3: the CUDA kernels' wrapper, their plain version and
their launch counts.

Counterpart of paddle_tpu/ops/pallas/flash_attention.py (`flash_attention`
:553, custom VJP `_flash` :498, kernels `_flash_fwd_kernel` :145,
`_flash_bwd_dq_kernel` :282, `_flash_bwd_dkdv_kernel` :346). The kernel
source, with its design and bound, is paddle_tpu_torch/csrc/flash_attention.cu.

* On CUDA tensors `flash_attention` launches B1 (forward) on the current
  stream, and its autograd backward launches B2 then B3, or it raises:
  float32/bfloat16 operands, head_dim 64 or 128, any sequence length.
  There is no fallback to a dense path. B2 also writes delta = rowsum(dO *
  O) as a [B*nh, S] f32 buffer that B3 reads in place of O
  (`bwd_delta_plain` is its plain version).
* On CPU tensors it runs `flash_attention_plain`: dense f32 scores, the
  same counter-hash dropout, autograd through plain ops. The plain version
  is also what the kernels are held against on the card.
* On `meta` tensors (build-time shape inference) it returns an empty
  output of the right shape without launching or counting.
* `launches` counts kernel launches per kernel name; it moves only where
  a kernel is launched (inside a CUDA graph capture, at each replay:
  ops/kernels/counts.py).
* Dropout keys each head on its GLOBAL flat index: `keying` = (b_off,
  nh_total, h_off) makes head h of batch row b of this launch the head
  (b_off + b) * nh_total + h_off + h of the hash (the reference's
  `_global_head_ids`, parallel/ring_attention.py:54), so a launch over a
  slice of the heads (tensor parallelism, Ulysses) or of the batch draws
  the bits the whole launch draws there. None is the identity (0, nh, 0):
  the flat b * nh + h.
* The dropout `seed` is an int or a one-element int32 tensor (the uint32
  bits). The kernels read it from device memory, so a captured CUDA graph
  draws the mask of whatever seed was written there before the replay;
  an int handed to a CUDA launch is first written to a fresh device
  tensor. The plain version takes either and draws the same mask.
"""
from __future__ import annotations

import ctypes
import math

import torch
from torch.autograd.function import once_differentiable

from . import counts

KERNEL_NAMES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv")
launches = {name: 0 for name in KERNEL_NAMES}
HEAD_DIMS = (64, 128)
_KIND = {torch.float32: 0, torch.bfloat16: 1}
# head-to-mask mapping of a normalised [Bm, Rm, S] mask (:121-133)
_MASK_MODES = {None: 0, "1": 1, "b": 2, "h": 3, "bh": 4}

# odd constants of the counter-based dropout hash (murmur3 fmix32 mixers)
_H1, _H2, _H3 = 0x85EB_CA6B, 0xC2B2_AE35, 0x9E37_79B9
_U32 = 0xFFFF_FFFF

_lib = None


def reset_launches():
    for name in launches:
        launches[name] = 0


# ---------------------------------------------------------------------------
# The counter-hash dropout mask (reference _keep_mask :73-96)
# ---------------------------------------------------------------------------

def dropout_threshold(rate: float) -> int:
    """A bit is kept when hash >= this: P(keep) = 1 - rate."""
    return min(int(round(rate * 2.0 ** 32)), 2 ** 32 - 1)


def _mul32(a, b: int):
    """(a * b) mod 2**32 for int64 tensors holding uint32 values, without
    overflowing int64: split a into 16-bit halves."""
    lo = (a & 0xFFFF) * b
    hi = (((a >> 16) * b) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _seed_u32(seed):
    """The seed's uint32 bits: an int, or an int64 tensor [] for a seed
    tensor (the int32 bits wrap to uint32 either way)."""
    if isinstance(seed, torch.Tensor):
        return seed.reshape(()).long() & _U32
    return int(seed) & _U32


def keep_mask(seed, head, q_pos, k_pos, rate: float):
    """Bit (q_pos, k_pos) of head `head` (the flattened b*nh + h), kept
    with probability 1 - rate; `head`, `q_pos`, `k_pos` are broadcastable
    int64 tensors of absolute indices. uint32 arithmetic is emulated in
    int64 with & 0xFFFFFFFF; the seed (an int or a one-element tensor on
    the indices' device) wraps to uint32."""
    s = _seed_u32(seed)
    x = _mul32(q_pos, _H1) ^ _mul32(k_pos, _H2) \
        ^ ((s + _mul32(head, _H3)) & _U32)
    x = x ^ (x >> 16)
    x = _mul32(x, _H1)
    x = x ^ (x >> 13)
    x = _mul32(x, _H2)
    x = x ^ (x >> 16)
    return x >= dropout_threshold(rate)


def keying_or_identity(keying, nh):
    """(b_off, nh_total, h_off) as ints; None is the identity (0, nh, 0)."""
    if keying is None:
        return 0, int(nh), 0
    b_off, nh_total, h_off = (int(x) for x in keying)
    if b_off < 0 or h_off < 0 or h_off + nh > nh_total:
        raise ValueError(f"flash keying {keying} does not place {nh} heads "
                         f"inside {nh_total}")
    return b_off, nh_total, h_off


def keyed_heads(b, nh, keying, device):
    """[B, nh, 1, 1] int64: the global flat head each (b, h) keys on."""
    b_off, nh_total, h_off = keying_or_identity(keying, nh)
    bi = torch.arange(b, dtype=torch.int64, device=device) + b_off
    hi = torch.arange(nh, dtype=torch.int64, device=device) + h_off
    return (bi.view(b, 1) * nh_total + hi.view(1, nh)).view(b, nh, 1, 1)


def _dense_keep(seed, b, nh, s, rate, device, keying=None):
    idx = lambda n: torch.arange(n, dtype=torch.int64, device=device)  # noqa
    return keep_mask(seed, keyed_heads(b, nh, keying, device),
                     idx(s).view(s, 1), idx(s).view(1, s), rate)


# ---------------------------------------------------------------------------
# Mask normalisation (reference _normalize_mask :528-550)
# ---------------------------------------------------------------------------

def normalize_mask(mask, b, nh, s):
    """Additive mask broadcastable to [B, nh, S, S] (query dim may be 1) ->
    ([Bm, Rm, S] float32, mode). A key-padding mask [B,1,1,S] stays
    O(B*S)."""
    mask = mask.float()
    while mask.dim() < 4:
        mask = mask.unsqueeze(0)
    if mask.dim() != 4:
        raise ValueError(f"mask rank must be <= 4, got {tuple(mask.shape)}")
    mb, mh, mq, mk = mask.shape
    if mk != s or mb not in (1, b) or mh not in (1, nh) or mq not in (1, s):
        raise ValueError(f"mask {tuple(mask.shape)} not broadcastable to "
                         f"attention [{b},{nh},{s},{s}]")
    if mh == 1:
        return mask[:, 0], ("1" if mb == 1 else "b")
    if mb == 1:
        return mask[0], "h"
    return mask.reshape(b * nh, mq, s), "bh"


def _check(q, k, v, dropout, seed):
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"flash_attention takes q, k, v of one shape "
                         f"[B, nh, S, hd], got {tuple(q.shape)} / "
                         f"{tuple(k.shape)} / {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"flash_attention requires matching q/k/v dtypes, "
                         f"got {q.dtype}/{k.dtype}/{v.dtype}")
    if dropout > 0.0 and seed is None:
        raise ValueError("flash_attention dropout requires a seed")
    if not 0.0 <= dropout < 1.0:
        raise ValueError(f"dropout rate {dropout} outside [0, 1)")


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def flash_attention_plain(q, k, v, scale=None, causal=False, dropout=0.0,
                          seed=None, mask=None, keying=None):
    """Dense attention with the kernels' semantics: f32 scores, additive
    mask, causal -inf, the finite guards for fully masked rows, the counter
    hash dropout after the normaliser, probabilities rounded to V's dtype
    before the product. Autograd runs through plain ops."""
    _check(q, k, v, dropout, seed)
    b, nh, s, hd = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    sc = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        normalize_mask(mask, b, nh, s)            # shape check only
        m4 = mask.float()
        while m4.dim() < 4:
            m4 = m4.unsqueeze(0)
        sc = sc + m4
    if causal:
        pos = torch.arange(s, device=q.device)
        sc = sc.masked_fill(pos.view(1, s) > pos.view(s, 1), float("-inf"))
    m = sc.amax(-1, keepdim=True).detach()
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.where(torch.isfinite(sc), torch.exp(sc - m_safe),
                    torch.zeros((), device=q.device))
    probs = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
    if dropout > 0.0:
        keep = _dense_keep(seed, b, nh, s, dropout, q.device, keying)
        probs = torch.where(keep, probs / (1.0 - dropout),
                            torch.zeros((), device=q.device))
    out = torch.matmul(probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# The CUDA kernels
# ---------------------------------------------------------------------------

def _library():
    global _lib
    if _lib is None:
        from . import _build
        lib = _build.load("flash_attention")
        p, i, f, u = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                      ctypes.c_uint)
        tail = [i, i, u, p, f, i, i, i, p]  # causal, dropout, thresh, seed
        #        pointer, keep_prob, b_off, nh_total, h_off, stream
        lib.flash_fwd.argtypes = [p] * 6 + [i] * 7 + [f] + tail
        lib.flash_bwd_dq.argtypes = [p] * 9 + [i] * 7 + [f] + tail
        lib.flash_bwd_dkdv.argtypes = [p] * 9 + [i] * 7 + [f] + tail
        for fn in (lib.flash_fwd, lib.flash_bwd_dq, lib.flash_bwd_dkdv):
            fn.restype = i
        lib.flash_error_string.argtypes = [i]
        lib.flash_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def _aligned16(t):
    """`t`, or a copy of it where its data does not start on 16 bytes: the
    kernels copy operand rows into shared memory 16 bytes at a time (a
    contiguous view into a larger buffer may start anywhere)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def bwd_delta_plain(o, do):
    """delta = rowsum(f32(dO) * f32(O)) as [B*nh, S] f32: what B2 hands to
    B3 (the reference's `delta`, flash_attention.py:301)."""
    b, nh, s, _ = o.shape
    return (do.float() * o.float()).sum(-1).reshape(b * nh, s)


def _unwrap(t):
    """The plain tensor under one torch.func wrapper: a Function's saved
    tensors come back wrapped (no storage) when torch.func.vjp calls its
    backward, and a kernel needs the device pointer. The kernels' gradients
    are constants to any transform around that one, so a tensor wrapped
    twice (grad of grad) raises instead of losing its derivative."""
    from torch._C._functorch import get_unwrapped, is_functorch_wrapped_tensor
    if t is None or not is_functorch_wrapped_tensor(t):
        return t
    t = get_unwrapped(t)
    if is_functorch_wrapped_tensor(t):
        raise NotImplementedError(
            "flash_attention's backward is first-order only: it cannot run "
            "under nested torch.func transforms")
    return t


def seed_tensor(seed, device):
    """The seed as the one-element int32 device tensor the kernels read:
    a tensor is checked and passed through, an int is written to a fresh
    tensor (not inside a CUDA graph capture: the executor hands tensors)."""
    if isinstance(seed, torch.Tensor):
        if seed.numel() != 1 or seed.dtype != torch.int32 \
                or seed.device != device:
            raise ValueError(f"flash seed tensor must be one int32 element "
                             f"on {device}, got {seed.dtype} "
                             f"{tuple(seed.shape)} on {seed.device}")
        return seed
    s = int(seed) & _U32
    return torch.full((1,), s - (1 << 32) if s >= 1 << 31 else s,
                      dtype=torch.int32, device=device)


def _cfg_args(q, mask, mode, scale, causal, dropout, seed, keying=None):
    """The C arguments after the pointers; `seed` is a device tensor (or
    None without dropout), kept alive by the caller across the launch."""
    b, nh, s, hd = q.shape
    b_off, nh_total, h_off = keying_or_identity(keying, nh)
    return [_KIND[q.dtype], b, nh, s, hd, _MASK_MODES[mode],
            0 if mask is None else mask.shape[1], float(scale), int(causal),
            int(dropout > 0.0),
            dropout_threshold(dropout) if dropout > 0.0 else 0,
            _ptr(seed) if dropout > 0.0 else None, float(1.0 - dropout),
            b_off, nh_total, h_off,
            torch.cuda.current_stream(q.device).cuda_stream]


def _seed_arg(seed, dropout, device):
    return seed_tensor(seed, device) if dropout > 0.0 else None


def _raise_if(rc, name):
    if rc != 0:
        raise RuntimeError(
            f"{name} launch failed: "
            f"{_library().flash_error_string(rc).decode()} (cudaError {rc})")


def launch_fwd(q, k, v, mask, mode, seed, scale, causal, dropout,
               keying=None):
    """B1 alone: (O, lse [B*nh, S] f32). Operands contiguous on one card,
    `mask` normalised (`normalize_mask`) and contiguous, or None."""
    q, k, v = (_aligned16(t) for t in (q, k, v))
    seed = _seed_arg(seed, dropout, q.device)
    b, nh, s, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b * nh, s), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = _library().flash_fwd(
            _ptr(q), _ptr(k), _ptr(v), _ptr(mask), _ptr(o), _ptr(lse),
            *_cfg_args(q, mask, mode, scale, causal, dropout, seed, keying))
    _raise_if(rc, "flash_fwd")
    counts.count(launches, "flash_fwd")
    return o, lse


def launch_bwd_dq(q, k, v, o, lse, do, mask, mode, seed, scale, causal,
                  dropout, keying=None):
    """B2 alone: (dQ, delta [B*nh, S] f32); the autograd backward runs it,
    then B3 on its delta."""
    q, k, v, do = (_aligned16(t) for t in (q, k, v, do))
    seed = _seed_arg(seed, dropout, q.device)
    b, nh, s, _ = q.shape
    dq = torch.empty_like(q)
    delta = torch.empty((b * nh, s), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = _library().flash_bwd_dq(
            _ptr(q), _ptr(k), _ptr(v), _ptr(o), _ptr(do), _ptr(lse),
            _ptr(mask), _ptr(dq), _ptr(delta),
            *_cfg_args(q, mask, mode, scale, causal, dropout, seed, keying))
    _raise_if(rc, "flash_bwd_dq")
    counts.count(launches, "flash_bwd_dq")
    return dq, delta


def launch_bwd_dkdv(q, k, v, delta, lse, do, mask, mode, seed, scale,
                    causal, dropout, keying=None):
    """B3 alone: dK and dV, from B2's delta (O is not read)."""
    q, k, v, do = (_aligned16(t) for t in (q, k, v, do))
    seed = _seed_arg(seed, dropout, q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        rc = _library().flash_bwd_dkdv(
            _ptr(q), _ptr(k), _ptr(v), _ptr(delta), _ptr(do), _ptr(lse),
            _ptr(mask), _ptr(dk), _ptr(dv),
            *_cfg_args(q, mask, mode, scale, causal, dropout, seed, keying))
    _raise_if(rc, "flash_bwd_dkdv")
    counts.count(launches, "flash_bwd_dkdv")
    return dk, dv


class FlashAttention(torch.autograd.Function):
    """B1 forward, B2 + B3 backward (`setup_context` style, no ctx use in
    forward, so torch.func.vjp can trace it). The mask is nondiff: its
    gradient is None (the reference returns a zero cotangent, :521). The
    backward is first-order only: differentiating it again raises. The
    tenth input is the dropout `keying` (None is the identity)."""

    @staticmethod
    def forward(q, k, v, mask, mode, seed, scale, causal, dropout, keying):
        return launch_fwd(q, k, v, mask, mode, seed, scale, causal, dropout,
                          keying)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, mask, mode, seed, scale, causal, dropout, keying = inputs
        o, lse = output
        # a seed tensor is saved like the operands; an int rides in ctx
        is_t = isinstance(seed, torch.Tensor)
        ctx.save_for_backward(q, k, v, o, lse, mask, seed if is_t else None)
        ctx.cfg = (scale, causal, dropout, keying)
        ctx.mode, ctx.int_seed = mode, None if is_t else seed
        ctx.mark_non_differentiable(lse)

    @staticmethod
    @once_differentiable
    def backward(ctx, do, _dlse):
        q, k, v, o, lse, mask, seed = (_unwrap(t)
                                       for t in ctx.saved_tensors)
        seed = ctx.int_seed if seed is None else seed
        do = _unwrap(do).contiguous()
        dq, delta = launch_bwd_dq(q, k, v, o, lse, do, mask, ctx.mode, seed,
                                  *ctx.cfg)
        dk, dv = launch_bwd_dkdv(q, k, v, delta, lse, do, mask, ctx.mode,
                                 seed, *ctx.cfg)
        return (dq, dk, dv) + (None,) * 7


def flash_attention(q, k, v, scale=None, causal=False, dropout=0.0,
                    seed=None, mask=None, keying=None):
    """Tiled attention on [B, nh, S, hd]. `dropout` drops post-softmax
    probabilities with the counter-hash mask keyed on `seed` (an int or a
    one-element int32 tensor on q's device) and on each head's global
    index (`keying`, module docstring);
    `mask` is an additive bias broadcastable to [B, nh, S (or 1), S]."""
    _check(q, k, v, dropout, seed)
    b, nh, s, hd = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    tensors = [t for t in (q, k, v, mask) if t is not None]
    if any(t.device.type == "meta" for t in tensors):
        return torch.empty(q.shape, dtype=q.dtype, device="meta")
    if all(t.device.type == "cpu" for t in tensors):
        return flash_attention_plain(q, k, v, scale=scale, causal=causal,
                                     dropout=dropout, seed=seed, mask=mask,
                                     keying=keying)
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"flash_attention: all tensors must be on one CUDA "
                         f"device (or all on the CPU), got "
                         f"{[str(t.device) for t in tensors]}")
    if q.dtype not in _KIND:
        raise TypeError(f"flash kernels take float32 or bfloat16, got "
                        f"{q.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash kernels take head_dim in {HEAD_DIMS}, got "
                         f"{hd}")
    if s < 1 or b * nh > 65535:
        raise ValueError(f"flash kernels take 1 <= S and B*nh <= 65535, got "
                         f"S={s}, B*nh={b * nh}")
    mode = None
    if mask is not None:
        mask, mode = normalize_mask(mask, b, nh, s)
        mask = mask.contiguous()
    seed = _seed_arg(seed, dropout, dev)
    o, _ = FlashAttention.apply(q.contiguous(), k.contiguous(),
                                v.contiguous(), mask, mode, seed,
                                float(scale), bool(causal), float(dropout),
                                keying_or_identity(keying, nh))
    return o
