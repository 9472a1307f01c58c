"""Fused paged-attention decode: the CUDA kernel's wrapper, its plain
version and its launch counter.

Counterpart of paddle_tpu/ops/pallas/paged_attention.py
(`fused_paged_attention` :188, kernels `_paged_decode_kernel` :98 and
`_paged_decode_kernel_int8` :145). The kernel source, with its design and
bound, is paddle_tpu_torch/csrc/paged_attention.cu: a split over positions
(flash-decoding) in chunks of `paged_decode_chunk()` positions, each
writing a partial (o, m, l) to a scratch buffer, then a merge in chunk
order.

* On CUDA tensors `fused_paged_attention` launches both passes on the
  current stream (the serving loop runs on its own thread, so the stream
  is read at each call) or raises. There is no fallback: head dims other
  than 64 and 128, and pools not on 16 bytes, are refused.
* On CPU tensors it runs `paged_attention_plain`, the gather + dense
  attend that ops/paged_ops.paged_attend computes. The plain version is
  also the yardstick the kernel is held against on the card.
* `launches` counts wrapper calls that launched the kernel, per kernel
  name; it moves only where a kernel is launched. A CUDA graph that
  captured wrapper calls launches the kernels again at each replay
  without calling the wrapper: its owner captures inside
  `capture_launches()`, which records the launches made on the capturing
  thread into a dict of its own instead of counting them, and adds that
  dict at every replay (`count_replay`). Several engines capture and
  replay from their own threads at once: a capture never touches
  `launches`, and every update of it holds one lock, so no thread's
  counts are lost or taken by another.
"""
from __future__ import annotations

import contextlib
import ctypes
import math
import threading

import torch

_INT8_MAX_RANGE = 127.0
_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# the CUDA kernel behind each pool dtype, by the name `launches` counts
KERNEL_NAMES = {torch.float32: "paged_decode_f32",
                torch.bfloat16: "paged_decode_bf16",
                torch.int8: "paged_decode_int8"}
launches = {name: 0 for name in KERNEL_NAMES.values()}
# the query dtypes each pool dtype's kernel is built for: a float pool takes
# its own dtype, and a bf16 pool also an f32 query (the int8-weight serving
# arm computes in f32 against a bf16 pool, as the reference does); the
# context comes back in the pool dtype (f32 for int8 pools)
QUERY_DTYPES = {torch.float32: (torch.float32,),
                torch.bfloat16: (torch.bfloat16, torch.float32),
                torch.int8: (torch.float32, torch.bfloat16)}
_count_lock = threading.Lock()
_recorder = threading.local()      # .counts: the capture under way here
# the head dims the kernel is built for (csrc/paged_attention.cu launch_hd)
HEAD_DIMS = (64, 128)

_lib = None


def reset_launches():
    with _count_lock:
        for name in launches:
            launches[name] = 0


@contextlib.contextmanager
def capture_launches():
    """Within the block, the launches made on THIS thread are recorded
    into the dict it yields ({kernel name: n}) instead of counted: a graph
    capture records kernels without running them. Other threads go on
    counting into `launches`."""
    rec = dict.fromkeys(launches, 0)
    outer = getattr(_recorder, "counts", None)
    _recorder.counts = rec
    try:
        yield rec
    finally:
        _recorder.counts = outer


def _count(name: str):
    rec = getattr(_recorder, "counts", None)
    if rec is not None:
        rec[name] += 1
        return
    with _count_lock:
        launches[name] += 1


def count_replay(delta):
    """Count the launches of one replay of a graph whose capture recorded
    `delta` (from `capture_launches`)."""
    with _count_lock:
        for name, n in delta.items():
            launches[name] += n


def kv_dequant_scale(kv_scale) -> float:
    """The int8-KV dequant multiplier c = kv_scale / 127. Both read paths
    fold it outside the contractions: scores = dot(q, f32(K)) * (scale*c),
    ctx = dot(probs, f32(V)) * c, so int8 -> f32 is an exact convert."""
    return float(kv_scale) / _INT8_MAX_RANGE


def paged_attention_plain(q, k_pool, v_pool, page_table, pos, *,
                          block_size: int, layer: int = 0, scale=None,
                          max_blocks=None, kv_scale=None):
    """Gather + dense attend (ops/paged_ops.paged_attend), with the
    wrapper's signature."""
    from ..paged_ops import paged_attend
    return paged_attend(q, k_pool, v_pool, page_table, pos, block_size,
                        layer=layer, scale=scale, max_blocks=max_blocks,
                        kv_scale=kv_scale)


def _library():
    global _lib
    if _lib is None:
        from . import _build
        lib = _build.load("paged_attention")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.paged_decode.argtypes = [p] * 7 + [i] * 10 + [f, f, p]
        lib.paged_decode.restype = i
        lib.paged_decode_error_string.argtypes = [i]
        lib.paged_decode_error_string.restype = ctypes.c_char_p
        lib.paged_decode_chunk.argtypes = []
        lib.paged_decode_chunk.restype = i
        _lib = lib
    return _lib


def _check(q, k_pool, v_pool, page_table, pos, block_size, layer,
           kv_scale):
    if q.dim() != 4 or q.shape[2] != 1:
        raise ValueError(f"decode kernel takes a single query token "
                         f"[B, nh, 1, hd], got q {tuple(q.shape)}")
    b, nh, _, hd = q.shape
    if k_pool.dim() != 5 or k_pool.shape != v_pool.shape:
        raise ValueError(f"pools must be two [L, NB, nh, bs, hd] tensors, "
                         f"got {tuple(k_pool.shape)} / {tuple(v_pool.shape)}")
    L, _, pnh, pbs, phd = k_pool.shape
    if (pnh, phd) != (nh, hd):
        raise ValueError(f"pool heads/head_dim {(pnh, phd)} != query "
                         f"{(nh, hd)}")
    if pbs != int(block_size):
        raise ValueError(f"pool block dim {pbs} != block_size {block_size}")
    if not 0 <= int(layer) < L:
        raise ValueError(f"layer {layer} outside the pool's {L} layers")
    if page_table.dim() != 2 or page_table.shape[0] != b:
        raise ValueError(f"page_table must be [B={b}, MB], got "
                         f"{tuple(page_table.shape)}")
    if pos.shape != (b,):
        raise ValueError(f"pos must be [B={b}], got {tuple(pos.shape)}")
    if (kv_scale is None) != (k_pool.dtype != torch.int8):
        raise ValueError("int8 pools need kv_scale (and only int8 do)")


def launch_args(lib, q, k_pool, v_pool, page_table, pos, *,
                block_size: int, layer: int = 0, scale=None,
                max_blocks=None, kv_scale=None):
    """The kernel's arguments for one call, all but the stream, after the
    checks the kernel needs; and the tensors they point into that the
    caller keeps: the context `out` [B, nh, 1, hd] and the scratch `part`
    [B·nh, n_chunks, hd + 2] f32, n_chunks = ceil(walk·bs / P) for the
    library's chunk of P positions. Allocates with torch.empty on the
    tensors' device. The shape checks are `_check`'s."""
    kv_dtype = k_pool.dtype
    if kv_dtype not in KERNEL_NAMES or v_pool.dtype != kv_dtype:
        raise TypeError(f"pools must both be float32, bfloat16 or int8, "
                        f"got {k_pool.dtype} / {v_pool.dtype}")
    if q.dtype not in QUERY_DTYPES[kv_dtype]:
        raise TypeError(f"query dtype {q.dtype} does not go with "
                        f"{kv_dtype} pools (they take "
                        f"{[str(d) for d in QUERY_DTYPES[kv_dtype]]})")
    if page_table.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError(f"page_table and pos must be int32, got "
                        f"{page_table.dtype} / {pos.dtype}")
    tensors = (q, k_pool, v_pool, page_table, pos)
    for name, t in zip(("q", "k_pool", "v_pool", "page_table", "pos"),
                       tensors):
        if not t.is_contiguous():
            raise ValueError(f"fused_paged_attention: {name} must be "
                             f"contiguous")
    b, nh, _, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"the paged decode kernel is built for head dims "
                         f"{HEAD_DIMS}, got {hd}")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if t.data_ptr() % 16:
            raise ValueError(f"fused_paged_attention: {name} does not start "
                             f"on 16 bytes (the kernel reads rows with "
                             f"16-byte loads)")
    _, nb, _, bs, _ = k_pool.shape
    mb = page_table.shape[1]
    walk = mb if max_blocks is None else max(1, min(mb, int(max_blocks)))
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    if kv_scale is None:
        score_scale, ctx_scale = float(scale), 1.0
    else:
        c = kv_dequant_scale(kv_scale)
        score_scale, ctx_scale = float(scale) * c, c
    n_chunks = -(-walk * bs // lib.paged_decode_chunk())
    dev = q.device
    part = torch.empty((b * nh, n_chunks, hd + 2), dtype=torch.float32,
                       device=dev)
    out_dtype = torch.float32 if kv_dtype == torch.int8 else kv_dtype
    out = torch.empty((b, nh, 1, hd), dtype=out_dtype, device=dev)
    args = (q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            page_table.data_ptr(), pos.data_ptr(), part.data_ptr(),
            out.data_ptr(), _KIND[kv_dtype], _KIND[q.dtype], b, nh, hd, nb,
            bs, mb, int(layer), walk, score_scale, ctx_scale)
    return args, out, part


def call(lib, args, stream):
    """One launch of both passes on `stream` with `launch_args`' args;
    raises if the library reports an error. Counts nothing."""
    rc = lib.paged_decode(*args, stream)
    if rc != 0:
        raise RuntimeError(
            f"paged_decode launch failed: "
            f"{lib.paged_decode_error_string(rc).decode()} (cudaError {rc})")


def launch(lib, q, k_pool, v_pool, page_table, pos, *, stream,
           **kw):
    """The kernel's branch of `fused_paged_attention` with library `lib`
    on `stream`: allocate, launch, count. Returns the context."""
    args, out, _part = launch_args(lib, q, k_pool, v_pool, page_table, pos,
                                   **kw)
    call(lib, args, stream)
    _count(KERNEL_NAMES[k_pool.dtype])
    return out


def fused_paged_attention(q, k_pool, v_pool, page_table, pos, *,
                          block_size: int, layer: int = 0, scale=None,
                          max_blocks=None, kv_scale=None):
    """Fused single-token paged attention.

    q [B, nh, 1, hd] (a dtype of `QUERY_DTYPES[pool dtype]`);
    k_pool/v_pool [L, NB, nh, bs, hd] (f32 / bf16, or int8 with
    `kv_scale`); page_table [B, MB] int32; pos [B] int32. Returns the
    context [B, nh, 1, hd] in the pool dtype (f32 for int8 pools).
    `max_blocks` bounds the page-table walk; the kernel also stops
    at each slot's write frontier pos // bs."""
    _check(q, k_pool, v_pool, page_table, pos, block_size, layer, kv_scale)
    kw = dict(block_size=block_size, layer=layer, scale=scale,
              max_blocks=max_blocks, kv_scale=kv_scale)
    tensors = (q, k_pool, v_pool, page_table, pos)
    if all(t.device.type == "cpu" for t in tensors):
        return paged_attention_plain(q, k_pool, v_pool, page_table, pos,
                                     **kw)
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"fused_paged_attention: all tensors must be on "
                         f"one CUDA device (or all on the CPU), got "
                         f"{[str(t.device) for t in tensors]}")
    with torch.cuda.device(dev):
        return launch(_library(), q, k_pool, v_pool, page_table, pos,
                      stream=torch.cuda.current_stream(dev).cuda_stream,
                      **kw)
