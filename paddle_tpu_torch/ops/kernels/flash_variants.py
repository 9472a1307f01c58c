"""Variants of the flash kernels B1-B3, of the fused Adam update B8 and of
the paged decode kernels B4/B5, timed against each other on one card: the
measurements behind PERF.md's account of where their time goes.

    python3 -m paddle_tpu_torch.ops.kernels.flash_variants [name ...]

Each variant is the sources under csrc/ with text substitutions applied
(each must match exactly once). All variants build at once, one nvcc each,
with `_build`'s flags, into build/variants/. Then each is swapped in under
its wrapper and timed with CUDA events at the main path's shapes, the
variants in order and then in reverse, and averaged:

* flash (`VARIANTS`): B1, B2 and B3 at batch 16, 12 heads, S 512,
  head_dim 64, key-padding mask, f32 and bf16, dropout 0.1 and 0; each
  prints its ptxas registers and its max |variant - plain| on O and on the
  gradients, f32 and bf16, at dropout 0.1.
* B8 (`ZERO_VARIANTS`): adam over one flat bucket of 23,440,896 f32
  elements, checked bit for bit against the plain rule.
* B4/B5 (`PAGED_VARIANTS`): the paged decode kernel at the serving kernel
  phase's shapes (batch 8, 12 heads, head_dim 64, block 16, max_len 1024,
  ragged positions) with f32, bf16 and int8 pools (bf16 query), and at the
  bf16 serving run's (max_len 256), the layer cycling over all 12 pool
  layers so K/V come from device memory; each call timed alone (the C
  entry on prepared arguments) in a CUDA graph of the 12-layer cycle
  (`graph_ms`), with its max |variant - plain|.

Some variants are wrong on purpose (no_exp, no_hash, tf32_1x,
paged_no_merge): they show what one part of the kernel costs, not a kernel
to ship.
"""
from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import sys

import numpy as np
import torch

from . import _build
from . import flash_attention as fa
from . import paged_attention as pk
from . import zero_update as zk

CU, H, ZU = "flash_attention.cu", "mma_tile.cuh", "zero_update.cu"
PA = "paged_attention.cu"
# name -> [(file, old text, new text)]
VARIANTS = {
    "base": [],
    # small = x - big rounded to nearest TF32 (ties away) before the product
    "small_rna": [(H, "    small = __float_as_uint(x - __uint_as_float(big));",
                   "    small = rna_tf32(x - __uint_as_float(big));")],
    # big rounded by the cvt instruction instead of two integer ops
    "cvt": [(H, "    return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;",
             "    uint32_t b;\n"
             "    asm(\"cvt.rna.tf32.f32 %0, %1;\\n\" : \"=r\"(b) : \"f\"(x));\n"
             "    return b;")],
    # big truncated: one integer op, small twice as wide
    "trunc_big": [(H, "    big = rna_tf32(x);",
                   "    big = __float_as_uint(x) & 0xFFFFE000u;")],
    # the dropout upscale as a division per element
    "div": [(CU, "dpv * inv_keep : 0.f;\n                s[j][i] = pr",
             "dpv / p.keep_prob : 0.f;\n                s[j][i] = pr"),
            (CU, "? s[j][i] * inv_keep : 0.f;", "? s[j][i] / p.keep_prob : 0.f;"),
            (CU, "& 1u ? dpv * inv_keep : 0.f;", "& 1u ? dpv / p.keep_prob : 0.f;"),
            (CU, "? pr * inv_keep : 0.f;", "? pr / p.keep_prob : 0.f;")],
    # 64-row streamed tiles in B2/B3: the ring takes twice the shared memory
    "bn64": [(CU, "constexpr int BN = 32;", "constexpr int BN = 64;")],
    # 64-row K/V tiles in B1's ring
    "fwd_bn64": [(CU, "constexpr int BNF = 32;", "constexpr int BNF = 64;")],
    # wrong on purpose: one TF32 product instead of three
    "tf32_1x": [(H, "    mma_tf32(c, as, bb[0], bb[1]);\n"
                    "    mma_tf32(c, ab, bs[0], bs[1]);\n", "")],
    # wrong on purpose: no exponential
    "no_exp": [(CU, "exp2f((sc - lse[h]) * kLog2e)", "((sc - lse[h]) * kLog2e)"),
               (CU, "exp2f((sc - (isfinite(l) ? l : 0.f)) * kLog2e)",
                "((sc - (isfinite(l) ? l : 0.f)) * kLog2e)"),
               (CU, "exp2f(s[j][i] - ms[h])", "(s[j][i] - ms[h])")],
    # wrong on purpose: every element kept, no hash
    "no_hash": [(CU, "    return x >= p.thresh;", "    return qpos != 0xFFFFFFFFu;")],
}
ZERO_VARIANTS = {
    "zero_base": [],
    # streaming cache hints on B8's 16-byte loads and stores
    "zero_ldcs": [(ZU, "  return reinterpret_cast<const float4*>(a)[v];",
                   "  return __ldcs(reinterpret_cast<const float4*>(a) + v);"),
                  (ZU, "  reinterpret_cast<float4*>(a)[v] = x;",
                   "  __stcs(reinterpret_cast<float4*>(a) + v, x);")],
    # at most 32 registers, so 8 blocks of 256 threads reside on an SM
    "zero_8_blocks": [(ZU, "__launch_bounds__(kThreads)\n    zero_adam_kernel(",
                       "__launch_bounds__(kThreads, 8)\n    zero_adam_kernel(")],
    # one float4 of each array in flight per thread, not two
    "zero_one_vector": [(ZU, "v += 2 * nt) {\n    const int64_t w = v + nt;\n"
                             "    const bool two = w < nv;",
                         "v += nt) {\n    const int64_t w = v + nt;\n"
                         "    const bool two = false;")],
}
# B4/B5: the chunk length P and the rows each thread has in flight (kRows =
# P / (warps x rows per warp step): 16 for f32, 8 for bf16, 4 for int8 at
# P 128 and 4 warps per 64 head dims)
PAGED_VARIANTS = {
    "paged_base": [],
    "paged_p32": [(PA, "constexpr int kChunk = 128;",
                   "constexpr int kChunk = 32;")],
    "paged_p64": [(PA, "constexpr int kChunk = 128;",
                   "constexpr int kChunk = 64;")],
    # twice the rows in flight per thread (half the warps)
    "paged_2warps": [(PA, "constexpr int kWarps64 = 4;",
                      "constexpr int kWarps64 = 2;")],
    # half the rows in flight per thread (twice the warps)
    "paged_8warps": [(PA, "constexpr int kWarps64 = 4;",
                      "constexpr int kWarps64 = 8;")],
    # wrong on purpose: pass 1 alone, no merge launch
    "paged_no_merge": [(PA, "  paged_decode_kernel_merge<Out, HD><<<batch * nh, HD, 0, stream>>>(\n"
                            "      static_cast<const float*>(part), static_cast<const int*>(pos),\n"
                            "      static_cast<Out*>(out), nh, bs, walk_blocks, n_chunks, ctx_scale);\n",
                        "")],
}
ALL_VARIANTS = {**VARIANTS, **ZERO_VARIANTS, **PAGED_VARIANTS}
SHAPE = (16, 12, 512, 64)
SEED = 1234


def _files(name):
    """The csrc/ files variant `name` compiles: its .cu first."""
    if name in ZERO_VARIANTS:
        return (ZU,)
    return (PA,) if name in PAGED_VARIANTS else (CU, H)


def variant_sources(name):
    """{file name: text} of the csrc/ sources with variant `name`
    applied; raises if a substitution does not match exactly once."""
    texts = {f: (_build.CSRC_DIR / f).read_text() for f in _files(name)}
    for fname, old, new in ALL_VARIANTS[name]:
        n = texts[fname].count(old)
        if n != 1:
            raise ValueError(f"variant {name}: {fname} holds {n} copies of "
                             f"{old[:60]!r}, want 1")
        texts[fname] = texts[fname].replace(old, new)
    return texts


def build(names):
    """{name: (ctypes library, {kernel: registers})}, built at once."""
    root = _build.BUILD_DIR / "variants"
    shutil.rmtree(root, ignore_errors=True)
    procs = {}
    for name in names:
        d = root / name
        d.mkdir(parents=True)
        for fname, text in variant_sources(name).items():
            (d / fname).write_text(text)
        lib = d / "lib.so"
        cmd = [_build.nvcc()] + _build.NVCC_FLAGS + [
            "-Xptxas", "-v", "-o", str(lib), str(d / _files(name)[0])]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (lib, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"variant {name} failed to build:\n{log}")
        regs, entry = {}, None
        for line in log.splitlines():
            m = re.search(r"entry function '\S*?(flash_\w+?|zero_adam)_kernel"
                          r"(?:I(f|13__nv_bfloat16)Li(\d+)E)?", line)
            p = re.search(r"entry function '\S*?(paged_decode_kernel\w*?I"
                          r"\w+?)EEv", line)
            if m:
                entry = m.group(1) if m.group(2) is None else \
                    f"{m.group(1)}_{'f32' if m.group(2) == 'f' else 'bf16'}" \
                    f"_hd{m.group(3)}"
            elif p:
                entry = p.group(1)
            m = re.search(r"Used (\d+) registers", line)
            if m and entry:
                regs[entry], entry = int(m.group(1)), None
        out[name] = (ctypes.CDLL(str(lib)), regs)
    return out


def _use(lib):
    _build.load = lambda _name: lib
    fa._lib = zk._lib = pk._lib = None


def graph_ms(fns, replays=20):
    """Device ms per call of the zero-argument launches `fns`, captured in
    order into one CUDA graph and replayed `replays` times after one
    warm-up replay (CUDA events): the kernels' time without the host's."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in fns:
            fn()
    graph.replay()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(replays):
        graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (replays * len(fns))


def paged_cycle(lib, q, k_pool, v_pool, page_table, pos, **kw):
    """One launch alone of the paged decode kernel per pool layer, on
    arguments prepared beforehand (uncounted), each reading the stream when
    it runs; and the buffers they write, which the caller keeps."""
    launches, keep = [], []
    for layer in range(k_pool.shape[0]):
        args, out, part = pk.launch_args(lib, q, k_pool, v_pool, page_table,
                                         pos, layer=layer, **kw)
        keep += [out, part]
        launches.append(lambda a=args: pk.call(
            lib, a, torch.cuda.current_stream().cuda_stream))
    return launches, keep


# positions of the kernel phase (max_len 1024) and of the bf16 serving run
# (max_len 256: prompts of 17-200 tokens after 31 decode steps)
PAGED_POS = {1024: (0, 15, 16, 200, 511, 777, 1000, 1023),
             256: (48, 74, 100, 126, 152, 178, 204, 231)}


def paged_case(kind, gen, max_len=1024):
    """The serving kernel phase's inputs for pools of `kind` (f32, bf16,
    int8), or the serving run's at max_len 256: (q, k_pool, v_pool,
    page_table, pos, kwargs)."""
    B, nh, hd, bs, L = 8, 12, 64, 16, 12
    mb = max_len // bs
    nb = 1 + B * mb
    pos = torch.tensor(PAGED_POS[max_len], dtype=torch.int32, device="cuda")
    pt = (torch.randperm(nb - 1, generator=gen, device="cuda")[:B * mb] + 1) \
        .to(torch.int32).reshape(B, mb).contiguous()
    shape = (L, nb, nh, bs, hd)
    kf = torch.randn(shape, generator=gen, device="cuda")
    vf = torch.randn(shape, generator=gen, device="cuda")
    q = torch.randn((B, nh, 1, hd), generator=gen, device="cuda")
    kw = dict(block_size=bs)
    if kind == "int8":
        from ..paged_ops import quantize_kv
        kp, vp = (quantize_kv(t * 2.0, 8.0) for t in (kf, vf))
        q = q.to(torch.bfloat16)
        kw["kv_scale"] = 8.0
    else:
        dt = torch.float32 if kind == "f32" else torch.bfloat16
        kp, vp, q = kf.to(dt), vf.to(dt), q.to(dt)
    return q, kp, vp, pt, pos, kw


def _ms(fn, iters=30, warmup=3):
    for _ in range(warmup):
        fn()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def _card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "--id=0"], capture_output=True, text=True,
        check=True).stdout.strip()


def flash_main(names, libs):
    b, nh, s, hd = SHAPE
    g = torch.Generator(device="cuda").manual_seed(0)
    base = [torch.randn(SHAPE, generator=g, device="cuda") for _ in range(4)]
    lens = np.random.RandomState(0).randint(s // 2, s + 1, size=(b, 1))
    keep = (np.arange(s)[None, :] < lens).astype(np.float32)
    mask = torch.from_numpy(keep * 1e9 - 1e9).view(b, 1, 1, s).cuda()
    m3, mode = fa.normalize_mask(mask, b, nh, s)
    m3, scale = m3.contiguous(), 1.0 / np.sqrt(hd)

    def args(dt, rate):
        q, k, v, do = (t.to(dt) for t in base)
        fa_ = (q, k, v, m3, mode, SEED, scale, False, rate)
        o, lse = fa.launch_fwd(*fa_)
        qa = (q, k, v, o, lse, do, m3, mode, SEED, scale, False, rate)
        delta = fa.launch_bwd_dq(*qa)[1]
        return fa_, qa, (q, k, v, delta, lse, do, m3, mode, SEED, scale,
                         False, rate)

    plain = {}
    for dt in (torch.float32, torch.bfloat16):
        q, k, v, do = (t.to(dt).requires_grad_() for t in base)
        o = fa.flash_attention_plain(q, k, v, scale=scale, dropout=0.1,
                                     seed=SEED, mask=mask)
        plain[dt] = (o.detach(),) + torch.autograd.grad(o, (q, k, v),
                                                        do.detach())
    times = {n: [] for n in names}
    errs = {}
    for name in names + names[::-1]:
        _use(libs[name][0])
        row = {}
        for dt in (torch.float32, torch.bfloat16):
            for rate in (0.1, 0.0):
                fa_, qa, ka = args(dt, rate)
                if rate:
                    got = (fa.launch_fwd(*fa_)[0], fa.launch_bwd_dq(*qa)[0]) \
                        + fa.launch_bwd_dkdv(*ka)
                    d = [(x.float() - y.float()).abs().max().item()
                         for x, y in zip(got, plain[dt])]
                    errs[name, dt] = (d[0], max(d[1:]))
                key = f"{'f32' if dt == torch.float32 else 'bf16'} {rate}"
                row[f"B1 {key}"] = _ms(lambda: fa.launch_fwd(*fa_))
                row[f"B2 {key}"] = _ms(lambda: fa.launch_bwd_dq(*qa))
                row[f"B3 {key}"] = _ms(lambda: fa.launch_bwd_dkdv(*ka))
        times[name].append(row)
    for name in names:
        avg = {k: float(np.mean([r[k] for r in times[name]]))
               for k in times[name][0]}
        keys = ("f32 0.1", "f32 0.0", "bf16 0.1", "bf16 0.0")
        print(f"variant {name}: B1 ms " + ", ".join(
            f"{k} {avg[f'B1 {k}']:.4f}" for k in keys) + "; B2+B3 ms "
            + ", ".join(f"{k} {avg[f'B2 {k}'] + avg[f'B3 {k}']:.4f}"
                        for k in keys) + "; " + ", ".join(
            f"{k} {v:.4f}" for k, v in avg.items() if not k.startswith("B1")),
            flush=True)
        (of, gf), (ob, gb) = errs[name, torch.float32], \
            errs[name, torch.bfloat16]
        print(f"  max |variant - plain| O f32 {of:.3e}, bf16 {ob:.3e}; "
              f"gradients f32 {gf:.3e}, bf16 {gb:.3e}; registers "
              f"{libs[name][1]}", flush=True)


def zero_main(names, libs):
    n = 23_440_896
    g = torch.Generator(device="cuda").manual_seed(0)
    base = {s: torch.randn(n, generator=g, device="cuda")
            for s in ("Param", "Grad", "Moment1", "Moment2")}
    base["Moment2"].abs_()
    scalars = {"LearningRate": 1e-3, "Beta1Pow": 0.9 ** 3,
               "Beta2Pow": 0.999 ** 3}
    attrs = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}

    def ins():
        out = {s: [t.clone()] for s, t in base.items()}
        out.update({s: [torch.tensor([v], device="cuda")]
                    for s, v in scalars.items()})
        return out

    want = zk.fused_flat_update_plain("adam", ins(), attrs)
    times = {nm: [] for nm in names}
    bitwise = {}
    for name in names + names[::-1]:
        _use(libs[name][0])
        got = zk.fused_flat_update("adam", ins(), attrs)
        bitwise[name] = all(torch.equal(got[s][0], want[s][0]) for s in got)
        kin = ins()
        times[name].append(_ms(lambda: zk.fused_flat_update("adam", kin,
                                                            attrs), iters=50))
    for name in names:
        ms = float(np.mean(times[name]))
        print(f"variant {name}: B8 adam n={n} {ms:.4f} ms "
              f"({28 * n / ms / 1e6:.1f} GB/s); bit for bit "
              f"{bitwise[name]}; registers {libs[name][1]}", flush=True)


def paged_main(names, libs):
    g = torch.Generator(device="cuda").manual_seed(0)
    for kind, max_len in (("f32", 1024), ("bf16", 1024), ("int8", 1024),
                          ("bf16", 256)):
        q, kp, vp, pt, pos, kw = paged_case(kind, g, max_len)
        want = pk.paged_attention_plain(q, kp, vp, pt, pos, layer=5, **kw)
        times = {n: [] for n in names}
        errs = {}
        for name in names + names[::-1]:
            _use(libs[name][0])
            lib = pk._library()
            args, out, _part = pk.launch_args(lib, q, kp, vp, pt, pos,
                                              layer=5, **kw)
            pk.call(lib, args, torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()
            errs[name] = (out.float() - want.float()).abs().max().item()
            cycle, _keep = paged_cycle(lib, q, kp, vp, pt, pos, **kw)
            times[name].append(graph_ms(cycle))
        for name in names:
            print(f"variant {name}: paged {kind} max_len {max_len} "
                  f"{np.mean(times[name]):.5f} "
                  f"ms alone (12-layer cycle in a CUDA graph); max |variant"
                  f" - plain| {errs[name]:.3e}; registers {libs[name][1]}",
                  flush=True)
        del q, kp, vp, want
        torch.cuda.empty_cache()


def main(names):
    if not torch.cuda.is_available():
        raise SystemExit("flash_variants: no CUDA card")
    unknown = [n for n in names if n not in ALL_VARIANTS]
    if unknown:
        raise SystemExit(f"flash_variants: unknown variants {unknown}")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(_card(), flush=True)
    libs = build(names)
    load = _build.load
    try:
        flash = [n for n in names if n in VARIANTS]
        zero = [n for n in names if n in ZERO_VARIANTS]
        paged = [n for n in names if n in PAGED_VARIANTS]
        if flash:
            flash_main(flash, libs)
        if zero:
            zero_main(zero, libs)
        if paged:
            paged_main(paged, libs)
    finally:
        _build.load = load
        fa._lib = zk._lib = pk._lib = None


if __name__ == "__main__":
    main(sys.argv[1:] or list(ALL_VARIANTS))
